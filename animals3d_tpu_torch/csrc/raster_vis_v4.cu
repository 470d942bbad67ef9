// Face-parallel tile visibility rasterizer for Hopper (sm_90a): variant 4.
//
// Replaces the Pallas TPU kernel `_raster_kernel_v4`
// (animals3d_tpu/ops/rasterize_pallas.py:286, launched by
// `_pallas_visibility` at :463 under A3D_RASTER_V=4). That kernel computes
// K1's function (`_raster_kernel`, csrc/raster_vis.cu) with the faces on the
// TPU's parallel axis; its winners are bit-identical to K1's. So is this
// kernel's output, flags included: per pixel the nearest covering face
// (z, original id + 1, 0 = background) over the tile's bbox-overlapping face
// chunks walked front to back, exact-z ties to the smallest original id, the
// conservative z-min occlusion skip per chunk, and per-(image, tile, chunk)
// "took a pixel" flags.
//
// Design: one thread block per (16x32 tile, image), one thread per face.
// The block walks K1's chunk list with K1's occlusion skip (a block-wide
// max of the pixels' current z at each chunk start). Inside a chunk each
// thread takes the faces of the live sub-blocks (bit mask from the prep)
// and tests only the pixels of its face's cull box (`fbox`, computed by the
// prep from the face's own coefficients: a bound of every pixel centre the
// float32 edge tests below can accept, so the cull changes no winner). A
// pixel's running winner is one 64-bit key in shared memory: an
// order-preserving map of z (with -0.0 read as +0.0, as float compares
// read it) in the high 32 bits, then the original id + 1, then a bit that
// remembers a -0.0 depth. `atomicMin` on the key keeps the lexicographic
// minimum of (z, id), K1's rule, whatever the order of the atomics, so the
// result is deterministic. A face takes a pixel only at z < BIG, as in K1.
// A chunk's flag is set when any key fell during the chunk: keys only
// fall, so this is K1's "took".
//
// Numerics: every affine function is evaluated as (a*px + b*py) + c with
// round-to-nearest multiplies and adds and no fused multiply-add (the
// library is built with -fmad=false), the operation order of K1 and of the
// plain version.
//
// Bound on the H100: K1's — the same function, inputs and outputs (the
// live face-pixel pairs at 12 float32 operations each against the live
// sub-blocks' coefficients read once). The cull box brings this design's
// work close to it: a thread visits the pixels of its face's box instead
// of all 512 pixels of the tile, and a face whose box misses the tile
// costs one 8-byte load. What is left above the bound: every face of a
// live sub-block loads its box, and the occlusion skip is per chunk.

#include <cuda_runtime.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)
#define NT 128
#define NWARP (NT / 32)
#define BIG 3.0e38f

static __device__ __forceinline__ int zq(float z) {
  z = fminf(fmaxf(z, -8.0f), 8.0f);
  return (int)floorf(z * 1048576.0f);
}

static __device__ __forceinline__ float affine(float a, float b, float c,
                                               float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// order-preserving float -> unsigned map; -0.0 maps as +0.0
static __device__ __forceinline__ unsigned zkey(float z) {
  const unsigned u = __float_as_uint(z == 0.0f ? 0.0f : z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float zval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// table: (B, nch, 12, chunk) rows a0 a1 a2 az b0 b1 b2 bz c0 c1 c2 cz
// orig: (nch*chunk); order, masks: (B, T, nch); counts: (B, T); zlo: (B, nch)
// fbox: (B, nch*chunk) pixel ranges x0 x1 y0 y1 per sorted slot
// z_out, id_out: (B, H, W); flags: (B, T, nch), zero-filled by the caller
__global__ void __launch_bounds__(NT)
raster_vis_v4_kernel(const float* __restrict__ table,
                     const int* __restrict__ orig,
                     const int* __restrict__ order,
                     const int* __restrict__ counts,
                     const int* __restrict__ masks,
                     const int* __restrict__ zlo,
                     const short4* __restrict__ fbox,
                     float* __restrict__ z_out, int* __restrict__ id_out,
                     unsigned char* __restrict__ flags, int T, int ntx,
                     int nch, int chunk, int nsub, int H, int W) {
  __shared__ unsigned long long s_key[TP];
  __shared__ float s_red[NWARP];
  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx0 = (t % ntx) * TILE_W, ty0 = (t / ntx) * TILE_H;
  const size_t bt = (size_t)b * T + t;
  const int n = counts[bt];
  const int sub = chunk / nsub;
  const unsigned long long empty = (unsigned long long)zkey(BIG) << 32;
  for (int i = tid; i < TP; i += NT) s_key[i] = empty;
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const int cid = order[bt * nch + k];
    const int mbits = masks[bt * nch + cid];
    // block-wide max of the current z: the occlusion skip
    float v = zval((unsigned)(s_key[tid] >> 32));
    for (int i = tid + NT; i < TP; i += NT)
      v = fmaxf(v, zval((unsigned)(s_key[i] >> 32)));
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((tid & 31) == 0) s_red[tid >> 5] = v;
    __syncthreads();
    float zmax = s_red[0];
    for (int i = 1; i < NWARP; ++i) zmax = fmaxf(zmax, s_red[i]);
    const bool live = zlo[(size_t)b * nch + cid] <= zq(zmax);

    int took = 0;
    if (live) {
      const float* src = table + ((size_t)b * nch + cid) * 12 * chunk;
      const size_t slot0 = ((size_t)b * nch + cid) * chunk;
      for (int f = tid; f < chunk; f += NT) {
        if (!((mbits >> (f / sub)) & 1)) continue;
        const short4 bx = fbox[slot0 + f];
        const int xa = max((int)bx.x, tx0);
        const int xb = min((int)bx.y, tx0 + TILE_W - 1);
        const int ya = max((int)bx.z, ty0);
        const int yb = min((int)bx.w, ty0 + TILE_H - 1);
        if (xa > xb || ya > yb) continue;
        float c[12];
#pragma unroll
        for (int r = 0; r < 12; ++r) c[r] = src[(size_t)r * chunk + f];
        const unsigned gi = (unsigned)orig[(size_t)cid * chunk + f] + 1u;
        for (int y = ya; y <= yb; ++y) {
          const float py = (float)y + 0.5f;
          for (int x = xa; x <= xb; ++x) {
            const float px = (float)x + 0.5f;
            const float e0 = affine(c[0], c[4], c[8], px, py);
            const float e1 = affine(c[1], c[5], c[9], px, py);
            const float e2 = affine(c[2], c[6], c[10], px, py);
            if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
            const float zz = affine(c[3], c[7], c[11], px, py);
            if (!(zz < BIG)) continue;        // K1 takes only z < BIG
            const unsigned negz =
                (zz == 0.0f && (__float_as_uint(zz) >> 31)) ? 1u : 0u;
            const unsigned long long key =
                ((unsigned long long)zkey(zz) << 32) | (gi << 1) | negz;
            const unsigned long long old = atomicMin(
                &s_key[(y - ty0) * TILE_W + (x - tx0)], key);
            if (key < old) took = 1;
          }
        }
      }
    }
    // also the barrier after which the keys are final for this chunk
    const int any = __syncthreads_or(took);
    if (tid == 0) flags[bt * nch + cid] = (unsigned char)(any != 0);
  }
  for (int i = tid; i < TP; i += NT) {
    const unsigned long long key = s_key[i];
    const unsigned lo = (unsigned)key;
    const int id = (int)(lo >> 1);
    const float z = (lo & 1u) ? -0.0f : zval((unsigned)(key >> 32));
    const size_t o = (size_t)b * H * W + (size_t)(ty0 + i / TILE_W) * W
                     + tx0 + i % TILE_W;
    z_out[o] = id > 0 ? z : 0.0f;
    id_out[o] = id;
  }
}

extern "C" int raster_vis_v4_launch(const float* table, const int* orig,
                                    const int* order, const int* counts,
                                    const int* masks, const int* zlo,
                                    const void* fbox, float* z_out,
                                    int* id_out, unsigned char* flags, int B,
                                    int T, int ntx, int nch, int chunk,
                                    int nsub, int H, int W, void* stream) {
  raster_vis_v4_kernel<<<dim3(T, B), NT, 0, (cudaStream_t)stream>>>(
      table, orig, order, counts, masks, zlo, (const short4*)fbox, z_out,
      id_out, flags, T, ntx, nch, chunk, nsub, H, W);
  return (int)cudaGetLastError();
}
