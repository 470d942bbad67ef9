// Tile visibility rasterizer over dense per-tile unit lists, for Hopper
// (sm_90a): variant 6.
//
// Replaces the Pallas TPU kernel `_raster_kernel_v6`
// (animals3d_tpu/ops/rasterize_pallas.py:513, launched by
// `_pallas_visibility_v6` at :637 under A3D_RASTER_V=6). A "unit" is one
// 128-face sub-block of a chunk. Per (image, tile) the prep lists the units
// whose screen bbox overlaps the tile in ascending quantized z-min (ties by
// unit id), at most S of them. The kernel computes K1's function (nearest
// covering face, exact-z ties to the smallest original id) with the
// occlusion skip per unit instead of per chunk, and a flag per list
// slot: whether any pixel took a face from that unit. A tile with more
// than S units scans every sub-block of every chunk, with no skip and no
// flags (the prep gives such a tile its overlap row). The TPU kernel's
// gathered coefficient slabs (a DMA convenience, 1 GB per render at full
// width) have no counterpart: a block reads its unit's columns of the
// chunk-major coefficient table by index.
//
// Design: one thread block per (16x32 tile, image), one thread per pixel,
// as K1 (csrc/raster_vis.cu): before each unit a block-wide max of the
// pixels' current z decides the skip (strict test on floor-quantized z, so
// it cannot change a winner); a live unit's 12 coefficient rows and ids are
// staged in shared memory and every thread runs over its 128 faces keeping
// its running (z, id); `__syncthreads_or` gives the slot's flag. No
// atomics: the result is deterministic.
//
// Numerics: (a*px + b*py) + c with round-to-nearest multiplies and adds and
// no fused multiply-add, as K1 and the plain version. The skip's bound is
// the least vertex depth of the unit's faces; where the plane equation's
// rounding puts a face's depth at a pixel below it, the skip is not
// conservative, and K1 (skipping per chunk) and this kernel may keep
// different winners there, as the two Pallas kernels may.
//
// Bound on the H100: K1's (the same function, inputs and outputs). This
// design tests every face of a live unit against all 512 pixels of the
// tile, as K1 does per live sub-block; the finer skip only removes units.

#include <cuda_runtime.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)
#define NWARP (TP / 32)
#define BIG 3.0e38f

static __device__ __forceinline__ int zq(float z) {
  z = fminf(fmaxf(z, -8.0f), 8.0f);
  return (int)floorf(z * 1048576.0f);
}

static __device__ __forceinline__ float affine(float a, float b, float c,
                                               float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// block-wide max of z; the caller's next barrier protects s_red
static __device__ __forceinline__ float block_max(float v, float* s_red,
                                                  int tid) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((tid & 31) == 0) s_red[tid >> 5] = v;
  __syncthreads();
  float m = s_red[0];
  for (int i = 1; i < NWARP; ++i) m = fmaxf(m, s_red[i]);
  return m;
}

// stage sub-block g of chunk cid (12 coefficient rows, face-major, and the
// original ids), then run this thread's pixel over its faces; returns
// whether the pixel took a face. Every thread of the block calls it.
static __device__ __forceinline__ int visit(
    const float* __restrict__ table, const int* __restrict__ orig,
    float* s_coef, int* s_id, int b, int nch, int chunk, int sub, int cid,
    int g, int tid, float px, float py, float& zbest, int& idbest) {
  __syncthreads();                   // earlier readers of s_coef are done
  const float* src =
      table + ((size_t)b * nch + cid) * 12 * chunk + (size_t)g * sub;
  for (int i = tid; i < 12 * sub; i += TP)
    s_coef[(i % sub) * 12 + i / sub] = src[(size_t)(i / sub) * chunk + i % sub];
  for (int i = tid; i < sub; i += TP)
    s_id[i] = orig[(size_t)cid * chunk + g * sub + i];
  __syncthreads();
  int took = 0;
  const float4* s_f4 = reinterpret_cast<const float4*>(s_coef);
  for (int j = 0; j < sub; ++j) {
    const float4 ca = s_f4[3 * j], cb = s_f4[3 * j + 1], cc = s_f4[3 * j + 2];
    const float e0 = affine(ca.x, cb.x, cc.x, px, py);
    const float e1 = affine(ca.y, cb.y, cc.y, px, py);
    const float e2 = affine(ca.z, cb.z, cc.z, px, py);
    if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
      const float zz = affine(ca.w, cb.w, cc.w, px, py);
      const int gi = s_id[j] + 1;
      if (zz < zbest || (zz == zbest && zbest < BIG && gi < idbest)) {
        zbest = zz;
        idbest = gi;
        took = 1;
      }
    }
  }
  return took;
}

// table: (B, nch, 12, chunk); orig: (nch*chunk); units: (B, T, S) unit ids
// (chunk * nsub + sub-block); counts6: (B, T); zu: (B, nch*nsub)
// z_out, id_out: (B, H, W); sflags: (B, T, S), zero-filled by the caller
__global__ void __launch_bounds__(TP)
raster_vis_v6_kernel(const float* __restrict__ table,
                     const int* __restrict__ orig,
                     const int* __restrict__ units,
                     const int* __restrict__ counts6,
                     const int* __restrict__ zu, float* __restrict__ z_out,
                     int* __restrict__ id_out,
                     unsigned char* __restrict__ sflags, int T, int ntx,
                     int nch, int chunk, int nsub, int S, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[NWARP];
  const int sub = chunk / nsub;
  float* s_coef = smem;                                  // [sub][12]
  int* s_id = reinterpret_cast<int*>(smem + 12 * sub);   // [sub]

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int py_i = (t / ntx) * TILE_H + tid / TILE_W;
  const int px_i = (t % ntx) * TILE_W + tid % TILE_W;
  const float px = (float)px_i + 0.5f, py = (float)py_i + 0.5f;
  const size_t bt = (size_t)b * T + t;
  const int n = counts6[bt];
  const int U = nch * nsub;

  float zbest = BIG;
  int idbest = 0;
  if (n <= S) {
    for (int k = 0; k < n; ++k) {
      const int unit = units[bt * S + k];
      const float zmax = block_max(zbest, s_red, tid);
      const bool live = zu[(size_t)b * U + unit] <= zq(zmax);
      int took = 0;
      if (live)
        took = visit(table, orig, s_coef, s_id, b, nch, chunk, sub,
                     unit / nsub, unit % nsub, tid, px, py, zbest, idbest);
      // also the barrier that lets the next unit rewrite s_red
      const int any = __syncthreads_or(took);
      if (tid == 0) sflags[bt * S + k] = (unsigned char)(any != 0);
    }
  } else {
    // more units than list slots: every sub-block, no skip, no flags
    for (int cid = 0; cid < nch; ++cid)
      for (int g = 0; g < nsub; ++g)
        visit(table, orig, s_coef, s_id, b, nch, chunk, sub, cid, g, tid, px,
              py, zbest, idbest);
  }
  const size_t o = (size_t)b * H * W + (size_t)py_i * W + px_i;
  z_out[o] = idbest > 0 ? zbest : 0.0f;
  id_out[o] = idbest;
}

extern "C" int raster_vis_v6_launch(const float* table, const int* orig,
                                    const int* units, const int* counts6,
                                    const int* zu, float* z_out, int* id_out,
                                    unsigned char* sflags, int B, int T,
                                    int ntx, int nch, int chunk, int nsub,
                                    int S, int H, int W, void* stream) {
  const int sub = chunk / nsub;
  const size_t smem = (size_t)13 * sub * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_vis_v6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raster_vis_v6_kernel<<<dim3(T, B), TP, smem, (cudaStream_t)stream>>>(
      table, orig, units, counts6, zu, z_out, id_out, sflags, T, ntx, nch,
      chunk, nsub, S, H, W);
  return (int)cudaGetLastError();
}
