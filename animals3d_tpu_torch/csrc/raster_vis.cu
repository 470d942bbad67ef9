// Tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_raster_kernel`
// (animals3d_tpu/ops/rasterize_pallas.py:153, launched by
// `_pallas_visibility` at :426). It computes what that kernel computes —
// per pixel, the nearest covering face (z, original id + 1, 0 =
// background) over the tile's bbox-overlapping face chunks walked front to
// back, with exact-z ties going to the smallest original id, the
// conservative z-min occlusion skip, and per-(image, tile, chunk) "took a
// pixel" flags — and none of its TPU machinery (no SMEM list cap with
// full-scan fallback, no DMA rings, no packed id/mask words).
//
// Design: one thread block per (16x32 tile, image), one thread per pixel.
// The block walks its own chunk list (chunk ids sorted by quantized z-min)
// from global memory. Before each chunk a block-wide max of the pixels'
// current z decides the occlusion skip, with the Pallas kernel's strict
// test on floor-quantized z, so the skip cannot change a winner. For each
// 128-face sub-block whose bbox overlaps the tile (bit mask from the
// prep), the block stages its 12 coefficient rows and original ids in
// shared memory and every thread runs over the faces, keeping its
// running (z, id). `__syncthreads_or` sets the chunk's flag. No atomics:
// the result is deterministic.
//
// Numerics: every affine function is evaluated as (a*px + b*py) + c with
// explicit round-to-nearest multiplies and adds and no fused multiply-add
// (the file is also built with -fmad=false): the operation order of the
// plain PyTorch version, so the two agree bit for bit.
//
// Bound on the H100: the function needs the live (face, pixel) pairs —
// pixels inside the bbox of a face of a (tile, chunk) pair that the
// occlusion skip keeps — at 12 f32 operations each (3 edge functions) at
// the CUDA-core rate, against reading the coefficients (52 bytes per
// face) of the live (tile, chunk) pairs once. This design does more: it
// tests every face of a live 128-face sub-block against all 512 pixels of
// the tile, so on a mesh of sub-pixel faces most of its edge tests fall
// outside the face's bbox and it runs far above that bound. What it does
// about it: the prep's Morton face order keeps a sub-block compact on
// screen, the per-sub-block bbox masks skip sub-blocks that miss the tile,
// and a sub-block is read once from global memory per block and then
// served from shared memory to 512 threads. A per-face bbox cull inside a
// sub-block is the next lever.

#include <cuda_runtime.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)
#define NWARP (TP / 32)
#define BIG 3.0e38f

__device__ __forceinline__ int zq(float z) {
  z = fminf(fmaxf(z, -8.0f), 8.0f);
  return (int)floorf(z * 1048576.0f);
}

__device__ __forceinline__ float affine(float a, float b, float c, float px,
                                        float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// table: (B, nch, 12, chunk) rows a0 a1 a2 az b0 b1 b2 bz c0 c1 c2 cz
// orig: (nch*chunk) original face id of each sorted slot
// order, masks: (B, T, nch); counts: (B, T); zlo: (B, nch)
// z_out, id_out: (B, H, W); flags: (B, T, nch), zero-filled by the caller
__global__ void __launch_bounds__(TP)
raster_vis_kernel(const float* __restrict__ table,
                  const int* __restrict__ orig,
                  const int* __restrict__ order,
                  const int* __restrict__ counts,
                  const int* __restrict__ masks,
                  const int* __restrict__ zlo,
                  float* __restrict__ z_out, int* __restrict__ id_out,
                  unsigned char* __restrict__ flags, int T, int ntx, int nch,
                  int chunk, int nsub, int H, int W) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_red[NWARP];
  const int sub = chunk / nsub;
  float* s_coef = smem;                          // [sub][12]
  int* s_id = reinterpret_cast<int*>(smem + 12 * sub);   // [sub]

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int py_i = (t / ntx) * TILE_H + tid / TILE_W;
  const int px_i = (t % ntx) * TILE_W + tid % TILE_W;
  const float px = (float)px_i + 0.5f, py = (float)py_i + 0.5f;
  const size_t bt = (size_t)b * T + t;
  const int n = counts[bt];

  float zbest = BIG;
  int idbest = 0;
  for (int k = 0; k < n; ++k) {
    const int cid = order[bt * nch + k];
    const int mbits = masks[bt * nch + cid];
    // block-wide max of the current z: the occlusion skip
    float v = zbest;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((tid & 31) == 0) s_red[tid >> 5] = v;
    __syncthreads();
    float zmax = s_red[0];
    for (int i = 1; i < NWARP; ++i) zmax = fmaxf(zmax, s_red[i]);
    const bool live = zlo[(size_t)b * nch + cid] <= zq(zmax);

    int took = 0;
    if (live) {
      for (int g = 0; g < nsub; ++g) {
        if (!((mbits >> g) & 1)) continue;
        __syncthreads();               // earlier readers of s_coef are done
        // staged face-major, 12 floats per face, so each thread reads a
        // face's coefficients as three 16-byte broadcasts
        const float* src =
            table + ((size_t)b * nch + cid) * 12 * chunk + (size_t)g * sub;
        for (int i = tid; i < 12 * sub; i += TP)
          s_coef[(i % sub) * 12 + i / sub] =
              src[(size_t)(i / sub) * chunk + i % sub];
        for (int i = tid; i < sub; i += TP)
          s_id[i] = orig[(size_t)cid * chunk + g * sub + i];
        __syncthreads();
        const float4* s_f4 = reinterpret_cast<const float4*>(s_coef);
        for (int j = 0; j < sub; ++j) {
          const float4 ca = s_f4[3 * j], cb = s_f4[3 * j + 1],
                       cc = s_f4[3 * j + 2];
          const float e0 = affine(ca.x, cb.x, cc.x, px, py);
          const float e1 = affine(ca.y, cb.y, cc.y, px, py);
          const float e2 = affine(ca.z, cb.z, cc.z, px, py);
          if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
            const float zz = affine(ca.w, cb.w, cc.w, px, py);
            const int gi = s_id[j] + 1;
            if (zz < zbest ||
                (zz == zbest && zbest < BIG && gi < idbest)) {
              zbest = zz;
              idbest = gi;
              took = 1;
            }
          }
        }
      }
    }
    // also the barrier that lets the next iteration rewrite s_red
    const int any = __syncthreads_or(took);
    if (tid == 0) flags[bt * nch + cid] = (unsigned char)(any != 0);
  }
  const size_t o = (size_t)b * H * W + (size_t)py_i * W + px_i;
  z_out[o] = idbest > 0 ? zbest : 0.0f;
  id_out[o] = idbest;
}

extern "C" int raster_vis_launch(const float* table, const int* orig,
                                 const int* order, const int* counts,
                                 const int* masks, const int* zlo,
                                 float* z_out, int* id_out,
                                 unsigned char* flags, int B, int T, int ntx,
                                 int nch, int chunk, int nsub, int H, int W,
                                 void* stream) {
  const int sub = chunk / nsub;
  const size_t smem = (size_t)13 * sub * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        raster_vis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  raster_vis_kernel<<<dim3(T, B), TP, smem, (cudaStream_t)stream>>>(
      table, orig, order, counts, masks, zlo, z_out, id_out, flags, T, ntx,
      nch, chunk, nsub, H, W);
  return (int)cudaGetLastError();
}
