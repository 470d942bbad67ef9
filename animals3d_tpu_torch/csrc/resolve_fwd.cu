// Resolve rows forward for Hopper (sm_90a): the per-pixel row gather
// rows[b, c, q] = pf[b, face_id[b, pixel(q)] - 1, c], written channel-major
// in tile order (q runs over 16x32 tiles, rows within a tile), zero on
// background pixels (face_id == 0, or beyond the F faces).
//
// Replaces the Pallas TPU kernel `_resolve_fwd_kernel`
// (animals3d_tpu/ops/rasterize_pallas.py:1269, launched by
// `resolve_rows_pallas` at :1398). On the TPU the gather is a one-hot
// matrix product over the rasterizer's winner-chunk lists, because the TPU
// gathers rows slowly; a GPU reads a row by address, so a pixel's winner id
// addresses its row directly and the kernel needs neither the lists nor
// the winner flags.
//
// Bound on the H100: bytes — face_id read once, the row of each winning
// (image, face) read once, the output written once. At full width (10
// images at 256², R = 42) the 110 MB output is 86% of them.
//
// Design: the row reads are what a thread per output element does badly:
// each of its loads is one float of a 168-byte row, a row's channels are
// fetched by as many warps far apart in time, and the rows (330 MB at full
// width) do not stay in L2. Here a warp takes a tile row of 32 pixels, a
// block ROWS of them (a half tile), and the warps never wait for each
// other:
//   * each lane reads its pixel's face id (a warp: one 128-byte row of
//     face_id, coalesced); a pixel whose id differs from its left
//     neighbour's (by shuffle) starts a run, and the warp's foreground
//     runs are numbered in order (a ballot and a population count);
//   * the warp copies each run's row whole into its staging area in
//     shared memory (a run a row of `pitch` floats), its lanes striding
//     over the (run, channel vector) pairs, consecutive lanes on
//     consecutive addresses of a row: 8-byte copies where the rows are
//     8-byte aligned (R even: 168-byte rows are), 4-byte ones for a ragged
//     R. The copies are `cp.async`, from device memory to shared memory
//     without registers, so all of a warp's rows are in flight at once; a
//     row is read once per run;
//   * then each lane writes its pixel's channels from its run's staged row
//     (zero at background), so that a warp stores 128 contiguous bytes of
//     each channel's tile-order segment: the transpose from rows to
//     channel-major happens between shared memory and the stores. The
//     pitch is R, or the next value that makes the lanes' reads of 32
//     different rows fall on distinct banks (odd for 4-byte copies, twice
//     an odd number for 8-byte ones). Channels come in slices of CS_MAX so
//     that the staging stays small enough for several blocks on an SM (at
//     R = 42 and 8 rows a block: one slice, 44 KB).
// The result is a copy: it equals the plain version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)
#define CS_MAX 48        // channels a slice of the staging (even)
#define ROWS 8           // tile rows a block, a warp each: a half tile

// The staged rows' pitch (floats) for a slice of cs channels copied V at a
// time: the lanes of a warp read 32 rows at once in the output pass.
static __host__ __device__ __forceinline__ int stage_pitch(int cs, int V) {
  if (V == 1) return cs | 1;
  return cs % 4 == 2 ? cs : cs + 2;
}

// Dynamic shared memory of a block: a warp's 32 staged rows and its runs'
// faces.
static size_t smem_bytes(int R, int V) {
  const int cs = R < CS_MAX ? R : CS_MAX;
  return (size_t)ROWS * 32 * (stage_pitch(cs, V) + 1) * 4;
}

// V * 4 bytes from device memory to shared memory, asynchronously
template <int V>
static __device__ __forceinline__ void copy_async(float* dst,
                                                  const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (V == 2)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
}

// pf (B, F, R) float; face_id (B, H*W) int32 raster order, 1-based;
// out (B, R, H*W) float in tile order. Block: ROWS warps; grid: B * T *
// (TILE_H / ROWS) blocks.
template <int V>
__global__ void __launch_bounds__(ROWS * 32)
resolve_fwd_kernel(const float* __restrict__ pf,
                   const int* __restrict__ face_id, float* __restrict__ out,
                   int F, int R, int H, int W) {
  extern __shared__ __align__(16) float s_stage[];
  const int csa = R < CS_MAX ? R : CS_MAX;
  const int pitch = stage_pitch(csa, V);
  const int ntx = W / TILE_W, T = (H / TILE_H) * ntx;
  const int parts = TILE_H / ROWS;
  const int part = blockIdx.x % parts;
  const int t = (blockIdx.x / parts) % T;
  const int b = blockIdx.x / (parts * T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t HW = (size_t)H * W;
  float* w_stage = s_stage + (size_t)warp * 32 * pitch;
  int* w_face = reinterpret_cast<int*>(s_stage + (size_t)ROWS * 32 * pitch)
                + warp * 32;

  // this lane's pixel, its face, and its run's number among the warp's
  // foreground runs
  const int y = (t / ntx) * TILE_H + part * ROWS + warp;
  const int x = (t % ntx) * TILE_W + lane;
  const int fid = face_id[b * HW + (size_t)y * W + x];
  const bool fg = fid > 0 && fid <= F;
  const int key = fg ? fid : 0;
  const int left = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = fg && (lane == 0 || left != key);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const int run = max(__popc(heads & ((2u << lane) - 1u)) - 1, 0);
  if (head) w_face[run] = fid - 1;
  __syncwarp();
  const int nh = __popc(heads);
  const float* pfb = pf + (size_t)b * F * R;
  float* outp = out + (size_t)b * R * HW + (size_t)t * TP
                + (size_t)part * ROWS * 32 + tid;
  const float* mine = w_stage + run * pitch;

  for (int c0 = 0; c0 < R; c0 += CS_MAX) {
    const int cs = R - c0 < CS_MAX ? R - c0 : CS_MAX;
    const int nv = cs / V;                // V == 2 only where cs is even
    for (int e = lane; e < nh * nv; e += 32) {
      const int j = e / nv, v = e - j * nv;
      copy_async<V>(w_stage + j * pitch + v * V,
                    pfb + (size_t)w_face[j] * R + c0 + v * V);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();                         // every lane's copies landed
#pragma unroll 6
    for (int c = 0; c < cs; ++c)
      outp[(size_t)(c0 + c) * HW] = fg ? mine[c] : 0.0f;
    __syncwarp();                         // the next slice reuses it
  }
}

extern "C" int resolve_fwd_launch(const float* pf, const int* face_id,
                                  float* out, int B, int F, int R, int H,
                                  int W, void* stream) {
  const long blocks =
      (long)B * (H / TILE_H) * (W / TILE_W) * (TILE_H / ROWS);
  if (blocks <= 0 || R <= 0) return 0;
  const bool pairs = R % 2 == 0 && (uintptr_t)pf % 8 == 0;
  const size_t smem = smem_bytes(R, pairs ? 2 : 1);
  cudaError_t e;
  if (pairs) {
    e = cudaFuncSetAttribute(resolve_fwd_kernel<2>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    resolve_fwd_kernel<2><<<(unsigned)blocks, ROWS * 32, smem,
                            (cudaStream_t)stream>>>(pf, face_id, out, F, R,
                                                    H, W);
  } else {
    e = cudaFuncSetAttribute(resolve_fwd_kernel<1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    resolve_fwd_kernel<1><<<(unsigned)blocks, ROWS * 32, smem,
                            (cudaStream_t)stream>>>(pf, face_id, out, F, R,
                                                    H, W);
  }
  return (int)cudaGetLastError();
}
