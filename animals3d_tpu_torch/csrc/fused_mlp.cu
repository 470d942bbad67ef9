// Fused CoordMLP lattice sweep for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`
// (animals3d_tpu/ops/fused_mlp.py:59) and `_bwd_kernel` (:76). They
// evaluate the netSDF trunk at every lattice vertex (2.1M rows at grid
// 128): in-layer + bias, relu, L-1 bias-free 256x256 layers with a relu
// between them, and a final 256 -> 1 layer. The point of the kernel is
// that no (N, 256) activation ever reaches device memory: a tile of rows
// stays in shared memory across all layers, forward and backward.
//
// Numerics are the Pallas kernels': operands in the compute type T (bf16,
// or float for the float32 policy), float32 accumulation, every layer's
// output rounded to T; the bias is rounded to T and added in T; relu masks
// compare the rounded activation with 0; the backward rounds the masked
// d(activation) to T and accumulates every weight gradient in float32.
//
// Design. One block of 256 threads (8 warps) takes a tile of ROWS rows (64
// for bf16, 32 for float) and loops over tiles blockIdx.x, blockIdx.x +
// gridDim.x, ... Weights (0.6 MB in bf16) are read from global memory and
// stay in L2. The bf16 products run on the tensor cores through
// nvcuda::wmma (16x16x16, float32 accumulators); warp w owns output
// columns [32w, 32w + 32). The float products are plain FMA loops on the
// CUDA cores, thread t owning output column t.
//
// Forward: two activation buffers ping-pong; the last layer is a dot
// product per row (no 128-lane padding). Only the (N,) output is written.
//
// Backward: the block recomputes the L activations of its tile into L
// shared-memory buffers, then walks back. The cotangent of layer li's
// output overwrites the buffer of a_{li+1} in place (that activation is
// dead once its dW and its relu mask are taken), so no extra buffer is
// needed. Each dW is a^T d, a sum over the rows: both operands are stored
// row-major by row, so one of them has to be read transposed, and a
// column-major wmma load of 16-bit values from padded rows runs into
// shared-memory bank conflicts (a first version spent 4/5 of its time
// there). So the cotangent is also written transposed (dT, 256 x ROWS)
// as it is produced, and the block computes dW^T = dT a with both
// fragments loaded row-major. The TPU accumulates the weight gradients
// across its sequential grid in VMEM; all of them (1.1 MB of float32) do
// not fit one SM, so here every block owns a private float32 partial of
// every gradient in a global scratch (nblocks x PSZ, zeroed by the
// caller) and adds its tile's products into it (load four accumulator
// tiles, mma over the tile's rows, store). A second kernel sums the
// partials over the blocks in block order. The grid size is fixed by the
// caller, so the result is the same from run to run. Rows beyond N carry
// a zero cotangent and a zero input. (A variant that kept the partials on
// chip, spread over the shared memory of a cluster of 8 blocks and read
// through distributed shared memory, was slower: 16-row tiles re-read the
// weights four times as often and the remote fragment loads serialized.)
//
// Bound on the H100: 2 N (DP 256 + (L-1) 256^2 + 256) operations forward
// and three times that backward, against N (2 DP + 4) bytes: bound by
// operations. This first version is well above the bound: wmma without
// software pipelining, weights re-read from L2 for every tile, and in the
// backward a read-modify-write of the block's 1.1 MB partial per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

#define NF 256
#define NTHREADS 256
#define NWARPS 8
#define PAD 8            // elements of padding per shared-memory row
#define LDA (NF + PAD)
#define STAGE_LD 20
#define STAGE_SZ (16 * STAGE_LD)

__device__ __forceinline__ float tof(float x) { return x; }
__device__ __forceinline__ float tof(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T fromf(float x);
template <> __device__ __forceinline__ float fromf<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
fromf<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// round to the compute type and back
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return tof(fromf<T>(x));
}

// C[r][c] = sum_k A[r][k] B[k][c] for r < ROWS, c < 256; A in shared
// memory (row-major, lda), B in global memory (row-major, ld 256).
// ep(r, c, value) is called once per element by the thread that owns it.
template <int ROWS, class Ep>
__device__ __forceinline__ void gemm_rows(const float* A, int lda, int K,
                                          const float* B, float* /*stage*/,
                                          Ep ep) {
  const int t = threadIdx.x;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float w = B[(size_t)k * NF + t];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(A[r * lda + k], w, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) ep(r, t, acc[r]);
}

template <int ROWS, class Ep>
__device__ __forceinline__ void gemm_rows(const __nv_bfloat16* A, int lda,
                                          int K, const __nv_bfloat16* B,
                                          float* stage, Ep ep) {
  constexpr int RT = ROWS / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col0 = warp * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][2];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fb[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::load_matrix_sync(fb[j], B + (size_t)k * NF + col0 + 16 * j, NF);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, A + (size_t)(16 * i) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa, fb[j],
                                                 acc[i][j]);
    }
  }
  float* st = stage + warp * STAGE_SZ;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], STAGE_LD, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int idx = lane + 32 * q;
        const int r = idx >> 4, c = idx & 15;
        ep(16 * i + r, col0 + 16 * j + c, st[r * STAGE_LD + c]);
      }
      __syncwarp();
    }
}

// PT[c][k] += sum_r DT[c][r] A[r][k] for c < 256, k < KIN: DT (256 x ROWS,
// ldt) and A (ROWS x KIN used columns, lda) in shared memory, PT
// (256 x KIN, row-major) in global memory, private to this block.
template <int ROWS>
__device__ __forceinline__ void accum_dta(const float* DT, int ldt,
                                          const float* A, int lda, int KIN,
                                          float* PT) {
  for (int idx = threadIdx.x; idx < NF * KIN; idx += NTHREADS) {
    const int c = idx / KIN, k = idx % KIN;
    float s = 0.0f;
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) s = fmaf(DT[c * ldt + r], A[r * lda + k], s);
    PT[idx] += s;
  }
}

template <int ROWS>
__device__ __forceinline__ void accum_dta(const __nv_bfloat16* DT, int ldt,
                                          const __nv_bfloat16* A, int lda,
                                          int KIN, float* PT) {
  constexpr int RS = ROWS / 16;
  const int warp = threadIdx.x >> 5;
  // warp w owns output rows [32w, 32w + 32): two 16-row tiles of DT
  for (int ci = 0; ci < 2; ++ci) {
    const int c0 = warp * 32 + 16 * ci;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r)
      wmma::load_matrix_sync(fa[r], DT + (size_t)c0 * ldt + 16 * r, ldt);
    for (int k0 = 0; k0 < KIN; k0 += 64) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(acc[j], PT + (size_t)c0 * KIN + k0 + 16 * j,
                               KIN, wmma::mem_row_major);
#pragma unroll
      for (int r = 0; r < RS; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fb, A + (size_t)(16 * r) * lda + k0 + 16 * j,
                                 lda);
          wmma::mma_sync(acc[j], fa[r], fb, acc[j]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(PT + (size_t)c0 * KIN + k0 + 16 * j, acc[j],
                                KIN, wmma::mem_row_major);
    }
  }
}

template <typename T, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ e, T* E,
                                          int lde, int DP, long row0,
                                          long N) {
  for (int i = threadIdx.x; i < ROWS * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP;
    const long row = row0 + r;
    E[r * lde + c] = row < N ? e[row * DP + c] : fromf<T>(0.0f);
  }
}

// e (N, DP); win (DP, 256); b (256) float; ws (L-1, 256, 256) rows = input
// feature; wlast (256); out (N) float.
template <typename T, int ROWS>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_fwd_kernel(const T* __restrict__ e, const T* __restrict__ win,
                     const float* __restrict__ b, const T* __restrict__ ws,
                     const T* __restrict__ wlast, float* __restrict__ out,
                     long N, int DP, int L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lde = DP + PAD;
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + ROWS * LDA;
  T* E = buf1 + ROWS * LDA;
  float* stage = reinterpret_cast<float*>(E + ROWS * lde);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long ntiles = (N + ROWS - 1) / ROWS;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = tile * ROWS;
    __syncthreads();
    load_rows<T, ROWS>(e, E, lde, DP, row0, N);
    __syncthreads();
    T* cur = buf0;
    T* nxt = buf1;
    gemm_rows<ROWS>(E, lde, DP, win, stage, [&](int r, int c, float v) {
      const float z = rnd<T>(rnd<T>(v) + rnd<T>(b[c]));
      cur[r * LDA + c] = fromf<T>(fmaxf(z, 0.0f));
    });
    __syncthreads();
    for (int li = 0; li < L - 1; ++li) {
      gemm_rows<ROWS>(cur, LDA, NF, ws + (size_t)li * NF * NF, stage,
                      [&](int r, int c, float v) {
                        nxt[r * LDA + c] = fromf<T>(fmaxf(rnd<T>(v), 0.0f));
                      });
      __syncthreads();
      T* tmp = cur; cur = nxt; nxt = tmp;
    }
    for (int r = warp; r < ROWS; r += NWARPS) {
      float s = 0.0f;
      for (int k = lane; k < NF; k += 32)
        s = fmaf(tof(cur[r * LDA + k]), tof(wlast[k]), s);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && row0 + r < N) out[row0 + r] = rnd<T>(s);
    }
  }
}

// partial layout per block: dwin^T (256 x DP) | db (256) | dW_0^T ..
// dW_{L-2}^T (256 x 256 each, rows = output feature) | dwlast (256)
// wts (L-1, 256, 256): the transposes of ws (rows = output feature).
template <typename T, int ROWS>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_bwd_kernel(const T* __restrict__ e, const float* __restrict__ g,
                     const T* __restrict__ win, const float* __restrict__ b,
                     const T* __restrict__ ws, const T* __restrict__ wts,
                     const T* __restrict__ wlast, float* __restrict__ partial,
                     long N, int DP, int L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int lde = DP + PAD;
  T* acts = reinterpret_cast<T*>(smem_raw);            // L x ROWS x LDA
  T* E = acts + (size_t)L * ROWS * LDA;
  float* stage = reinterpret_cast<float*>(E + ROWS * lde);
  float* gs = stage + NWARPS * STAGE_SZ;               // ROWS
  const int ldt = ROWS + PAD;
  T* dT = reinterpret_cast<T*>(gs + ROWS);             // 256 x ldt
  const int t = threadIdx.x;
  const size_t psz = (size_t)DP * NF + NF + (size_t)(L - 1) * NF * NF + NF;
  float* P = partial + (size_t)blockIdx.x * psz;
  float* P_win = P;
  float* P_b = P + (size_t)DP * NF;
  float* P_w = P_b + NF;
  float* P_last = P_w + (size_t)(L - 1) * NF * NF;
  const long ntiles = (N + ROWS - 1) / ROWS;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long row0 = tile * ROWS;
    __syncthreads();
    load_rows<T, ROWS>(e, E, lde, DP, row0, N);
    if (t < ROWS) gs[t] = row0 + t < N ? rnd<T>(g[row0 + t]) : 0.0f;
    __syncthreads();
    // ---- recompute the activations a_0 .. a_{L-1} ----
    gemm_rows<ROWS>(E, lde, DP, win, stage, [&](int r, int c, float v) {
      const float z = rnd<T>(rnd<T>(v) + rnd<T>(b[c]));
      acts[r * LDA + c] = fromf<T>(fmaxf(z, 0.0f));
    });
    __syncthreads();
    for (int li = 0; li < L - 1; ++li) {
      const T* cur = acts + (size_t)li * ROWS * LDA;
      T* nxt = acts + (size_t)(li + 1) * ROWS * LDA;
      gemm_rows<ROWS>(cur, LDA, NF, ws + (size_t)li * NF * NF, stage,
                      [&](int r, int c, float v) {
                        nxt[r * LDA + c] = fromf<T>(fmaxf(rnd<T>(v), 0.0f));
                      });
      __syncthreads();
    }
    // ---- last layer (256 -> 1): thread t owns feature t ----
    {
      T* a = acts + (size_t)(L - 1) * ROWS * LDA;
      const float w = tof(wlast[t]);
      float s = 0.0f;
      for (int r = 0; r < ROWS; ++r) {
        const float av = tof(a[r * LDA + t]);
        s = fmaf(av, gs[r], s);
        const T dv = fromf<T>(av > 0.0f ? gs[r] * w : 0.0f);
        a[r * LDA + t] = dv;
        dT[t * ldt + r] = dv;
      }
      P_last[t] += s;
    }
    __syncthreads();
    // ---- hidden layers, last to first; d lives in acts[li + 1] ----
    for (int li = L - 2; li >= 0; --li) {
      T* a = acts + (size_t)li * ROWS * LDA;
      const T* d = acts + (size_t)(li + 1) * ROWS * LDA;
      accum_dta<ROWS>(dT, ldt, a, LDA, NF, P_w + (size_t)li * NF * NF);
      __syncthreads();
      gemm_rows<ROWS>(d, LDA, NF, wts + (size_t)li * NF * NF, stage,
                      [&](int r, int c, float v) {
                        const float av = tof(a[r * LDA + c]);
                        const T dv = fromf<T>(av > 0.0f ? v : 0.0f);
                        a[r * LDA + c] = dv;
                        dT[c * ldt + r] = dv;
                      });
      __syncthreads();
    }
    // ---- in-layer: d = acts[0] ----
    accum_dta<ROWS>(dT, ldt, E, lde, DP, P_win);
    {
      float s = 0.0f;
      for (int r = 0; r < ROWS; ++r) s += tof(acts[r * LDA + t]);
      P_b[t] += s;
    }
  }
}

// out[i] = sum over blocks, in block order, of partial[blk][i]
__global__ void fused_mlp_reduce_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int nblk,
                                        long psz) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= psz) return;
  float s = 0.0f;
  for (int k = 0; k < nblk; ++k) s += partial[(size_t)k * psz + i];
  out[i] = s;
}

#define MAX_SMEM 232448

template <typename T, int ROWS>
static int launch_fwd(const void* e, const void* win, const float* b,
                      const void* ws, const void* wlast, float* out, long N,
                      int DP, int L, int nblk, cudaStream_t stream) {
  const size_t smem = (size_t)2 * ROWS * LDA * sizeof(T) +
                      (size_t)ROWS * (DP + PAD) * sizeof(T) +
                      (size_t)NWARPS * STAGE_SZ * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_fwd_kernel<T, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_fwd_kernel<T, ROWS><<<nblk, NTHREADS, smem, stream>>>(
      (const T*)e, (const T*)win, b, (const T*)ws, (const T*)wlast, out, N,
      DP, L);
  return (int)cudaGetLastError();
}

template <typename T, int ROWS>
static int launch_bwd(const void* e, const float* g, const void* win,
                      const float* b, const void* ws, const void* wts,
                      const void* wlast, float* partial, float* out, long N,
                      int DP, int L, int nblk, cudaStream_t stream) {
  const size_t smem = (size_t)L * ROWS * LDA * sizeof(T) +
                      (size_t)ROWS * (DP + PAD) * sizeof(T) +
                      (size_t)NWARPS * STAGE_SZ * sizeof(float) +
                      (size_t)ROWS * sizeof(float) +
                      (size_t)NF * (ROWS + PAD) * sizeof(T);
  if (smem > MAX_SMEM || DP % 64) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<T, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_bwd_kernel<T, ROWS><<<nblk, NTHREADS, smem, stream>>>(
      (const T*)e, g, (const T*)win, b, (const T*)ws, (const T*)wts,
      (const T*)wlast, partial, N, DP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long psz = (long)DP * NF + NF + (long)(L - 1) * NF * NF + NF;
  fused_mlp_reduce_kernel<<<(unsigned)((psz + 255) / 256), 256, 0, stream>>>(
      partial, out, nblk, psz);
  return (int)cudaGetLastError();
}

// is_bf16: operands are __nv_bfloat16 (else float). Returns a cudaError.
extern "C" int fused_mlp_fwd_launch(const void* e, const void* win,
                                    const float* b, const void* ws,
                                    const void* wlast, float* out, long N,
                                    int DP, int L, int nblk, int is_bf16,
                                    void* stream) {
  if (DP % 16 || DP <= 0 || L < 2 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_fwd<__nv_bfloat16, 64>(e, win, b, ws, wlast, out, N, DP, L,
                                         nblk, (cudaStream_t)stream);
  return launch_fwd<float, 32>(e, win, b, ws, wlast, out, N, DP, L, nblk,
                               (cudaStream_t)stream);
}

// partial: (nblk, PSZ) float, zeroed by the caller; out: (PSZ) float.
extern "C" int fused_mlp_bwd_launch(const void* e, const float* g,
                                    const void* win, const float* b,
                                    const void* ws, const void* wts,
                                    const void* wlast, float* partial,
                                    float* out, long N, int DP, int L,
                                    int nblk, int is_bf16, void* stream) {
  if (DP % 16 || DP <= 0 || L < 2 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bwd<__nv_bfloat16, 64>(e, g, win, b, ws, wts, wlast,
                                         partial, out, N, DP, L, nblk,
                                         (cudaStream_t)stream);
  return launch_bwd<float, 32>(e, g, win, b, ws, wts, wlast, partial, out, N,
                               DP, L, nblk, (cudaStream_t)stream);
}
