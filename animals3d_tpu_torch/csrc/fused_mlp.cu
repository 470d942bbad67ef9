// Fused CoordMLP lattice sweep for Hopper (sm_90a): forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel`
// (animals3d_tpu/ops/fused_mlp.py:59) and `_bwd_kernel` (:76). They
// evaluate the netSDF trunk at every lattice vertex (2.1M rows at grid
// 128): in-layer + bias, relu, L-1 bias-free 256x256 layers with a relu
// between them, and a final 256 -> 1 layer; the backward gives the weight
// gradients of sum(out . g). No (N, 256) activation of the whole lattice
// ever reaches device memory.
//
// Numerics are the Pallas kernels': operands in the compute type T (bf16,
// or float for the float32 policy), float32 accumulation, every layer's
// output rounded to T; the bias is rounded to T and added in T; relu masks
// compare the rounded activation with 0; the backward rounds the masked
// d(activation) to T and accumulates every weight gradient in float32.
//
// Bound on the H100: 2 N (D 256 + (L-1) 256^2 + 256) operations forward
// (D the embedding's width) and three times that backward less the input
// cotangent, against N (2 D + 4) bytes: bound by operations (1.20 and
// 3.53 ms in bf16 at full width).
//
// Forward (K6, both types; unchanged since its first version). One block
// of 256 threads takes a tile of ROWS rows (64 for bf16, 32 for float) and
// loops over tiles blockIdx.x, blockIdx.x + gridDim.x, ...; two activation
// buffers ping-pong; weights are read from global memory (L2). bf16
// products run through nvcuda::wmma (warp w owns output columns [32w, 32w
// + 32)), float products are FMA loops, thread t owning column t.
//
// bf16 backward (K7) in three kernels per call, in a loop over chunks of
// C rows (`bwd_plan` in ops/fused_mlp.py). The TPU kernel accumulates the
// weight gradients across its sequential grid in VMEM; here the first
// design gave every block a private float32 copy of all of them (1.1 MB)
// in device memory and read and wrote it back for every 64-row tile: 75 GB
// per call, more than the products cost. The backward is now split:
//
//  * chain pass (fused_mlp_chain_kernel, one 128-row tile per block and
//    step): recompute a_0 .. a_{L-1}, walk the cotangent back, and write
//    the bf16 operands of the weight gradients (a_0 .. a_{L-2}, d_0 ..
//    d_{L-1} and the input rows: 4.7 KB per row) to a scratch of 2L
//    planes of C rows. The
//    products are warpgroup MMAs (wgmma m64n256k16, two warpgroups, 64
//    rows each) with both operands in shared memory in wgmma's 128-byte
//    swizzled layouts; the weights come as (32, 256) slices laid out by the
//    caller as their shared-memory image (`weight_stream`), one bulk copy
//    (cp.async.bulk + mbarrier) per slice into a 4-slot ring, two slices
//    ahead, with one slice of products in flight. Each finished tile
//    buffer goes to the scratch by one bulk store (the copy engine moves
//    the bytes), so the scratch keeps the buffer's layout: one 64 KB block
//    per (plane, tile). Each thread keeps the relu bits of the elements it
//    owns (every layer's product gives a thread the same elements); the
//    last layer and db are folded into the epilogues; db and dwlast are
//    summed in a fixed order and kept per block.
//  * weight-gradient pass (fused_mlp_wgrad_kernel): dW_li^T = d_{li+1}^T
//    a_li and dwin^T = d_0^T e over the chunk's rows as GEMMs with K = the
//    rows: block (tile, split) owns a 256 x 128 output tile and a fixed
//    share of the rows, runs wgmma m64n128k16 (both operands MN-major)
//    from a 4-stage ring filled by bulk copies of the scratch blocks, and
//    writes its float32 sums to its own partial once per chunk (stored for
//    the first chunk, then added).
//  * reduce (fused_mlp_bwd_reduce_kernel): the partials summed over the
//    splits (db, dwlast: over the chain blocks) in a fixed order.
// No float atomics: the result does not change from run to run. Rows past
// N carry a zero input and a zero cotangent.
//
// float32 backward (the float32 policy's card-vs-CPU references; off the
// bf16 main path): the first design, kept as it is — one kernel, the
// activations of a 32-row tile in shared memory, a private partial of
// every gradient per block, updated per tile, and a reduce kernel. It has
// no tensor-core path to gain from the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16 backward: chain pass + weight-gradient pass + reduce
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// bulk asynchronous copy shared -> global (the copy engine; no thread
// moves the bytes), its group commit, and waits until at most N groups
// still read their source (`read`) or are still in flight
__device__ __forceinline__ void bulk_store(void* gdst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          gdst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared) -> visible to
// the async proxy through which wgmma and the bulk copies read
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory operands are in wgmma's canonical layouts with the 128-byte
// swizzle: atoms of 8 rows x 128 bytes (1024 bytes, 1024-aligned), the
// 16-byte chunk j of atom row i stored at chunk j ^ i.
//  * K-major tile buffer, 128 rows x K (rows of the tile; K contiguous):
//    column block K / 64 of 128 x 128 bytes each; descriptor LBO unused,
//    SBO 1024 (next 8 rows).
//  * MN-major weight slice, 32 K-rows x 256 (256 contiguous; `moff`):
//    atom (K group kg, 64-column block nb) at (4 kg + nb) * 1024 bytes;
//    LBO 1024 (next 64 columns), SBO 4096 (next 8 K-rows).
//  * MN-major weight-gradient stage, 32 rows x W (W contiguous): 64-column
//    blocks of 32 x 128 bytes (the scratch blocks' own layout); LBO 4096
//    (next 64 columns), SBO 1024 (next 8 rows).
__device__ __forceinline__ uint64_t gdesc(const void* p, unsigned lbo,
                                          unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// element offset of (r, c) in a K-major tile buffer of 128 rows
__device__ __forceinline__ int koff(int r, int c) {
  return ((c >> 6) << 13) + (r << 6) + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}
// element offset of (k, n) in an MN-major weight slice (32 x 256); the
// caller lays the slices out so (ops/fused_mlp.py `slice_layout`)
__device__ __forceinline__ int moff(int k, int n) {
  return ((k >> 3) << 11) + ((n >> 6) << 9) + ((k & 7) << 6) +
         ((((n >> 3) & 7) ^ (k & 7)) << 3) + (n & 7);
}

// d (64 x 256, this thread's 128 floats) += A B for one k16 step;
// A and B by shared-memory descriptor, TA / TB: operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 128, this thread's 64 floats) += A B for one k16 step;
// A and B by shared-memory descriptor, TA / TB: operand is MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}


#define CH_ROWS 128      // rows per chain-pass tile
#define CH_KS 32         // rows of a weight matrix per staged slice
#define CH_NST 4         // slices in the ring: 2 landing, 1 in use, 1 read
                         // by the products still in flight
#define CH_SLICE (CH_KS * NF)
#define TILE_ELEMS (CH_ROWS * NF)

// mbarrier helpers: init, arrive with an expected transaction count, wait
// for a phase to complete
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bulk asynchronous copy global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The chain pass's weight stream: the K-slices (32 x 256) of the weight
// matrices in the order the tile's products read them (win, ws[0..L-2]
// for the recomputed forward, ws[L-2..0]^T for the cotangent), laid out by
// the caller as the ring's own image of each slice (`moff`), so that one
// bulk copy by thread 0 brings a slice; repeated for each of the block's
// tiles, two slices ahead of the products, each slot with its mbarrier.
struct WeightStream {
  const bf16* src;
  bf16* ring;
  uint64_t* full;
  int per_tile;
  int left;          // slices still to issue
  int slot;          // position of the next slice to issue within a tile
  int put, get;      // ring slots of the next issue and the next use
  unsigned used;     // slices consumed so far

  __device__ __forceinline__ void issue() {
    if (left > 0) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(full + put, CH_SLICE * sizeof(bf16));
        bulk_load(ring + put * CH_SLICE, src + (size_t)slot * CH_SLICE,
                  CH_SLICE * sizeof(bf16), full + put);
      }
      --left;
      slot = slot + 1 == per_tile ? 0 : slot + 1;
    }
    put = put + 1 == CH_NST ? 0 : put + 1;
  }
  __device__ __forceinline__ void wait() {
    mbar_wait(full + get, (used / CH_NST) & 1);
  }
  __device__ __forceinline__ void next() {
    get = get + 1 == CH_NST ? 0 : get + 1;
    ++used;
  }
};

// acc = A B for A (128 x 32 nk, K-major tile buffer) and the next nk
// slices of the weight stream. Warpgroup wg owns rows [64 wg, 64 wg + 64)
// and all 256 columns: acc[4 j + 2 h + q] is row 64 wg + 16 (warp % 4) +
// lane / 4 + 8 h, column 8 j + 2 (lane % 4) + q. One slice of products
// stays in flight while the next slice lands. With `store`, thread 0 also
// starts the bulk store of A to that 64 KB scratch block once A is
// complete. Before the last slice it waits until no bulk store but that
// one still reads its source, so that the epilogue that follows may
// overwrite the other tile buffer.
__device__ __forceinline__ void chain_gemm(WeightStream& st, const bf16* A,
                                           int nk, float (&acc)[128],
                                           bf16* store,
                                           unsigned bytes = TILE_ELEMS * 2) {
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  for (int kk = 0; kk < nk; ++kk) {
    st.wait();
    if (kk == 0) fence_async_smem();     // the epilogue's writes of A
    wgmma_wait<1>();
    if (threadIdx.x == 0 && kk == nk - 1) {
      if (store) bulk_wait_read<1>(); else bulk_wait_read<0>();
    }
    __syncthreads();
    st.issue();
    if (threadIdx.x == 0 && kk == 0 && store) bulk_store(store, A, bytes);
    const bf16* Bs = st.ring + st.get * CH_SLICE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CH_KS / 16; ++ks) {
      const int s = 2 * kk + ks;         // k16 step within A's K
      wgmma_m64n256<0, 1>(
          acc, gdesc(A + ((s >> 2) << 13) + (64 * wg << 6) + ((s & 3) << 4),
                     16, 1024),
          gdesc(Bs + moff(16 * ks, 0), 1024, 4096));
    }
    wgmma_commit();
    st.next();
  }
  wgmma_wait<0>();
}

// Sum over the tile's 128 rows, per column, of the per-element values
// x[4 j + 2 h + q] of this thread (rows r0, r0 + 8; columns 8 j + 2 (lane
// % 4) + q): within the warp by a fixed butterfly, then over the 8 warps
// in warp order through red (8 x 256). Thread t returns column t's sum.
__device__ __forceinline__ float column_sums(const float (&x)[128],
                                             float* red) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float p = x[4 * j + q] + x[4 * j + 2 + q];
      p += __shfl_xor_sync(0xffffffffu, p, 4);
      p += __shfl_xor_sync(0xffffffffu, p, 8);
      p += __shfl_xor_sync(0xffffffffu, p, 16);
      if (lane < 4) red[warp * NF + 8 * j + 2 * lane + q] = p;
    }
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) s += red[w * NF + t];
  return s;
}

// Chain pass over the rows [row0, row0 + rows) of one chunk (rows <= C):
// per 128-row tile, recompute a_0 .. a_{L-1} and walk the cotangent back.
// The bf16 operands of the weight gradients go to the scratch (2L - 1
// planes of C x 256: a_0 .. a_{L-2}, then d_0 .. d_{L-1}; then the input
// rows, C x DP), each tile's 128 rows of a plane as one block in the tile
// buffer's own layout (`koff`), written by bulk stores straight from the
// tile buffers. Two
// tile buffers ping-pong (the input rows sit in the second while the
// first product runs); of a_0 .. a_{L-2} each thread keeps only the relu
// bits of its own 128 elements (the products of every layer give a thread
// the same elements). The last layer (256 -> 1) and db are folded into
// the epilogues of a_{L-1} and d_0; dwlast and db stay in registers
// (thread t owns feature t) and go to part2 (gridDim.x x 512: db |
// dwlast) once per launch, stored when `first`, else added. Tile rows past
// the chunk carry a zero cotangent.
__global__ void __launch_bounds__(NTHREADS, 1)
fused_mlp_chain_kernel(const bf16* __restrict__ e, const float* __restrict__ g,
                       const bf16* __restrict__ wstream,
                       const float* __restrict__ b,
                       const bf16* __restrict__ wlast,
                       bf16* __restrict__ scratch, float* __restrict__ part2,
                       long row0, int rows, long C, int DP, int L,
                       int first) {
  extern __shared__ __align__(1024) unsigned char smem_sw[];
  bf16* buf[2];
  buf[0] = reinterpret_cast<bf16*>(smem_sw);         // 128 x 256 each
  buf[1] = buf[0] + TILE_ELEMS;
  bf16* E = buf[1];                                   // 128 x DP
  bf16* ring = buf[1] + TILE_ELEMS;                   // CH_NST slices
  uint4* masks = reinterpret_cast<uint4*>(ring + CH_NST * CH_SLICE);
  float* red = reinterpret_cast<float*>(masks + (size_t)(L - 1) * NTHREADS);
  float* sb = red + NWARPS * NF;                      // rounded bias
  float* sw = sb + NF;                                // wlast
  float* gs = sw + NF;                                // rounded cotangent
  uint64_t* full = reinterpret_cast<uint64_t*>(gs + CH_ROWS);
  const int t = threadIdx.x, lane = t & 31, tq = lane & 3;
  const int r0 = 64 * (t >> 7) + 16 * ((t >> 5) & 3) + (lane >> 2);
  const size_t plane = (size_t)C * NF;
  const int ntiles = (rows + CH_ROWS - 1) / CH_ROWS;
  const int mine = ntiles > (int)blockIdx.x
                       ? (ntiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int nwin = DP / CH_KS;
  WeightStream st;
  st.src = wstream; st.ring = ring; st.full = full;
  st.per_tile = nwin + 2 * (L - 1) * (NF / CH_KS);
  st.left = mine * st.per_tile;
  st.slot = 0; st.put = 0; st.get = 0; st.used = 0;
  if (t == 0) {
    for (int i = 0; i < CH_NST; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int i = 0; i < CH_NST - 2; ++i) st.issue();
  sb[t] = rnd<bf16>(b[t]);
  sw[t] = tof(wlast[t]);
  float acc[128];
  float db_sum = 0.0f, dwl_sum = 0.0f;
  const int DC = DP / 8;
  for (int it = 0; it < mine; ++it) {
    const long lr0 = (long)(blockIdx.x + it * gridDim.x) * CH_ROWS;
    bf16* const blk = scratch + (size_t)lr0 * NF;     // this tile's blocks
    // buf[1]'s last bulk store (d_1 of the previous tile) has read it
    if (t == 0) bulk_wait_read<1>();
    __syncthreads();
    for (int c = t; c < CH_ROWS * DC; c += NTHREADS) {
      const int w = c >> 5, gi = w / (DC / 4);
      const int kc = 4 * (w % (DC / 4)) + (lane >> 3), r = 8 * gi + (lane & 7);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (lr0 + r < rows)
        v = *reinterpret_cast<const uint4*>(e + (size_t)(row0 + lr0 + r) *
                                                    DP + 8 * kc);
      *reinterpret_cast<uint4*>(E + koff(r, 8 * kc)) = v;
    }
    if (t < CH_ROWS)
      gs[t] = lr0 + t < rows ? rnd<bf16>(g[row0 + lr0 + t]) : 0.0f;
    // ---- recompute a_0 .. a_{L-2}: a_li in buf[li % 2] ----
    for (int li = 0; li < L - 1; ++li) {
      const bf16* A = li ? buf[(li - 1) & 1] : E;
      if (li)
        chain_gemm(st, A, NF / CH_KS, acc, blk + (size_t)(li - 1) * plane);
      else
        chain_gemm(st, E, nwin, acc,
                   scratch + (2 * L - 1) * plane + (size_t)lr0 * DP,
                   CH_ROWS * DP * sizeof(bf16));
      bf16* out = buf[li & 1];
      unsigned bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h, c = 8 * j + 2 * tq;
          float x0 = acc[i], x1 = acc[i + 1];
          if (li == 0) {
            x0 = rnd<bf16>(x0) + sb[c];
            x1 = rnd<bf16>(x1) + sb[c + 1];
          }
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(fmaxf(x0, 0.0f), fmaxf(x1, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(out + koff(r0 + 8 * h, c)) = v;
          bits[i >> 5] |= (__bfloat162float(v.x) > 0.0f ? 1u : 0u)
                              << (i & 31) |
                          (__bfloat162float(v.y) > 0.0f ? 1u : 0u)
                              << ((i + 1) & 31);
        }
      masks[li * NTHREADS + t] = make_uint4(bits[0], bits[1], bits[2],
                                            bits[3]);
    }
    // ---- a_{L-1} and the last layer: d_{L-1} = relu'(a) g wlast ----
    bf16* cur = buf[(L - 1) & 1];
    chain_gemm(st, buf[(L - 2) & 1], NF / CH_KS, acc,
               blk + (size_t)(L - 2) * plane);
    {
      const float g0 = gs[r0], g1 = gs[r0 + 8];
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h, c = 8 * j + 2 * tq;
          const float gr = h ? g1 : g0;
          const float a0 = rnd<bf16>(fmaxf(acc[i], 0.0f));
          const float a1 = rnd<bf16>(fmaxf(acc[i + 1], 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(cur + koff(r0 + 8 * h, c)) =
              __floats2bfloat162_rn(a0 > 0.0f ? gr * sw[c] : 0.0f,
                                    a1 > 0.0f ? gr * sw[c + 1] : 0.0f);
          acc[i] = a0 * gr;
          acc[i + 1] = a1 * gr;
        }
      dwl_sum += column_sums(acc, red);
    }
    // ---- hidden layers, last to first: d_li from d_{li+1} ----
    for (int li = L - 2; li >= 0; --li) {
      bf16* nxt = buf[li & 1];
      chain_gemm(st, cur, NF / CH_KS, acc,
                 blk + (size_t)(L + li) * plane);
      const uint4 m4 = masks[li * NTHREADS + t];
      const unsigned mw[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h, c = 8 * j + 2 * tq;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              (mw[i >> 5] >> (i & 31)) & 1u ? acc[i] : 0.0f,
              (mw[i >> 5] >> ((i + 1) & 31)) & 1u ? acc[i + 1] : 0.0f);
          *reinterpret_cast<__nv_bfloat162*>(nxt + koff(r0 + 8 * h, c)) = v;
          acc[i] = __bfloat162float(v.x);
          acc[i + 1] = __bfloat162float(v.y);
        }
      cur = nxt;
    }
    db_sum += column_sums(acc, red);       // d_0, as rounded
    // ---- d_0 (in buf[0]) to the scratch ----
    fence_async_smem();
    __syncthreads();
    if (t == 0) bulk_store(blk + (size_t)(L - 1) * plane, cur,
                           TILE_ELEMS * sizeof(bf16));
  }
  if (t == 0) bulk_wait_all();
  float* P = part2 + (size_t)blockIdx.x * 2 * NF;
  P[t] = first ? db_sum : P[t] + db_sum;
  P[NF + t] = first ? dwl_sum : P[NF + t] + dwl_sum;
}

#define WG_BM 256        // output rows (features of the cotangent) per tile
#define WG_BN 128        // output columns (input features) per tile
#define WG_BK 32         // rows of the chunk per stage
#define WG_NST 4
#define WG_STAGE (WG_BK * (WG_BM + WG_BN))

// Weight-gradient pass over one chunk: out^T[c][k] = sum_r D[r][c] X[r][k]
// over the chunk's rows, for every (D, X) pair: (d_0, e) -> dwin^T and
// (d_{li+1}, a_li) -> dW_li^T, all read from the scratch. Block (tile,
// split) owns a 256 x 128 output tile (256 x DP for dwin^T) and the
// split'th share of the chunk's rows; warpgroup wg owns its rows [128 wg,
// 128 wg + 128) as two m64n128 products. Both operands are MN-major (the
// rows of the chunk are the K dimension): a stage holds 32 rows of each
// operand as 64-column blocks of 4 KB (32 rows x 128 bytes, the scratch
// blocks' own swizzled layout), so one bulk copy brings each block; 4
// stages, two landing and one of products in flight. The float32 sums are
// stored (first) or added to the block's own partial part[split] once per
// chunk.
__global__ void __launch_bounds__(NTHREADS, 1)
fused_mlp_wgrad_kernel(const bf16* __restrict__ scratch,
                       float* __restrict__ part, int rows, long C, int DP,
                       int L, int first) {
  extern __shared__ __align__(1024) unsigned char smem_sw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_sw);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + WG_NST * WG_STAGE);
  const int tile = blockIdx.x, split = blockIdx.y, S = gridDim.y;
  const int t = threadIdx.x, lane = t & 31, wg = t >> 7;
  const size_t plane = (size_t)C * NF;
  const size_t psz = (size_t)DP * NF + NF + (size_t)(L - 1) * NF * NF + NF;
  const int nwin = (DP + WG_BN - 1) / WG_BN;
  const bf16* Ag;
  const bf16* Bg;
  int n0, nw, kin, bw;   // bw: row width of the B plane's tile blocks
  size_t off;
  if (tile < nwin) {
    n0 = tile * WG_BN;
    nw = min(WG_BN, DP - n0);
    Ag = scratch + (size_t)(L - 1) * plane;                  // d_0
    Bg = scratch + (size_t)(2 * L - 1) * plane;              // e
    bw = DP;
    kin = DP;
    off = 0;
  } else {
    const int t2 = tile - nwin, li = t2 >> 1;
    n0 = (t2 & 1) * WG_BN;
    nw = WG_BN;
    Ag = scratch + (size_t)(L + li) * plane;                 // d_{li+1}
    Bg = scratch + (size_t)li * plane;                       // a_li
    bw = NF;
    kin = NF;
    off = (size_t)DP * NF + NF + (size_t)li * NF * NF;
  }
  const int ksteps = (rows + WG_BK - 1) / WG_BK;
  const int per = (ksteps + S - 1) / S;
  const int kb = min(ksteps, split * per);
  const int n = min(ksteps, kb + per) - kb;
  const int nbB = nw / 64;
  // B's column blocks past nw (dwin^T at DP = 64) stay zero
  for (int c = t; c < WG_NST * WG_BK * WG_BN / 8; c += NTHREADS) {
    const int st = c / (WG_BK * WG_BN / 8), w = c % (WG_BK * WG_BN / 8);
    if (w * 8 >= nbB * 64 * WG_BK)
      *reinterpret_cast<uint4*>(sm + st * WG_STAGE + WG_BK * WG_BM + w * 8) =
          make_uint4(0, 0, 0, 0);
  }
  if (t == 0) {
    for (int i = 0; i < WG_NST; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();
  __syncthreads();
  // stage i: rows [rb, rb + 32) of the chunk, inside one 128-row tile
  auto load = [&](int i) {
    if (t == 0 && i < n) {
      bf16* As = sm + (i % WG_NST) * WG_STAGE;
      bf16* Bs = As + WG_BK * WG_BM;
      const int rb = (kb + i) * WG_BK;
      const size_t ra = (size_t)(rb >> 7) * TILE_ELEMS + (rb & 127) * 64;
      const size_t rbb = (size_t)(rb >> 7) * CH_ROWS * bw + (rb & 127) * 64;
      uint64_t* bar = full + i % WG_NST;
      mbar_expect_tx(bar, (WG_BM / 64 + nbB) * WG_BK * 128);
      for (int nb = 0; nb < WG_BM / 64; ++nb)
        bulk_load(As + nb * WG_BK * 64, Ag + ra + nb * 8192, WG_BK * 128,
                  bar);
      for (int nb = 0; nb < nbB; ++nb)
        bulk_load(Bs + nb * WG_BK * 64, Bg + rbb + (n0 / 64 + nb) * 8192,
                  WG_BK * 128, bar);
    }
  };
  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.0f;
  for (int i = 0; i < WG_NST - 2; ++i) load(i);
  for (int i = 0; i < n; ++i) {
    mbar_wait(full + i % WG_NST, (i / WG_NST) & 1);
    wgmma_wait<1>();
    __syncthreads();
    load(i + WG_NST - 2);
    const bf16* As = sm + (i % WG_NST) * WG_STAGE;
    const bf16* Bs = As + WG_BK * WG_BM;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n128<1, 1>(
            acc[h],
            gdesc(As + (2 * wg + h) * WG_BK * 64 + ks * 16 * 64,
                  WG_BK * 128, 1024),
            gdesc(Bs + ks * 16 * 64, WG_BK * 128, 1024));
    wgmma_commit();
  }
  wgmma_wait<0>();
  float* P = part + (size_t)split * psz + off;
  const int tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 8 * j + 2 * tq;
      if (c >= nw) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = 128 * wg + 64 * h + 16 * ((t >> 5) & 3) + (lane >> 2) +
                      8 * hh;
        float2* p = reinterpret_cast<float2*>(P + (size_t)m * kin + n0 + c);
        float2 v = make_float2(acc[h][4 * j + 2 * hh],
                               acc[h][4 * j + 2 * hh + 1]);
        if (!first) {
          const float2 o = *p;
          v.x = o.x + v.x;
          v.y = o.y + v.y;
        }
        *p = v;
      }
    }
}

// out[i] = sum over the splits, in split order, of part[s][i]; db and
// dwlast: sum over the chain blocks, in block order, of part2[blk]
__global__ void fused_mlp_bwd_reduce_kernel(const float* __restrict__ part,
                                            int S,
                                            const float* __restrict__ part2,
                                            int G, float* __restrict__ out,
                                            long psz, int DP) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= psz) return;
  const long ob = (long)DP * NF, ol = psz - NF;
  float s = 0.0f;
  if (i >= ob && i < ob + NF) {
    for (int k = 0; k < G; ++k) s += part2[(size_t)k * 2 * NF + (i - ob)];
  } else if (i >= ol) {
    for (int k = 0; k < G; ++k) s += part2[(size_t)k * 2 * NF + NF + (i - ol)];
  } else {
    for (int k = 0; k < S; ++k) s += part[(size_t)k * psz + i];
  }
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

// float32 policy: the first design (see the note at the top).
// partial: (nblk, PSZ) float, zeroed by the caller; out: (PSZ) float.
extern "C" int fused_mlp_bwd_f32_launch(const float* e, const float* g,
                                        const float* win, const float* b,
                                        const float* ws, const float* wts,
                                        const float* wlast, float* partial,
                                        float* out, long N, int DP, int L,
                                        int nblk, void* stream) {
  constexpr int ROWS = 32;
  if (DP % 64 || DP <= 0 || L < 2 || nblk <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)L * ROWS * LDA * sizeof(float) +
                      (size_t)ROWS * (DP + PAD) * sizeof(float) +
                      (size_t)NWARPS * STAGE_SZ * sizeof(float) +
                      (size_t)ROWS * sizeof(float) +
                      (size_t)NF * (ROWS + PAD) * sizeof(float);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bwd_kernel<float, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fused_mlp_bwd_kernel<float, ROWS><<<nblk, NTHREADS, smem, s>>>(
      e, g, win, b, ws, wts, wlast, partial, N, DP, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long psz = (long)DP * NF + NF + (long)(L - 1) * NF * NF + NF;
  fused_mlp_reduce_kernel<<<(unsigned)((psz + 255) / 256), 256, 0, s>>>(
      partial, out, nblk, psz);
  return (int)cudaGetLastError();
}

static size_t chain_smem(int L) {
  return (size_t)2 * TILE_ELEMS * sizeof(bf16) +
         (size_t)CH_NST * CH_SLICE * sizeof(bf16) +
         (size_t)(L - 1) * NTHREADS * sizeof(uint4) +
         (size_t)(NWARPS * NF + 3 * NF + CH_ROWS) * sizeof(float) +
         CH_NST * sizeof(uint64_t);
}

// bf16 chain pass over the chunk [row0, row0 + rows) of e (N, DP); see
// fused_mlp_chain_kernel. scratch: (2L - 1) planes of C x 256 bf16 in
// 128-row blocks; part2: (nblk, 512) float.
extern "C" int fused_mlp_bwd_chain_launch(
    const void* e, const float* g, const void* wstream, const float* b,
    const void* wlast, void* scratch, float* part2, long row0, long rows,
    long C, int DP, int L, int nblk, int first, void* stream) {
  if (DP % 64 || DP <= 0 || DP > NF || L < 2 || nblk <= 0 || rows <= 0 ||
      rows > C || C % CH_ROWS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = chain_smem(L);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_chain_kernel<<<nblk, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)e, g, (const bf16*)wstream, b, (const bf16*)wlast,
      (bf16*)scratch, part2, row0, (int)rows, C, DP, L, first);
  return (int)cudaGetLastError();
}

// bf16 weight-gradient pass over the same chunk; part: (nsplit, PSZ) float
extern "C" int fused_mlp_bwd_wgrad_launch(const void* scratch, float* part,
                                          long rows, long C, int DP, int L,
                                          int nsplit, int first,
                                          void* stream) {
  if (DP % 64 || DP <= 0 || DP > NF || L < 2 || nsplit <= 0 || rows <= 0 ||
      rows > C || C % CH_ROWS)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)WG_NST * WG_STAGE * sizeof(bf16) + WG_NST * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntile = (DP + WG_BN - 1) / WG_BN + 2 * (L - 1);
  fused_mlp_wgrad_kernel<<<dim3(ntile, nsplit), NTHREADS, smem,
                           (cudaStream_t)stream>>>(
      (const bf16*)scratch, part, (int)rows, C, DP, L, first);
  return (int)cudaGetLastError();
}

// out (PSZ) float from the splits' partials and the chain blocks' db/dwlast
extern "C" int fused_mlp_bwd_reduce_launch(const float* part, int nsplit,
                                           const float* part2, int nblk,
                                           float* out, int DP, int L,
                                           void* stream) {
  const long psz = (long)DP * NF + NF + (long)(L - 1) * NF * NF + NF;
  fused_mlp_bwd_reduce_kernel<<<(unsigned)((psz + 255) / 256), 256, 0,
                                (cudaStream_t)stream>>>(
      part, nsplit, part2, nblk, out, psz, DP);
  return (int)cudaGetLastError();
}
