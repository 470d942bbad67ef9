// Resolve backward for Hopper (sm_90a): the transpose of the per-pixel
// row gather rows[b, p, :] = pf[b, face_id[b, p] - 1, :].
//
// Replaces the Pallas TPU kernel `_resolve_bwd_kernel`
// (animals3d_tpu/ops/rasterize_pallas.py:1097, launched by
// `resolve_grad_pallas` at :1167). It computes what that kernel computes,
//   d_pf[b, f, :] = sum of g[b, p, :] over the pixels p whose winner is f,
// and none of its TPU machinery: the one-hot matrix product, the per-
// (image, chunk) tile lists with their full-scan fallback and the Morton
// id synthesis exist there because the TPU has no scatter; a GPU has
// atomics.
//
// Design: one thread per (pixel, channel) element of g, channels fastest,
// so a warp reads g coalesced and its atomicAdds land on consecutive
// addresses of one or two face rows. Background pixels (face_id == 0)
// return before touching anything, so a stray cotangent on the background
// cannot alias into face 0. The caller zero-fills d_pf. About a third of
// the pixels are foreground over ~1e5 live faces, so a face collects one
// to a few pixels and collisions are rare; where a face has several
// pixels the order of the float32 additions changes from run to run.
//
// Bound on the H100: bytes — g and face_id read once, d_pf written once
// (the caller's zero fill included); one addition per foreground element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// g (B, P, R); face_id (B, P) int32, 1-based, 0 = background;
// d_pf (B, F, R) float, zero-filled by the caller.
template <typename T>
__global__ void resolve_bwd_kernel(const T* __restrict__ g,
                                   const int* __restrict__ face_id,
                                   float* __restrict__ d_pf, long total,
                                   int P, int R, int F) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long pix = i / R;                 // b * P + p
  const int c = (int)(i - pix * R);
  const int fid = face_id[pix];
  if (fid <= 0 || fid > F) return;
  const long b = pix / P;
  atomicAdd(d_pf + ((size_t)b * F + (fid - 1)) * R + c, to_float(g[i]));
}

extern "C" int resolve_bwd_launch(const void* g, const int* face_id,
                                  float* d_pf, int B, int P, int R, int F,
                                  int is_bf16, void* stream) {
  const long total = (long)B * P * R;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (is_bf16)
    resolve_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0,
                                        (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)g, face_id, d_pf, total, P, R, F);
  else
    resolve_bwd_kernel<float><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)g, face_id, d_pf, total, P, R, F);
  return (int)cudaGetLastError();
}
