// Resolve rows forward for Hopper (sm_90a): the per-pixel row gather
// rows[b, c, q] = pf[b, face_id[b, pixel(q)] - 1, c], written channel-major
// in tile order (q runs over 16x32 tiles, rows within a tile), zero on
// background pixels (face_id == 0).
//
// Replaces the Pallas TPU kernel `_resolve_fwd_kernel`
// (animals3d_tpu/ops/rasterize_pallas.py:1269, launched by
// `resolve_rows_pallas` at :1326). On the TPU the gather is a one-hot
// matrix product over the rasterizer's winner-chunk lists, because the TPU
// gathers rows slowly; a GPU reads a row by address, so a pixel's winner id
// addresses its row directly and the kernel needs neither the lists nor
// the winner flags.
//
// Design: one thread per output element (pixel, channel), consecutive
// threads on consecutive tile-order pixels of one channel, so the writes of
// the (B, R, T*TP) output are coalesced and the face_id reads of a warp are
// one 128-byte tile row. The pf reads are scattered: each is one float of a
// face's row; the rows of neighbouring pixels and channels meet again in
// L2.
//
// Bound on the H100: bytes — face_id read once, the rows of the foreground
// pixels read once, the output written once.

#include <cuda_runtime.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)

// pf (B, F, R) float; face_id (B, H*W) int32 raster order, 1-based;
// out (B, R, H*W) float in tile order.
__global__ void resolve_fwd_kernel(const float* __restrict__ pf,
                                   const int* __restrict__ face_id,
                                   float* __restrict__ out, long total, int F,
                                   int R, int HW, int ntx, int W) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int q = (int)(i % HW);
  const long bc = i / HW;                 // b * R + c
  const int c = (int)(bc % R);
  const long b = bc / R;
  const int t = q / TP, p = q % TP;
  const int y = (t / ntx) * TILE_H + p / TILE_W;
  const int x = (t % ntx) * TILE_W + p % TILE_W;
  const int fid = face_id[b * HW + (long)y * W + x];
  out[i] = (fid > 0 && fid <= F) ? pf[((size_t)b * F + (fid - 1)) * R + c]
                                 : 0.0f;
}

extern "C" int resolve_fwd_launch(const float* pf, const int* face_id,
                                  float* out, int B, int F, int R, int H,
                                  int W, void* stream) {
  const long total = (long)B * R * H * W;
  if (total <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  resolve_fwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pf, face_id, out, total, F, R, H * W, W / TILE_W, W);
  return (int)cudaGetLastError();
}
