// Per-face cull boxes for the tile visibility kernels K1, K2 and K3, and
// per-unit boxes for K3 (sm_90a).
//
// Computes `rasterize_cuda.cull_boxes` (its plain version, in float64
// PyTorch), bit for bit: per image and sorted face slot, the pixel index
// ranges [x0, x1, y0, y1] (int16) outside which the face's float32 edge
// tests accept no pixel centre. It replaces no Pallas kernel: the JAX
// package makes its per-face boxes in the XLA prep of `rasterize_pallas`
// (animals3d_tpu/ops/rasterize_pallas.py:960, `coeffs_one`), from the
// vertices; the port's boxes come from the float32 coefficients, so that
// the cull changes no winner (see `cull_boxes`).
//
// One thread per (image, slot), a block per 256 slots of one chunk (no
// integer division): it reads the face's 12 coefficients (each row of the
// (B, nch, 12, chunk) table coalesced across the threads of a chunk), lifts them to float64 and follows the plain version's operations
// in its order, each rounded to nearest (__dmul_rn, __dadd_rn, __ddiv_rn;
// the library is built with -fmad=false), so that no float64 table or
// temporary is ever stored.
//
// Bound on the H100: bytes — the table's 9 edge rows read once (36 bytes
// a face; the depth rows are not read) and the boxes written once (8
// bytes a face); 1.97M faces at full width move 86.5 MB, 0.026 ms at 3.35
// TB/s. The float64 arithmetic (about 110 operations and 6 divisions a
// face) is below that at the card's float64 rate.

//
// The unit boxes (`unit_boxes_kernel`) compute `rasterize_cuda.unit_boxes`
// bit for bit: per image and unit (a sub-block of `sub` consecutive slots)
// the union of its faces' non-empty boxes, (W, -1, H, -1) where all are
// empty. One warp a unit: its lanes fold the boxes with integer min and
// max, then the warp reduces by shuffles. Bound: bytes — the face boxes
// read once and the unit boxes written once (15.9 MB at full width, 0.005
// ms at 3.35 TB/s).

#include <cuda_runtime.h>
#include <math.h>

static __device__ __forceinline__ double sub_rn(double a, double b) {
  return __dadd_rn(a, -b);
}

#define NT 256

// table: (B, nch, 12, chunk) f32; out: (B, nch*chunk) boxes. Block
// (image * nch + chunk id, j) takes faces j*NT ... of that chunk.
__global__ void __launch_bounds__(NT)
cull_boxes_kernel(const float* __restrict__ table, short4* __restrict__ out,
                  int chunk, int H, int W) {
  const int f = blockIdx.y * NT + threadIdx.x;
  if (f >= chunk) return;
  const size_t bc = blockIdx.x;
  const size_t i = bc * chunk + f;
  const float* src = table + bc * 12 * chunk + f;
  double a[3], b[3], c[3], cp[3];
  for (int k = 0; k < 3; ++k) {
    a[k] = (double)src[(size_t)k * chunk];
    b[k] = (double)src[(size_t)(4 + k) * chunk];
    c[k] = (double)src[(size_t)(8 + k) * chunk];
    // c + 2^-21 (|a| W + |b| H + |c|) + 1e-30
    const double s = __dadd_rn(__dadd_rn(__dmul_rn(fabs(a[k]), (double)W),
                                         __dmul_rn(fabs(b[k]), (double)H)),
                               fabs(c[k]));
    cp[k] = __dadd_rn(__dadd_rn(c[k], __dmul_rn(0x1p-21, s)), 1e-30);
  }
  // the corners: the lines i, j meeting at corner k
  const int ii[3] = {1, 2, 0}, jj[3] = {2, 0, 1};
  bool pos = true, neg = true, finite = true;
  double xlo = 0.0, xhi = 0.0, ylo = 0.0, yhi = 0.0;
  for (int k = 0; k < 3; ++k) {
    const double ai = a[ii[k]], bi = b[ii[k]], ci = cp[ii[k]];
    const double aj = a[jj[k]], bj = b[jj[k]], cj = cp[jj[k]];
    const double det = sub_rn(__dmul_rn(ai, bj), __dmul_rn(aj, bi));
    const double sdet = det == 0.0 ? 1.0 : det;
    const double x = __ddiv_rn(sub_rn(__dmul_rn(bi, cj), __dmul_rn(bj, ci)),
                               sdet);
    const double y = __ddiv_rn(sub_rn(__dmul_rn(aj, ci), __dmul_rn(ai, cj)),
                               sdet);
    // float64 error of the corners, padded far above its 1e-16 scale
    const double ex = __dadd_rn(
        1e-3, __ddiv_rn(__dmul_rn(1e-12, __dadd_rn(fabs(__dmul_rn(bi, cj)),
                                                   fabs(__dmul_rn(bj, ci)))),
                        fabs(sdet)));
    const double ey = __dadd_rn(
        1e-3, __ddiv_rn(__dmul_rn(1e-12, __dadd_rn(fabs(__dmul_rn(aj, ci)),
                                                   fabs(__dmul_rn(ai, cj)))),
                        fabs(sdet)));
    pos = pos && det > 0.0;
    neg = neg && det < 0.0;
    finite = finite && isfinite(x) && isfinite(y) && isfinite(ex)
             && isfinite(ey);
    const double x_lo = sub_rn(x, ex), x_hi = __dadd_rn(x, ex);
    const double y_lo = sub_rn(y, ey), y_hi = __dadd_rn(y, ey);
    xlo = k == 0 ? x_lo : fmin(xlo, x_lo);
    xhi = k == 0 ? x_hi : fmax(xhi, x_hi);
    ylo = k == 0 ? y_lo : fmin(ylo, y_lo);
    yhi = k == 0 ? y_hi : fmax(yhi, y_hi);
  }
  double x0, x1, y0, y1;
  if ((pos || neg) && finite) {
    x0 = ceil(sub_rn(xlo, 0.5));
    x1 = floor(sub_rn(xhi, 0.5));
    y0 = ceil(sub_rn(ylo, 0.5));
    y1 = floor(sub_rn(yhi, 0.5));
  } else {                                // the whole screen
    x0 = 0.0;
    x1 = (double)(W - 1);
    y0 = 0.0;
    y1 = (double)(H - 1);
  }
  // an edge of zero normal and a negative constant covers nothing
  bool none = false;
  for (int k = 0; k < 3; ++k)
    none = none || (a[k] == 0.0 && b[k] == 0.0 && c[k] < 0.0);
  if (none) {
    x0 = (double)W;
    x1 = -1.0;
  }
  const double w = (double)W, h = (double)H;
  out[i] = make_short4((short)fmin(fmax(x0, -1.0), w),
                       (short)fmin(fmax(x1, -1.0), w),
                       (short)fmin(fmax(y0, -1.0), h),
                       (short)fmin(fmax(y1, -1.0), h));
}

extern "C" int cull_boxes_launch(const float* table, void* out, int B,
                                 int nch, int chunk, int H, int W,
                                 void* stream) {
  if ((long)B * nch * chunk == 0) return 0;
  const dim3 grid((unsigned)(B * nch), (unsigned)((chunk + NT - 1) / NT));
  cull_boxes_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      table, (short4*)out, chunk, H, W);
  return (int)cudaGetLastError();
}

#define UB_WARPS 8

// fbox: (n_units * sub) face boxes, unit-major; ubox: (n_units) unions
__global__ void __launch_bounds__(UB_WARPS * 32)
unit_boxes_kernel(const short4* __restrict__ fbox, short4* __restrict__ ubox,
                  int n_units, int sub, int H, int W) {
  const int u = blockIdx.x * UB_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (u >= n_units) return;
  const short4* src = fbox + (size_t)u * sub;
  int x0 = W, x1 = -1, y0 = H, y1 = -1;
  for (int f = lane; f < sub; f += 32) {
    const short4 bx = src[f];
    if (bx.x <= bx.y && bx.z <= bx.w) {
      x0 = min(x0, (int)bx.x);
      x1 = max(x1, (int)bx.y);
      y0 = min(y0, (int)bx.z);
      y1 = max(y1, (int)bx.w);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    x0 = min(x0, __shfl_xor_sync(0xffffffffu, x0, o));
    x1 = max(x1, __shfl_xor_sync(0xffffffffu, x1, o));
    y0 = min(y0, __shfl_xor_sync(0xffffffffu, y0, o));
    y1 = max(y1, __shfl_xor_sync(0xffffffffu, y1, o));
  }
  if (lane == 0)
    ubox[u] = make_short4((short)x0, (short)x1, (short)y0, (short)y1);
}

extern "C" int unit_boxes_launch(const void* fbox, void* ubox, int n_units,
                                 int sub, int H, int W, void* stream) {
  if (n_units == 0) return 0;
  const int grid = (n_units + UB_WARPS - 1) / UB_WARPS;
  unit_boxes_kernel<<<grid, UB_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const short4*)fbox, (short4*)ubox, n_units, sub, H, W);
  return (int)cudaGetLastError();
}
