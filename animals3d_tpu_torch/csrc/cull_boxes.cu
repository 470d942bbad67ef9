// Per-face cull boxes for the tile visibility kernels K1, K2 and K3, and
// in the same launch per-unit boxes for K3 (sm_90a).
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
// With kUnits (variant 6, `rasterize_cuda.cull_units`) the kernel also
// computes `rasterize_cuda.unit_boxes` of those boxes bit for bit, the XLA
// unit prep's counterpart (rasterize_pallas.py:837): per image and unit (a
// sub-block of `sub` consecutive slots of a chunk) the union of its
// faces' non-empty boxes, (W, -1, H, -1) where all are empty. A warp owns
// whole units, so no atomics, no shared memory and no block barrier are
// needed: floor(32 / sub) of them where sub < 32 (units never straddle
// two warps; the other lanes idle), else one, its lanes striding over the
// unit's slots (4 a lane at the full width's 128). The boxes are folded by
// integer min and max, one warp reduction (`__reduce_min_sync`) a
// coordinate over each unit's lanes.
//
// One thread per (image, slot), a block per 256 slots of one chunk (with
// the units, a block per its 8 warps' units): it reads the
// face's 9 edge coefficients (each row of the (B, nch, 12, chunk) table
// coalesced across the threads of a chunk), lifts them to float64 and
// follows the plain version's operations in its order, each rounded to
// nearest (__dmul_rn, __dadd_rn, __drcp_rn; the library is built with
// -fmad=false), so that no float64 table or temporary is ever stored.
// Each corner takes one correctly rounded reciprocal of its determinant
// and multiplies by it, for x, y and both pads.
//
// Bound on the H100: the table's 9 edge rows read once (36 bytes a face;
// the depth rows are not read) and the boxes written once (8 bytes a face,
// and 8 a unit); 1.97M faces at full width move 86.6 MB, 0.026 ms at 3.35
// TB/s. The float64 arithmetic the boxes need and the conversions to and
// from float64, at the card's rates for them, take less (`chip_smoke.py`,
// `cull_bound`).

#include <cuda_runtime.h>
#include <math.h>

static __device__ __forceinline__ double sub_rn(double a, double b) {
  return __dadd_rn(a, -b);
}

#define NT 256

// The clamped box (x0, x1, y0, y1) of the face whose 12 coefficient rows
// start at `src`, `chunk` floats apart.
static __device__ __forceinline__ int4 face_box(const float* __restrict__ src,
                                                int chunk, int H, int W) {
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
    const double r = __drcp_rn(det == 0.0 ? 1.0 : det);
    const double bc = __dmul_rn(bi, cj), cb = __dmul_rn(bj, ci);
    const double ac = __dmul_rn(aj, ci), ca = __dmul_rn(ai, cj);
    const double x = __dmul_rn(sub_rn(bc, cb), r);
    const double y = __dmul_rn(sub_rn(ac, ca), r);
    // float64 error of the corners, padded far above its 1e-16 scale
    const double ex = __dadd_rn(
        1e-3, __dmul_rn(__dmul_rn(1e-12, __dadd_rn(fabs(bc), fabs(cb))),
                        fabs(r)));
    const double ey = __dadd_rn(
        1e-3, __dmul_rn(__dmul_rn(1e-12, __dadd_rn(fabs(ac), fabs(ca))),
                        fabs(r)));
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
  // ceil and floor straight to int (one conversion each; out-of-range
  // values saturate, and the clamp to [-1, W] then gives the plain
  // version's clamp of the float64 value)
  int x0, x1, y0, y1;
  if ((pos || neg) && finite) {
    x0 = __double2int_ru(sub_rn(xlo, 0.5));
    x1 = __double2int_rd(sub_rn(xhi, 0.5));
    y0 = __double2int_ru(sub_rn(ylo, 0.5));
    y1 = __double2int_rd(sub_rn(yhi, 0.5));
  } else {                                // the whole screen
    x0 = 0;
    x1 = W - 1;
    y0 = 0;
    y1 = H - 1;
  }
  // an edge of zero normal and a negative constant covers nothing
  bool none = false;
  for (int k = 0; k < 3; ++k)
    none = none || (a[k] == 0.0 && b[k] == 0.0 && c[k] < 0.0);
  if (none) {
    x0 = W;
    x1 = -1;
  }
  return make_int4(min(max(x0, -1), W), min(max(x1, -1), W),
                   min(max(y0, -1), H), min(max(y1, -1), H));
}

static __device__ __forceinline__ int4 fold(int4 u, int4 v) {
  return make_int4(min(u.x, v.x), max(u.y, v.y), min(u.z, v.z),
                   max(u.w, v.w));
}

// table: (B, nch, 12, chunk) f32; fbox: (B, nch*chunk) boxes; ubox:
// (B, nch*chunk/sub) unit boxes (kUnits). Block (image * nch + chunk id,
// j) takes slots j*NT ... of that chunk; with kUnits a warp owns whole
// units, 32 / sub of them where sub < 32, else one, its lanes striding
// over the unit's slots, and block j the units of its warps.
// The blocks an SM must hold cap the registers a thread, so that enough
// warps are resident to hide the nine loads' latency: 48 for the face
// boxes alone (5 blocks; left free, the compiler takes 64, 3 blocks) and
// 64 for the fused launch (4 blocks; free, its loop over a unit's slots
// takes 72). Both run faster so on an H100 (PERF.md, section 6).
template <bool kUnits>
__global__ void __launch_bounds__(NT, kUnits ? 4 : 5)
cull_boxes_kernel(const float* __restrict__ table, short4* __restrict__ fbox,
                  short4* __restrict__ ubox, int chunk, int sub, int H,
                  int W) {
  const size_t bc = blockIdx.x;
  const float* rows = table + bc * 12 * chunk;
  short4* out = fbox + bc * chunk;
  if (!kUnits) {
    const int f = blockIdx.y * NT + threadIdx.x;
    if (f >= chunk) return;
    const int4 bx = face_box(rows + f, chunk, H, W);
    out[f] = make_short4((short)bx.x, (short)bx.y, (short)bx.z, (short)bx.w);
    return;
  }
  const int lane = threadIdx.x & 31;
  const int upw = sub < 32 ? 32 / sub : 1;         // units a warp
  const int wu = lane / sub;                       // the lane's unit
  const int u = (blockIdx.y * (NT / 32) + (threadIdx.x >> 5)) * upw + wu;
  const int nu = chunk / sub;
  const int first = wu * sub;                      // its first lane
  const bool live = wu < upw && u < nu;
  int4 acc = make_int4(W, -1, H, -1);
  if (live) {                                      // one pass: sub <= 32
    for (int f = u * sub + lane - first; f < (u + 1) * sub; f += 32) {
      const int4 bx = face_box(rows + f, chunk, H, W);
      out[f] = make_short4((short)bx.x, (short)bx.y, (short)bx.z,
                           (short)bx.w);
      if (bx.x <= bx.y && bx.z <= bx.w) acc = fold(acc, bx);
    }
  }
  // fold over the unit's lanes (the empty box is the fold's identity): one
  // warp reduction a coordinate, each unit's lanes with their own mask
  const unsigned mask = sub >= 32 ? 0xffffffffu
                                  : ((1u << sub) - 1) << first;
  acc = make_int4(__reduce_min_sync(mask, acc.x),
                  __reduce_max_sync(mask, acc.y),
                  __reduce_min_sync(mask, acc.z),
                  __reduce_max_sync(mask, acc.w));
  if (live && lane == first)
    ubox[bc * nu + u] = make_short4((short)acc.x, (short)acc.y,
                                    (short)acc.z, (short)acc.w);
}

// ubox == nullptr: the face boxes alone (variants 3 and 4); else the face
// and unit boxes of units of `sub` slots (variant 6; sub divides chunk).
extern "C" int cull_boxes_launch(const float* table, void* fbox, void* ubox,
                                 int B, int nch, int chunk, int sub, int H,
                                 int W, void* stream) {
  if ((long)B * nch * chunk == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ubox == nullptr) {
    const dim3 grid((unsigned)(B * nch), (unsigned)((chunk + NT - 1) / NT));
    cull_boxes_kernel<false><<<grid, NT, 0, st>>>(
        table, (short4*)fbox, nullptr, chunk, chunk, H, W);
  } else {
    const int per_block = (NT / 32) * (sub < 32 ? 32 / sub : 1);
    const int nu = chunk / sub;
    const dim3 grid((unsigned)(B * nch),
                    (unsigned)((nu + per_block - 1) / per_block));
    cull_boxes_kernel<true><<<grid, NT, 0, st>>>(
        table, (short4*)fbox, (short4*)ubox, chunk, sub, H, W);
  }
  return (int)cudaGetLastError();
}
