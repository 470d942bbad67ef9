// Tile visibility rasterizer for Hopper (sm_90a): K2, variant 4.
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
// What the TPU kernel does that K1 does not: it never copies the ids. The
// Morton sort of the prep permutes runs of 32 consecutive face ids
// (`bbase = perm * blk`, rasterize_pallas.py:904), so the original id of
// sorted slot s is bbase[s / 32] + s % 32, and a sub-block's id column is
// rebuilt from its run bases plus an iota (:369-375).
//
// Design: K1's walk as it stands (`tile_walk` in raster_tile.cuh; see
// raster_vis.cu's note): one block per (16x32 tile, image), a producer
// warp staging each live sub-block into a shared-memory ring on mbarriers,
// four consumer warps flattening each face's cull box in the tile into
// (face, pixel) pairs, large faces over the whole block, each pixel's
// winner a 64-bit (z, id) key kept by atomicMin. With the trait of
// `_raster_kernel_v4`: the ids are not staged. The producer issues two
// copy requests per live sub-block (the rows' tensor box, or a bulk copy a
// row above 256 faces; the boxes) instead of K1's three, and a slot holds
// 56 bytes a face instead of 60; the consumers read a face's id as
// bbase[(cid * chunk + g * sub + f) / 32] + f % 32 through the read-only
// cache (four ints per 128-face sub-block, from a 24 KB table at full
// width). A sub-block is whole runs: variant 4 needs sub % 32 == 0.
//
// Numerics: every affine function is evaluated as (a*px + b*py) + c with
// round-to-nearest multiplies and adds and no fused multiply-add (the
// library is built with -fmad=false), the operation order of K1 and of the
// plain version.
//
// Bound on the H100: K1's but for the ids — the live sub-blocks'
// coefficients and run bases (one int a 32-face run, not one a face) read
// once, the outputs written once; bytes (`chip_smoke.visibility_bound`
// with `run_ids`). What is left above it is K1's (raster_vis.cu), less
// the id copies.
//
// The kernel is `tile_walk_kernel<true>` of raster_tile.cuh.

#include "raster_tile.cuh"

// Shared memory the kernel needs with a ring of one slot (bytes); the
// wrapper refuses shapes above the card's 227 KB.
extern "C" long raster_vis_v4_smem(int chunk, int nsub, int nch) {
  return walk_smem<true>(chunk, nsub, nch);
}

// bbase: (nch * chunk / 32) the original id of each 32-slot run's first
// slot; the other arguments as raster_vis_launch's.
extern "C" int raster_vis_v4_launch(const float* table, const int* bbase,
                                    const int* order, const int* counts,
                                    const int* masks, const int* zlo,
                                    const void* fbox, float* z_out,
                                    int* id_out, unsigned char* flags, int B,
                                    int T, int ntx, int nch, int chunk,
                                    int nsub, int H, int W, int smem_target,
                                    void* stream) {
  return launch_walk<true>(table, bbase, order, counts, masks, zlo, fbox,
                           z_out, id_out, flags, B, T, ntx, nch, chunk, nsub,
                           H, W, smem_target, stream);
}
