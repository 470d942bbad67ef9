// Tile visibility rasterizer for Hopper (sm_90a): K1, the default path's.
//
// Replaces the Pallas TPU kernel `_raster_kernel`
// (animals3d_tpu/ops/rasterize_pallas.py:153, launched by
// `_pallas_visibility` at :501). It computes what that kernel computes —
// per pixel, the nearest covering face (z, original id + 1, 0 =
// background) over the tile's bbox-overlapping face chunks walked front to
// back, with exact-z ties going to the smallest original id, the
// conservative z-min occlusion skip, and per-(image, tile, chunk) "took a
// pixel" flags — bit for bit as `visibility_reference` does, and none of
// its TPU machinery (no SMEM list cap with full-scan fallback, no packed
// id/mask words).
//
// Bound on the H100: the function's, as `chip_smoke.visibility_bound`
// counts it — the live sub-blocks' coefficients and ids read once, the
// outputs written once (bytes), against 12 float32 operations per live
// (face, pixel) pair whose face bbox holds the pixel (operations); bytes
// bind. The cull boxes this design reads are the design's traffic, not the
// function's, and are not in the bound.
//
// Design: one block per (16x32 tile, image), 1,280 blocks at full width,
// each of four consumer warps and one producer warp, ~25 KB of shared
// memory each, so that nearly all are resident at once: the walk is
// serial per tile, and the kernel lasts as long as its busiest tile.
//   * The walk is K1's: the tile's chunk list (`order`, `counts`), staged
//     in shared memory at the start with each chunk's z-min and sub-block
//     mask. A chunk is skipped when its quantized z-min is strictly behind
//     the quantized max of the tile's current z (K1's test, on the z max
//     after the previous chunk).
//   * A pixel's running winner is one 64-bit key in shared memory: the
//     order-preserving map of z (-0.0 read as +0.0, as float compares read
//     it), then the original id + 1, then a bit that remembers a -0.0 depth
//     (`test_pixel`, raster_tile.cuh). `atomicMin` keeps the lexicographic
//     minimum of (z, id), K1's rule, whatever the order of the atomics, so
//     the result is deterministic. A face takes a pixel only at z < BIG.
//     A chunk's flag is set when a key fell during the chunk: keys only
//     fall, so this is K1's "took".
//   * Work inside a live sub-block: each face's cull box (`fbox`, a bound
//     of every pixel centre its float32 edge tests can accept, made by
//     csrc/cull_boxes.cu) is clipped to the tile. The four consumer warps
//     take the faces in turn, a face a lane (the faces of a 32-face Morton
//     block meet the same tiles, so this spreads them over the warps). A
//     warp's exclusive scan of its faces' clipped areas (warp shuffles)
//     flattens their (face, pixel) pairs, and its lanes stride over them,
//     each finding its face by a binary search over the lanes' scan. A
//     face of more than 128 pixels in the tile is copied to a block list
//     instead, and at the chunk's end all 128 consumer threads stride over
//     the list's flattened pairs (its scan in one shared-memory pass): a
//     face as large as the tile no longer holds one thread, or one warp,
//     while the rest wait. A sub-block costs no block barrier; the warps
//     meet only at each chunk's end, for the large faces, its flag and the
//     new z max.
//   * Staging: the producer warp brings each live sub-block's 12
//     coefficient rows (each `sub` contiguous floats of `table`) into a
//     ring of shared-memory slots by one tensor copy (`cp.async.bulk.tensor`
//     of a 12 x sub box, the table seen as rows of `chunk` floats), and its
//     original ids and boxes by two bulk copies (`cp.async.bulk`), all
//     completing on the slot's `full` mbarrier; in walk order, as soon as
//     every consumer warp has released the slot (its `empty` mbarrier): a
//     chunk's remaining sub-blocks and then the next chunks' first ones,
//     before their skip is decided. A chunk already known to be skipped
//     (its z-min behind the max the consumers last published) gets no
//     load; loads of a chunk skipped later are released unread. A load
//     never changes a result. The copy engine takes requests one at a
//     time, so a sub-block costs three, not one a row. A sub-block wider
//     than a tensor box (256) takes a bulk copy a row; shapes whose rows
//     are not 16-byte aligned (chunk or sub-block not a multiple of 4
//     faces) are staged by the producer with plain loads, on the same
//     mbarriers. The ring's depth follows from shared memory (`smem_target`).
//   * Tensor cores do not apply: each edge test must round as
//     (a*px + b*py) + c in float32 with no fused multiply-add (the library
//     is built with -fmad=false) so that the kernel and its plain version
//     agree bit for bit; the TPU's MXU dot truncated its operands to bf16,
//     which is not the port's contract.
// The walk is `tile_walk` in raster_tile.cuh, which K2 (raster_vis_v4.cu)
// shares: K1 is its kernel `tile_walk_kernel<false>`, the ids staged.
// What is left above the bound: the busiest tile's ~400 live sub-blocks
// one after another, each a dependent chain of shared-memory loads,
// shuffles and an atomic per warp; the copy engine's time per request,
// which the producer pays at every sub-block and which the resident blocks
// of an SM share; the boxes (8 bytes a face) and every face of a live
// sub-block are read, not only those that cover a pixel.

#include "raster_tile.cuh"

// Shared memory the kernel needs with a ring of one slot (bytes); the
// wrapper refuses shapes above the card's 227 KB.
extern "C" long raster_vis_smem(int chunk, int nsub, int nch) {
  return walk_smem<false>(chunk, nsub, nch);
}

extern "C" int raster_vis_launch(const float* table, const int* orig,
                                 const int* order, const int* counts,
                                 const int* masks, const int* zlo,
                                 const void* fbox, float* z_out, int* id_out,
                                 unsigned char* flags, int B, int T, int ntx,
                                 int nch, int chunk, int nsub, int H, int W,
                                 int smem_target, void* stream) {
  return launch_walk<false>(table, orig, order, counts, masks, zlo, fbox,
                            z_out, id_out, flags, B, T, ntx, nch, chunk, nsub,
                            H, W, smem_target, stream);
}
