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
//     (K2's key, raster_vis_v4.cu). `atomicMin` keeps the lexicographic
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
// What is left above the bound: the busiest tile's ~400 live sub-blocks
// one after another, each a dependent chain of shared-memory loads,
// shuffles and an atomic per warp; the copy engine's time per request,
// which the producer pays at every sub-block and which the resident blocks
// of an SM share; the boxes (8 bytes a face) and every face of a live
// sub-block are read, not only those that cover a pixel.

#include "raster_tile.cuh"

// Shared-memory layout, the same on host and device: fixed part (keys,
// chunk list, mbarriers, the slots' list positions) then `ring` slots of a
// sub-block each (`SlotLayout`).
struct Layout {
  size_t key, cid, zl, mask, full, empty, qpos, coef, total;
  __host__ __device__ Layout(int sub, int nch, int ring) {
    key = 0;
    cid = key + (size_t)TP * 8;
    zl = cid + round16((size_t)nch * 4);
    mask = zl + round16((size_t)nch * 4);
    full = mask + round16((size_t)nch * 2);
    empty = full + MAX_RING * 8;
    qpos = empty + MAX_RING * 8;
    coef = round128(qpos + MAX_RING * 4);
    total = coef + (size_t)ring * SlotLayout(sub).bytes;
  }
};

// table: (B, nch, 12, chunk) rows a0 a1 a2 az b0 b1 b2 bz c0 c1 c2 cz
// orig: (nch*chunk) original face id of each sorted slot
// order, masks: (B, T, nch); counts: (B, T); zlo: (B, nch)
// fbox: (B, nch*chunk) pixel ranges x0 x1 y0 y1 per sorted slot
// z_out, id_out: (B, H, W); flags: (B, T, nch), zero-filled by the caller
// rows: the table as (B*nch*12, chunk) for the tensor copy (mode 2)
__global__ void __launch_bounds__(NT + 32)
raster_vis_kernel(const __grid_constant__ CUtensorMap rows,
                  const float* __restrict__ table,
                  const int* __restrict__ orig,
                  const int* __restrict__ order,
                  const int* __restrict__ counts,
                  const int* __restrict__ masks,
                  const int* __restrict__ zlo,
                  const short4* __restrict__ fbox,
                  float* __restrict__ z_out, int* __restrict__ id_out,
                  unsigned char* __restrict__ flags, int T, int ntx,
                  int nch, int chunk, int nsub, int H, int W, int ring,
                  int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ BigList s_big;
  __shared__ float s_wmax[NWARP];
  __shared__ int s_wany[NWARP];
  __shared__ unsigned s_magic[TILE_W + 1];
  __shared__ volatile int s_zq;      // the consumers' zq_max, for the producer
  const int sub = chunk / nsub;
  const Layout L(sub, nch, ring);
  const SlotLayout SL(sub);
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + L.key);
  int* s_cid = reinterpret_cast<int*>(smem + L.cid);
  int* s_zl = reinterpret_cast<int*>(smem + L.zl);
  unsigned short* s_mask = reinterpret_cast<unsigned short*>(smem + L.mask);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L.empty);
  volatile int* s_qpos = reinterpret_cast<volatile int*>(smem + L.qpos);

  const int t = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t bt = (size_t)b * T + t;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx0 = (t % ntx) * TILE_W, ty0 = (t / ntx) * TILE_H;
  const int n = counts[bt];
  const unsigned long long empty_key = (unsigned long long)zkey(BIG) << 32;
  for (int i = tid; i < TP; i += NT + 32) s_key[i] = empty_key;
  if (tid <= TILE_W) s_magic[tid] = magic_of(tid);
  const unsigned allbits = (1u << nsub) - 1u;
  for (int k = tid; k < n; k += NT + 32) {
    const int cid = order[bt * nch + k];
    s_cid[k] = cid;
    s_zl[k] = zlo[(size_t)b * nch + cid];
    s_mask[k] = (unsigned short)((unsigned)masks[bt * nch + cid]
                                 & allbits);
  }
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWARP);
    }
    s_zq = zq(BIG);
    s_big.n = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWARP) {
    // ---- the producer warp walks the load sequence; lane r issues copy r
    int pk = 0;
    unsigned pm = n > 0 ? s_mask[0] : 0u;
    for (int q = 0;; ++q) {
      const int s = q % ring;
      // the slot's previous load released by every consumer warp (a fresh
      // barrier passes the first round)
      mbar_wait(empty + s, (unsigned)(((q / ring) & 1) ^ 1));
      const int zq_max = __shfl_sync(0xffffffffu, s_zq, 0);
      while (pk < n && (pm == 0 || s_zl[pk] > zq_max)) {
        ++pk;
        pm = pk < n ? s_mask[pk] : 0u;
      }
      if (pk >= n) {              // the end of the sequence
        if (lane == 0) {
          s_qpos[s] = n;
          mbar_arrive(full + s);
        }
        return;
      }
      const int g = __ffs(pm) - 1;
      pm &= pm - 1;
      if (lane == 0) s_qpos[s] = pk;
      stage_subblock(smem + L.coef + (size_t)s * SL.bytes, SL, full + s,
                     &rows, table, orig, fbox, b, nch, chunk, sub, s_cid[pk],
                     g, mode, lane);
    }
  }

  // ---- the consumers: four warps, in step at each chunk's end ----
  int zq_max = zq(BIG);
  int q = 0;                             // the next load of the sequence
  for (int k = 0; k < n; ++k) {
    const unsigned mk = s_mask[k];
    if (s_zl[k] > zq_max || mk == 0) {
      // skipped (flag stays 0): release the loads issued for it, unread
      for (;; ++q) {
        const int s = q % ring;
        mbar_wait(full + s, (unsigned)((q / ring) & 1));
        if (s_qpos[s] != k) break;
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
      continue;
    }
    int took = 0;
    for (unsigned m = mk; m; m &= m - 1, ++q) {
      const int s = q % ring;
      mbar_wait(full + s, (unsigned)((q / ring) & 1));
      took |= consume_subblock(smem + L.coef + (size_t)s * SL.bytes, SL, sub,
                               tx0, ty0, lane, warp, s_big, s_magic, s_key);
      __syncwarp();      // this warp is done with the slot
      if (lane == 0) mbar_arrive(empty + s);
    }
    consumers_sync();    // every sub-block of the chunk is done
    took |= consume_big(s_big, tid, lane, warp, tx0, ty0, s_magic, s_key);
    // the chunk's flag and the tile's new z max
    float v = -BIG;
    for (int i = tid; i < TP; i += NT)
      v = fmaxf(v, zval((unsigned)(s_key[i] >> 32)));
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int any = __any_sync(0xffffffffu, took);
    if (lane == 0) {
      s_wmax[warp] = v;
      s_wany[warp] = any;
    }
    if (tid == 0) s_big.n = 0;
    consumers_sync();
    float zmax = s_wmax[0];
    int anyb = s_wany[0];
    for (int w = 1; w < NWARP; ++w) {
      zmax = fmaxf(zmax, s_wmax[w]);
      anyb |= s_wany[w];
    }
    zq_max = zq(zmax);
    if (tid == 0) {
      s_zq = zq_max;
      if (anyb) flags[bt * nch + s_cid[k]] = 1;
    }
  }
  for (int i = tid; i < TP; i += NT)
    write_pixel(s_key[i], i, b, tx0, ty0, H, W, z_out, id_out);
}

// Shared memory the kernel needs with a ring of one slot (bytes); the
// wrapper refuses shapes above the card's 227 KB.
extern "C" long raster_vis_smem(int chunk, int nsub, int nch) {
  return (long)Layout(chunk / nsub, nch, 1).total;
}

extern "C" int raster_vis_launch(const float* table, const int* orig,
                                 const int* order, const int* counts,
                                 const int* masks, const int* zlo,
                                 const void* fbox, float* z_out, int* id_out,
                                 unsigned char* flags, int B, int T, int ntx,
                                 int nch, int chunk, int nsub, int H, int W,
                                 int smem_target, void* stream) {
  // as many ring slots as fit in `smem_target` bytes, one at least
  const int sub = chunk / nsub;
  const size_t fixed = Layout(sub, nch, 0).total;
  const size_t slot = Layout(sub, nch, 1).total - fixed;
  const size_t target = (size_t)smem_target;
  int ring = (int)((target > fixed ? target - fixed : 0) / slot);
  ring = ring < 1 ? 1 : (ring > MAX_RING ? MAX_RING : ring);
  while (ring > 1 && Layout(sub, nch, ring).total > 227 * 1024) --ring;
  const size_t smem = Layout(sub, nch, ring).total;
  CUtensorMap rows;
  int err = 0;
  const int mode = staging_mode(&rows, table, orig, fbox, B, nch, chunk, sub,
                                &err);
  if (mode < 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      raster_vis_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(raster_vis_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  raster_vis_kernel<<<dim3(T, B), NT + 32, smem, (cudaStream_t)stream>>>(
      rows, table, orig, order, counts, masks, zlo, (const short4*)fbox,
      z_out, id_out, flags, T, ntx, nch, chunk, nsub, H, W, ring, mode);
  return (int)cudaGetLastError();
}
