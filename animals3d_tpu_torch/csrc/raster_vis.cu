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

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define TILE_H 16
#define TILE_W 32
#define TP (TILE_H * TILE_W)
#define NT 128
#define NWARP (NT / 32)
#define MAX_RING 16
#define BIG 3.0e38f

static __device__ __forceinline__ int zq(float z) {
  z = fminf(fmaxf(z, -8.0f), 8.0f);
  return (int)floorf(z * 1048576.0f);
}

static __device__ __forceinline__ float affine(float a, float b, float c,
                                               float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, px), __fmul_rn(b, py)), c);
}

// order-preserving float -> unsigned map; -0.0 maps as +0.0
static __device__ __forceinline__ unsigned zkey(float z) {
  const unsigned u = __float_as_uint(z == 0.0f ? 0.0f : z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

static __device__ __forceinline__ float zval(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

static __host__ __device__ __forceinline__ size_t round16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

static __host__ __device__ __forceinline__ size_t round128(size_t n) {
  return (n + 127) & ~(size_t)127;
}

// a (sub x 12) box of the table seen as a 2-D tensor of rows of `chunk`
// floats, by the tensor memory accelerator, completing on `bar`
static __device__ __forceinline__ void tensor_load(void* dst,
                                                   const CUtensorMap* map,
                                                   int x, int y,
                                                   uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x),
      "r"(y)
      : "memory");
}

// A face whose clipped box holds more pixels than four passes of a warp's
// lanes is "large": its pairs go to the block's list, at most BIG_CAP a
// chunk.
#define BIG_AREA 128
#define BIG_CAP 32

// A large face, copied out of its slot so that the slot can be released.
struct BigFace {
  float c[12];
  int id, area;
  short4 box;
};

// Shared-memory layout, the same on host and device: fixed part (keys,
// chunk list, mbarriers, the slots' list positions) then `ring` slots of a
// sub-block each.
struct Layout {
  size_t key, cid, zl, mask, full, empty, qpos, coef, id, box, slot, total;
  __host__ __device__ Layout(int sub, int nch, int ring) {
    key = 0;
    cid = key + (size_t)TP * 8;
    zl = cid + round16((size_t)nch * 4);
    mask = zl + round16((size_t)nch * 4);
    full = mask + round16((size_t)nch * 2);
    empty = full + MAX_RING * 8;
    qpos = empty + MAX_RING * 8;
    // per slot, 128-byte aligned for the tensor copy: 12 rows of sub
    // floats, sub ids, sub boxes of 8 bytes
    coef = round128(qpos + MAX_RING * 4);
    id = (size_t)12 * sub * 4;
    box = id + round16((size_t)sub * 4);
    slot = round128(box + round16((size_t)sub * 8));
    total = coef + (size_t)ring * slot;
  }
};

static __device__ __forceinline__ int clipped_area(short4 bx, int tx0,
                                                   int ty0) {
  const int xa = max((int)bx.x, tx0), xb = min((int)bx.y, tx0 + TILE_W - 1);
  const int ya = max((int)bx.z, ty0), yb = min((int)bx.w, ty0 + TILE_H - 1);
  return (xa <= xb && ya <= yb) ? (xb - xa + 1) * (yb - ya + 1) : 0;
}

// the consumer warps' barrier (the producer warp does not take part)
static __device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// Pixel r (row-major) of a face's box clipped to the tile, tested against
// the face's coefficients c[row * stride]; the winner's key falls by
// atomicMin. Returns whether it fell.
static __device__ __forceinline__ bool test_pixel(
    const float* c, int stride, unsigned id, short4 bb, int r, int tx0,
    int ty0, const unsigned* magic, unsigned long long* keys) {
  const int xa = max((int)bb.x, tx0), xb = min((int)bb.y, tx0 + TILE_W - 1);
  const int ya = max((int)bb.z, ty0);
  const int w = xb - xa + 1;
  const int dy = (int)(((unsigned)r * magic[w]) >> 16);   // r / w
  const int y = ya + dy, x = xa + (r - dy * w);
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float e0 = affine(c[0], c[4 * stride], c[8 * stride], px, py);
  const float e1 = affine(c[stride], c[5 * stride], c[9 * stride], px, py);
  const float e2 = affine(c[2 * stride], c[6 * stride], c[10 * stride], px,
                          py);
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) return false;
  const float zz = affine(c[3 * stride], c[7 * stride], c[11 * stride], px,
                          py);
  if (!(zz < BIG)) return false;          // K1 takes only z < BIG
  const unsigned negz = (zz == 0.0f && (__float_as_uint(zz) >> 31)) ? 1u : 0u;
  const unsigned long long key =
      ((unsigned long long)zkey(zz) << 32) | ((id + 1u) << 1) | negz;
  return key < atomicMin(&keys[(y - ty0) * TILE_W + (x - tx0)], key);
}

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
  __shared__ BigFace s_big[BIG_CAP];
  __shared__ int s_bigstart[BIG_CAP + 1];
  __shared__ int s_nbig;
  __shared__ float s_wmax[NWARP];
  __shared__ int s_wany[NWARP];
  // ceil(2^16 / w) for w = 1 ... 32: r / w = (r * magic[w]) >> 16 for
  // 0 <= r < 512, the pixels of a box clipped to the tile
  __shared__ unsigned s_magic[TILE_W + 1];
  __shared__ volatile int s_zq;      // the consumers' zq_max, for the producer
  const int sub = chunk / nsub;
  const Layout L(sub, nch, ring);
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
  if (tid <= TILE_W) s_magic[tid] = tid ? (65536u + tid - 1) / tid : 0u;
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
    s_nbig = 0;
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
      const int cid = s_cid[pk];
      unsigned char* slot = smem + L.coef + (size_t)s * L.slot;
      float* dc = reinterpret_cast<float*>(slot);
      int* di = reinterpret_cast<int*>(slot + L.id);
      short4* db = reinterpret_cast<short4*>(slot + L.box);
      const float* src = table + ((size_t)b * nch + cid) * 12 * chunk
                         + (size_t)g * sub;
      const int* isrc = orig + (size_t)cid * chunk + (size_t)g * sub;
      const short4* bsrc = fbox + ((size_t)b * nch + cid) * chunk
                           + (size_t)g * sub;
      if (mode) {
        // the consumers' generic reads of this slot are ordered before the
        // copy engine's writes; the expected bytes before any copy lands
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (lane == 0)
          mbar_expect_tx(full + s, (unsigned)(sub * (12 * 4 + 4 + 8)));
        __syncwarp();
        // each copy is one request to the copy engine, which takes them
        // one at a time: the 12 rows as one tensor box where the box fits
        // (mode 2), else a copy a row
        if (lane == 0 && mode == 2)
          tensor_load(dc, &rows, g * sub, (b * nch + cid) * 12, full + s);
        else if (lane < 12 && mode == 1)
          bulk_load(dc + (size_t)lane * sub, src + (size_t)lane * chunk,
                    (unsigned)sub * 4, full + s);
        else if (lane == 12)
          bulk_load(di, isrc, (unsigned)sub * 4, full + s);
        else if (lane == 13)
          bulk_load(db, bsrc, (unsigned)sub * 8, full + s);
      } else if (lane == 0) {
        for (int r = 0; r < 12; ++r)
          for (int f = 0; f < sub; ++f)
            dc[(size_t)r * sub + f] = src[(size_t)r * chunk + f];
        for (int f = 0; f < sub; ++f) {
          di[f] = isrc[f];
          db[f] = bsrc[f];
        }
        mbar_arrive(full + s);
      }
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
      const unsigned char* slot = smem + L.coef + (size_t)s * L.slot;
      const float* cf = reinterpret_cast<const float*>(slot);
      const int* ids = reinterpret_cast<const int*>(slot + L.id);
      const short4* bx = reinterpret_cast<const short4*>(slot + L.box);
      // the warps take the faces in turn, a face a lane, so that the
      // faces of one 32-face Morton block, which tend to meet the same
      // tile, spread over the warps
      for (int base = 0; base < sub; base += NT) {
        const int f = base + lane * NWARP + warp;
        const short4 bb = f < sub ? bx[f] : make_short4(0, -1, 0, -1);
        int a = clipped_area(bb, tx0, ty0);
        if (a > BIG_AREA) {
          // a large face: its pairs go to the block at the chunk's end
          const int e = atomicAdd(&s_nbig, 1);
          if (e < BIG_CAP) {
            for (int r = 0; r < 12; ++r) s_big[e].c[r] = cf[r * sub + f];
            s_big[e].id = ids[f];
            s_big[e].area = a;
            s_big[e].box = bb;
            a = 0;
          }
        }
        // the warp's exclusive scan of the areas; its lanes stride over
        // the warp's flattened (face, pixel) pairs
        int inc = a;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += v;
        }
        const int total = __shfl_sync(0xffffffffu, inc, 31);
        const int start = inc - a;
        for (int p0 = 0; p0 < total; p0 += 32) {
          const int p = p0 + lane;
          int src = 0;             // the last lane whose pairs start <= p
          for (int step = 16; step > 0; step >>= 1) {
            const int v = __shfl_sync(0xffffffffu, start, src + step);
            if (v <= p) src += step;
          }
          const int r = p - __shfl_sync(0xffffffffu, start, src);
          const int fs = base + src * NWARP + warp;
          if (p < total &&
              test_pixel(cf + fs, sub, (unsigned)ids[fs], bx[fs], r, tx0, ty0,
                         s_magic, s_key))
            took = 1;
        }
      }
      __syncwarp();      // this warp is done with the slot
      if (lane == 0) mbar_arrive(empty + s);
    }
    consumers_sync();    // every sub-block of the chunk is done
    const int nbig = min(s_nbig, BIG_CAP);
    if (nbig > 0) {
      // the large faces' pairs flattened over the whole block
      if (warp == 0) {
        const int a = lane < nbig ? s_big[lane].area : 0;
        int inc = a;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, inc, o);
          if (lane >= o) inc += v;
        }
        s_bigstart[lane] = inc - a;
        if (lane == 31) s_bigstart[BIG_CAP] = inc;
      }
      consumers_sync();
      const int total = s_bigstart[BIG_CAP];
      int e = 0;
      for (int i = tid; i < total; i += NT) {
        int hi = nbig - 1;
        while (e < hi) {
          const int mid = (e + hi + 1) >> 1;
          if (s_bigstart[mid] <= i) e = mid; else hi = mid - 1;
        }
        if (test_pixel(s_big[e].c, 1, (unsigned)s_big[e].id, s_big[e].box,
                       i - s_bigstart[e], tx0, ty0, s_magic, s_key))
          took = 1;
      }
      consumers_sync();
    }
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
    if (tid == 0) s_nbig = 0;
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
  for (int i = tid; i < TP; i += NT) {
    const unsigned long long key = s_key[i];
    const unsigned lo = (unsigned)key;
    const int id = (int)(lo >> 1);
    const float z = (lo & 1u) ? -0.0f : zval((unsigned)(key >> 32));
    const size_t o = (size_t)b * H * W + (size_t)(ty0 + i / TILE_W) * W
                     + tx0 + i % TILE_W;
    z_out[o] = id > 0 ? z : 0.0f;
    id_out[o] = id;
  }
}

// Shared memory the kernel needs with a ring of one slot (bytes); the
// wrapper refuses shapes above the card's 227 KB.
extern "C" long raster_vis_smem(int chunk, int nsub, int nch) {
  return (long)Layout(chunk / nsub, nch, 1).total;
}

// cuTensorMapEncodeTiled of the CUDA driver API, looked up through the
// runtime, so that the library links the runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
  // bulk copies need 16-byte aligned sources and sizes (mode 1); a tensor
  // box is at most 256 elements a side (mode 2); else plain loads (mode 0)
  int mode = chunk % 4 == 0 && sub % 4 == 0
             && ((uintptr_t)table | (uintptr_t)orig | (uintptr_t)fbox)
                % 16 == 0;
  CUtensorMap rows;
  memset(&rows, 0, sizeof(rows));
  if (mode && sub <= 256) {
    EncodeTiled encode = encode_tiled();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dim[2] = {(cuuint64_t)chunk, (cuuint64_t)B * nch * 12};
    const cuuint64_t stride[1] = {(cuuint64_t)chunk * 4};
    const cuuint32_t box[2] = {(cuuint32_t)sub, 12};
    const cuuint32_t step[2] = {1, 1};
    if (encode(&rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)table, dim,
               stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
    mode = 2;
  }
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
