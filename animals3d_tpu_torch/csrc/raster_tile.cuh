// Device helpers of the tile visibility kernels K1 (raster_vis.cu), K2
// (raster_vis_v4.cu) and K3 (raster_vis_v6.cu), for Hopper (sm_90a): the
// block shape (four consumer warps and one producer warp per 16x32 tile),
// the 64-bit (z, id) pixel key, the mbarrier and bulk-copy wrappers, the
// producer's staging of one sub-block into a shared-memory ring slot, the
// consumer warps' flattening of a staged sub-block's (face, pixel) pairs,
// the block's pass over the large faces, and the chunk-list walk that K1
// and K2 share (`tile_walk`, `launch_walk`). `raster_vis.cu`'s note
// describes the design.

#pragma once

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
// lanes is "large": its pairs go to the block's list, at most BIG_CAP
// between two passes over the list.
#define BIG_AREA 128
#define BIG_CAP 32

// A large face, copied out of its slot so that the slot can be released.
struct BigFace {
  float c[12];
  int id, area;
  short4 box;
};

// The per-block state of the large faces' list, in static shared memory.
struct BigList {
  BigFace face[BIG_CAP];
  int start[BIG_CAP + 1];
  int n;
};

// One ring slot, 128-byte aligned for the tensor copy: 12 rows of sub
// floats, sub ids (none where the ids are rebuilt from run bases, K2), sub
// boxes of 8 bytes. `id` and `box` are offsets in the slot, `bytes` its
// size.
struct SlotLayout {
  size_t id, box, bytes;
  __host__ __device__ explicit SlotLayout(int sub, bool ids = true) {
    id = (size_t)12 * sub * 4;
    box = id + (ids ? round16((size_t)sub * 4) : 0);
    bytes = round128(box + round16((size_t)sub * 8));
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

// ceil(2^16 / w) for w = 1 ... 32: r / w = (r * magic[w]) >> 16 for
// 0 <= r < 512, the pixels of a box clipped to the tile
static __device__ __forceinline__ unsigned magic_of(int w) {
  return w ? (65536u + w - 1) / w : 0u;
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

// The producer warp stages sub-block g of chunk cid of image b into a ring
// slot, completing on `full`: mode 2, the 12 rows as one tensor box (lane
// 0); mode 1, a bulk copy a row (lanes 0-11); both with the ids (kIds;
// K2 rebuilds them instead) and boxes by one bulk copy each (lanes 12,
// 13); mode 0, plain loads by lane 0. Each copy is one request to the
// copy engine, which takes them one at a time.
template <bool kIds = true>
static __device__ __forceinline__ void stage_subblock(
    unsigned char* slot, const SlotLayout& S, uint64_t* full,
    const CUtensorMap* rows, const float* __restrict__ table,
    const int* __restrict__ orig, const short4* __restrict__ fbox, int b,
    int nch, int chunk, int sub, int cid, int g, int mode, int lane) {
  float* dc = reinterpret_cast<float*>(slot);
  int* di = reinterpret_cast<int*>(slot + S.id);
  short4* db = reinterpret_cast<short4*>(slot + S.box);
  const float* src = table + ((size_t)b * nch + cid) * 12 * chunk
                     + (size_t)g * sub;
  const int* isrc = kIds ? orig + (size_t)cid * chunk + (size_t)g * sub
                         : nullptr;
  const short4* bsrc = fbox + ((size_t)b * nch + cid) * chunk
                       + (size_t)g * sub;
  if (mode) {
    // the consumers' generic reads of this slot are ordered before the
    // copy engine's writes; the expected bytes before any copy lands
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0)
      mbar_expect_tx(full, (unsigned)(sub * (12 * 4 + (kIds ? 4 : 0) + 8)));
    __syncwarp();
    if (lane == 0 && mode == 2)
      tensor_load(dc, rows, g * sub, (b * nch + cid) * 12, full);
    else if (lane < 12 && mode == 1)
      bulk_load(dc + (size_t)lane * sub, src + (size_t)lane * chunk,
                (unsigned)sub * 4, full);
    else if (kIds && lane == 12)
      bulk_load(di, isrc, (unsigned)sub * 4, full);
    else if (lane == 13)
      bulk_load(db, bsrc, (unsigned)sub * 8, full);
  } else if (lane == 0) {
    for (int r = 0; r < 12; ++r)
      for (int f = 0; f < sub; ++f)
        dc[(size_t)r * sub + f] = src[(size_t)r * chunk + f];
    for (int f = 0; f < sub; ++f) {
      if (kIds) di[f] = isrc[f];
      db[f] = bsrc[f];
    }
    mbar_arrive(full);
  }
}

// The original ids of a staged sub-block's faces, by face f of the
// sub-block: copied into the slot (K1, K3) ...
struct StagedIds {
  const int* ids;
  __device__ __forceinline__ int operator()(int f) const { return ids[f]; }
};

// ... or rebuilt (K2): the Morton order permutes runs of 32 consecutive
// ids, so sorted slot s holds bbase[s / 32] + s % 32. slot0, the
// sub-block's first slot, is a multiple of 32; the run bases come through
// the read-only cache.
struct RunIds {
  const int* __restrict__ bbase;
  int slot0;
  __device__ __forceinline__ int operator()(int f) const {
    return __ldg(bbase + ((slot0 + f) >> 5)) + (f & 31);
  }
};

// A consumer warp's pass over a staged sub-block: the warps take the
// faces in turn, a face a lane, so that the faces of one 32-face Morton
// block, which tend to meet the same tile, spread over the warps. A warp's
// exclusive scan of its faces' clipped areas flattens their (face, pixel)
// pairs, and its lanes stride over them; a large face goes to the block's
// list instead. `ids` gives a face's original id. Returns whether a key
// fell at this lane.
template <class Ids>
static __device__ __forceinline__ int consume_subblock(
    const unsigned char* slot, const SlotLayout& S, int sub, const Ids& ids,
    int tx0, int ty0, int lane, int warp, BigList& big,
    const unsigned* magic, unsigned long long* keys) {
  const float* cf = reinterpret_cast<const float*>(slot);
  const short4* bx = reinterpret_cast<const short4*>(slot + S.box);
  int took = 0;
  for (int base = 0; base < sub; base += NT) {
    const int f = base + lane * NWARP + warp;
    const short4 bb = f < sub ? bx[f] : make_short4(0, -1, 0, -1);
    int a = clipped_area(bb, tx0, ty0);
    if (a > BIG_AREA) {
      // a large face: its pairs go to the block at the next pass
      const int e = atomicAdd(&big.n, 1);
      if (e < BIG_CAP) {
        for (int r = 0; r < 12; ++r) big.face[e].c[r] = cf[r * sub + f];
        big.face[e].id = ids(f);
        big.face[e].area = a;
        big.face[e].box = bb;
        a = 0;
      }
    }
    // the warp's exclusive scan of the areas; its lanes stride over the
    // warp's flattened (face, pixel) pairs
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
          test_pixel(cf + fs, sub, (unsigned)ids(fs), bx[fs], r, tx0, ty0,
                     magic, keys))
        took = 1;
    }
  }
  return took;
}

// The same pass with the ids staged in the slot.
static __device__ __forceinline__ int consume_subblock(
    const unsigned char* slot, const SlotLayout& S, int sub, int tx0,
    int ty0, int lane, int warp, BigList& big, const unsigned* magic,
    unsigned long long* keys) {
  const StagedIds ids{reinterpret_cast<const int*>(slot + S.id)};
  return consume_subblock(slot, S, sub, ids, tx0, ty0, lane, warp, big,
                          magic, keys);
}

// The large faces' pairs flattened over the whole block (its scan in one
// shared-memory pass), after a consumers_sync that ends the sub-blocks
// whose large faces are listed. The caller empties the list afterwards.
// Returns whether a key fell at this thread.
static __device__ __forceinline__ int consume_big(
    BigList& big, int tid, int lane, int warp, int tx0, int ty0,
    const unsigned* magic, unsigned long long* keys) {
  const int nbig = min(big.n, BIG_CAP);
  int took = 0;
  if (nbig > 0) {
    if (warp == 0) {
      const int a = lane < nbig ? big.face[lane].area : 0;
      int inc = a;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      big.start[lane] = inc - a;
      if (lane == 31) big.start[BIG_CAP] = inc;
    }
    consumers_sync();
    const int total = big.start[BIG_CAP];
    int e = 0;
    for (int i = tid; i < total; i += NT) {
      int hi = nbig - 1;
      while (e < hi) {
        const int mid = (e + hi + 1) >> 1;
        if (big.start[mid] <= i) e = mid; else hi = mid - 1;
      }
      if (test_pixel(big.face[e].c, 1, (unsigned)big.face[e].id,
                     big.face[e].box, i - big.start[e], tx0, ty0, magic,
                     keys))
        took = 1;
    }
    consumers_sync();
  }
  return took;
}

// A tile's key at pixel i (row-major) written out as z (0 on background)
// and face_id (original id + 1, 0 = background); a -0.0 depth is kept.
static __device__ __forceinline__ void write_pixel(
    unsigned long long key, int i, int b, int tx0, int ty0, int H, int W,
    float* __restrict__ z_out, int* __restrict__ id_out) {
  const unsigned lo = (unsigned)key;
  const int id = (int)(lo >> 1);
  const float z = (lo & 1u) ? -0.0f : zval((unsigned)(key >> 32));
  const size_t o = (size_t)b * H * W + (size_t)(ty0 + i / TILE_W) * W
                   + tx0 + i % TILE_W;
  z_out[o] = id > 0 ? z : 0.0f;
  id_out[o] = id;
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

// The staging mode for a table of B * nch chunks of 12 rows of `chunk`
// floats, and its tensor map where the mode is 2: bulk copies need
// 16-byte aligned sources and sizes (mode 1); a tensor box is at most 256
// elements a side (mode 2); else plain loads (mode 0). Returns -1 with
// `*err` set where the driver cannot encode the map.
static int staging_mode(CUtensorMap* rows, const float* table,
                        const void* orig, const void* fbox, int B, int nch,
                        int chunk, int sub, int* err) {
  int mode = chunk % 4 == 0 && sub % 4 == 0
             && ((uintptr_t)table | (uintptr_t)orig | (uintptr_t)fbox)
                % 16 == 0;
  memset(rows, 0, sizeof(*rows));
  if (mode && sub <= 256) {
    EncodeTiled encode = encode_tiled();
    if (!encode) {
      *err = (int)cudaErrorNotSupported;
      return -1;
    }
    const cuuint64_t dim[2] = {(cuuint64_t)chunk, (cuuint64_t)B * nch * 12};
    const cuuint64_t stride[1] = {(cuuint64_t)chunk * 4};
    const cuuint32_t box[2] = {(cuuint32_t)sub, 12};
    const cuuint32_t step[2] = {1, 1};
    if (encode(rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)table, dim,
               stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      *err = (int)cudaErrorInvalidValue;
      return -1;
    }
    mode = 2;
  }
  return mode;
}

// K1's and K2's shared-memory layout, the same on host and device: fixed
// part (keys, chunk list, mbarriers, the slots' list positions) then
// `ring` slots of a sub-block each (`SlotLayout`; without ids for K2).
struct Layout {
  size_t key, cid, zl, mask, full, empty, qpos, coef, total;
  __host__ __device__ Layout(int sub, int nch, int ring, bool ids = true) {
    key = 0;
    cid = key + (size_t)TP * 8;
    zl = cid + round16((size_t)nch * 4);
    mask = zl + round16((size_t)nch * 4);
    full = mask + round16((size_t)nch * 2);
    empty = full + MAX_RING * 8;
    qpos = empty + MAX_RING * 8;
    coef = round128(qpos + MAX_RING * 4);
    total = coef + (size_t)ring * SlotLayout(sub, ids).bytes;
  }
};

// The chunk-list walk of one (16x32 tile, image) block, K1's design (see
// raster_vis.cu): a producer warp stages the live sub-blocks into a ring
// of slots ahead of the consumers, four consumer warps test each face on
// its cull box and meet at every chunk's end for the large faces, the
// chunk's flag and the tile's new z max. kRuns (K2): `ids` holds the run
// bases `bbase` and the consumers rebuild each face's original id from
// them (`RunIds`), so a sub-block takes two copy requests (rows, boxes);
// else `ids` is `orig`, staged with the rows (three requests).
// table: (B, nch, 12, chunk) rows a0 a1 a2 az b0 b1 b2 bz c0 c1 c2 cz
// ids: orig (nch*chunk), the original face id of each sorted slot, or
//      bbase (nch*chunk/32), the original id of each 32-slot run's first
// order, masks: (B, T, nch); counts: (B, T); zlo: (B, nch)
// fbox: (B, nch*chunk) pixel ranges x0 x1 y0 y1 per sorted slot
// z_out, id_out: (B, H, W); flags: (B, T, nch), zero-filled by the caller
// rows: the table as (B*nch*12, chunk) for the tensor copy (mode 2)
template <bool kRuns>
static __device__ __forceinline__ void tile_walk(
    const CUtensorMap* rows, const float* __restrict__ table,
    const int* __restrict__ ids, const int* __restrict__ order,
    const int* __restrict__ counts, const int* __restrict__ masks,
    const int* __restrict__ zlo, const short4* __restrict__ fbox,
    float* __restrict__ z_out, int* __restrict__ id_out,
    unsigned char* __restrict__ flags, int T, int ntx, int nch, int chunk,
    int nsub, int H, int W, int ring, int mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ BigList s_big;
  __shared__ float s_wmax[NWARP];
  __shared__ int s_wany[NWARP];
  __shared__ unsigned s_magic[TILE_W + 1];
  __shared__ volatile int s_zq;      // the consumers' zq_max, for the producer
  const int sub = chunk / nsub;
  const Layout L(sub, nch, ring, !kRuns);
  const SlotLayout SL(sub, !kRuns);
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
      stage_subblock<!kRuns>(smem + L.coef + (size_t)s * SL.bytes, SL,
                             full + s, rows, table, ids, fbox, b, nch, chunk,
                             sub, s_cid[pk], g, mode, lane);
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
      const unsigned char* slot = smem + L.coef + (size_t)s * SL.bytes;
      mbar_wait(full + s, (unsigned)((q / ring) & 1));
      if constexpr (kRuns) {
        const RunIds run{ids, s_cid[k] * chunk + (__ffs(m) - 1) * sub};
        took |= consume_subblock(slot, SL, sub, run, tx0, ty0, lane, warp,
                                 s_big, s_magic, s_key);
      } else {
        took |= consume_subblock(slot, SL, sub, tx0, ty0, lane, warp, s_big,
                                 s_magic, s_key);
      }
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

// The walk's kernel: one (16x32 tile, image) block. K1 (raster_vis.cu) is
// tile_walk_kernel<false>, K2 (raster_vis_v4.cu) tile_walk_kernel<true>.
template <bool kRuns>
__global__ void __launch_bounds__(NT + 32)
tile_walk_kernel(const __grid_constant__ CUtensorMap rows,
                 const float* __restrict__ table,
                 const int* __restrict__ ids,
                 const int* __restrict__ order,
                 const int* __restrict__ counts,
                 const int* __restrict__ masks,
                 const int* __restrict__ zlo,
                 const short4* __restrict__ fbox,
                 float* __restrict__ z_out, int* __restrict__ id_out,
                 unsigned char* __restrict__ flags, int T, int ntx, int nch,
                 int chunk, int nsub, int H, int W, int ring, int mode) {
  tile_walk<kRuns>(&rows, table, ids, order, counts, masks, zlo, fbox, z_out,
                   id_out, flags, T, ntx, nch, chunk, nsub, H, W, ring, mode);
}

// Shared memory `tile_walk_kernel<kRuns>` needs with a ring of one slot
// (bytes).
template <bool kRuns>
static long walk_smem(int chunk, int nsub, int nch) {
  return (long)Layout(chunk / nsub, nch, 1, !kRuns).total;
}

// Launches `tile_walk_kernel<kRuns>` (K1: ids = orig, staged; K2: ids =
// bbase, not staged) with as many ring slots as fit in `smem_target`
// bytes, one at least; returns the CUDA error.
template <bool kRuns>
static int launch_walk(const float* table, const int* ids, const int* order,
                       const int* counts, const int* masks, const int* zlo,
                       const void* fbox, float* z_out, int* id_out,
                       unsigned char* flags, int B, int T, int ntx, int nch,
                       int chunk, int nsub, int H, int W, int smem_target,
                       void* stream) {
  constexpr bool staged_ids = !kRuns;
  const auto kernel = tile_walk_kernel<kRuns>;
  const int sub = chunk / nsub;
  const size_t fixed = Layout(sub, nch, 0, staged_ids).total;
  const size_t slot = Layout(sub, nch, 1, staged_ids).total - fixed;
  const size_t target = (size_t)smem_target;
  int ring = (int)((target > fixed ? target - fixed : 0) / slot);
  ring = ring < 1 ? 1 : (ring > MAX_RING ? MAX_RING : ring);
  while (ring > 1 && Layout(sub, nch, ring, staged_ids).total > 227 * 1024)
    --ring;
  const size_t smem = Layout(sub, nch, ring, staged_ids).total;
  CUtensorMap rows;
  int err = 0;
  // the run bases are read by the consumers, never copied: no alignment
  const int mode = staging_mode(&rows, table, staged_ids ? ids : nullptr,
                                fbox, B, nch, chunk, sub, &err);
  if (mode < 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(T, B), NT + 32, smem, (cudaStream_t)stream>>>(
      rows, table, ids, order, counts, masks, zlo, (const short4*)fbox,
      z_out, id_out, flags, T, ntx, nch, chunk, nsub, H, W, ring, mode);
  return (int)cudaGetLastError();
}
