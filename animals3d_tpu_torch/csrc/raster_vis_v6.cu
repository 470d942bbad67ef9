// Tile visibility rasterizer over dense per-tile unit lists, for Hopper
// (sm_90a): K3, variant 6.
//
// Replaces the Pallas TPU kernel `_raster_kernel_v6`
// (animals3d_tpu/ops/rasterize_pallas.py:513, launched by
// `_pallas_visibility_v6` at :673 under A3D_RASTER_V=6). A "unit" is one
// sub-block of a chunk. Per (image, tile) the prep lists the units whose
// screen bbox overlaps the tile in ascending quantized z-min (ties by unit
// id), at most S of them. The kernel computes K1's function (nearest
// covering face, exact-z ties to the smallest original id) with the
// occlusion skip per unit instead of per chunk, and a flag per list slot:
// whether any pixel took a face from that unit. A tile with more than S
// units ("overflow") takes every face of every unit, with no skip and no
// flags (the prep gives such a tile its overlap row). Bit for bit
// `visibility_v6_reference`. The TPU kernel's gathered coefficient slabs
// (a DMA convenience, 1 GB per render at full width) have no counterpart:
// the producer reads a unit's columns of the chunk-major table by index.
//
// Bound on the H100: K1's (the same function on the same inputs; see
// raster_vis.cu), bytes.
//
// Design: K1's (raster_vis.cu; the helpers are shared, raster_tile.cuh).
// One block per (16x32 tile, image) of four consumer warps and one
// producer warp; each pixel's running winner is a 64-bit (z, id) key in
// shared memory kept with atomicMin; the producer stages each unit (a
// 12 x sub tensor box of the rows, its ids and its faces' cull boxes) into
// a shared-memory ring on `full`/`empty` mbarriers; the consumer warps
// flatten each face's cull box clipped to the tile into (face, pixel)
// pairs, large faces over the whole block. Two walks:
//   * Dense tiles (n <= S): the unit list front to back. The warps meet
//     at each unit's end: the large faces, the slot's flag (a key fell
//     during the unit: keys only fall, so this is "took") and the tile's
//     new z max, which decides the next unit's skip exactly as the plain
//     version does (strict test on floor-quantized z). The producer stages
//     ahead of that decision, reading the z max last published; a unit
//     skipped later is released unread. A unit whose box (`ubox`, the
//     union of its faces' cull boxes) misses the tile is neither staged
//     nor visited: it could take no pixel, so its flag is 0 and the z max
//     stays, as in the plain version.
//   * Overflow tiles (n > S): the result is the lexicographic minimum of
//     (z, id) over every accepted (face, pixel), which no visiting order
//     changes. The block tests every unit's box against the tile and
//     compacts those that meet it into a list in shared memory (251-260 a
//     tile on average, 404 at most on the full-width meshes, against
//     1,536 units); their faces are walked with no barrier between units.
//     The cull boxes bound every pixel a face's float32 edge tests accept,
//     so the skipped units and pixels hold no winner.
//   * Split: an overflow tile's busiest list (404 units) is three times a
//     dense tile's (at most 128, which meet at every unit), so an overflow
//     tile is split over a cluster of `split` blocks, each taking the
//     units u = rank (mod split). After a cluster barrier each block
//     merges a 1/split share of the tile's pixels, the minimum of the
//     blocks' keys read through distributed shared memory, and writes it
//     out; a second barrier keeps every block's keys alive until then. A
//     dense tile is walked by the cluster's first block; the others exit.
// Numerics: (a*px + b*py) + c with round-to-nearest multiplies and adds
// and no fused multiply-add (the library is built with -fmad=false), as
// K1 and the plain version. The skip's bound is the least vertex depth of
// the unit's faces; where the plane equation's rounding puts a face's
// depth at a pixel below it, the skip is not conservative, and K1
// (skipping per chunk) and this kernel may keep different winners there,
// as the two Pallas kernels may.

#include <cooperative_groups.h>
#include <limits.h>

#include "raster_tile.cuh"

namespace cg = cooperative_groups;

#define MAX_SPLIT 8

// Shared-memory layout, the same on host and device: the keys, the list
// (`cap` units; the z-mins of a dense list's S), the mbarriers, the slots'
// list positions, then `ring` slots of a unit each (`SlotLayout`).
struct Layout6 {
  size_t key, unit, zl, full, empty, qpos, coef, total;
  __host__ __device__ Layout6(int sub, int S, int cap, int ring) {
    key = 0;
    unit = key + (size_t)TP * 8;
    zl = unit + round16((size_t)cap * 4);
    full = zl + round16((size_t)S * 4);
    empty = full + MAX_RING * 8;
    qpos = empty + MAX_RING * 8;
    coef = round128(qpos + MAX_RING * 4);
    total = coef + (size_t)ring * SlotLayout(sub).bytes;
  }
};

// the longest list a block walks: S units on a dense tile, its share of
// the U units on an overflow one
static __host__ __device__ __forceinline__ int list_cap(int S, int U,
                                                        int split) {
  const int share = (U + split - 1) / split;
  return S > share ? S : share;
}

// table: (B, nch, 12, chunk) rows a0 a1 a2 az b0 b1 b2 bz c0 c1 c2 cz
// orig: (nch*chunk) original face id of each sorted slot
// units: (B, T, S) unit ids (chunk * nsub + sub-block); counts6: (B, T)
// zu: (B, U) quantized unit z-min; fbox: (B, nch*chunk) face cull boxes
// ubox: (B, U) unit boxes, x0 x1 y0 y1
// z_out, id_out: (B, H, W); sflags: (B, T, S), zero-filled by the caller
// rows: the table as (B*nch*12, chunk) for the tensor copy (mode 2)
// grid: (T * split, B), clusters of `split` blocks along x
__global__ void __launch_bounds__(NT + 32)
raster_vis_v6_kernel(const __grid_constant__ CUtensorMap rows,
                     const float* __restrict__ table,
                     const int* __restrict__ orig,
                     const int* __restrict__ units,
                     const int* __restrict__ counts6,
                     const int* __restrict__ zu,
                     const short4* __restrict__ fbox,
                     const short4* __restrict__ ubox,
                     float* __restrict__ z_out, int* __restrict__ id_out,
                     unsigned char* __restrict__ sflags, int T, int ntx,
                     int nch, int chunk, int nsub, int S, int H, int W,
                     int ring, int mode, int split) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ BigList s_big;
  __shared__ float s_wmax[NWARP];
  __shared__ int s_wany[NWARP];
  __shared__ unsigned s_magic[TILE_W + 1];
  __shared__ int s_n;
  __shared__ volatile int s_zq;      // the consumers' zq_max, for the producer
  const int sub = chunk / nsub, U = nch * nsub;
  const Layout6 L(sub, S, list_cap(S, U, split), ring);
  const SlotLayout SL(sub);
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + L.key);
  int* s_unit = reinterpret_cast<int*>(smem + L.unit);
  int* s_zl = reinterpret_cast<int*>(smem + L.zl);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.full);
  uint64_t* empty = reinterpret_cast<uint64_t*>(smem + L.empty);
  volatile int* s_qpos = reinterpret_cast<volatile int*>(smem + L.qpos);

  const int t = blockIdx.x / split, part = blockIdx.x % split;
  const int b = blockIdx.y, tid = threadIdx.x;
  const size_t bt = (size_t)b * T + t;
  const int dense = counts6[bt] <= S;
  if (dense && part > 0) return;        // a dense tile is one block's walk
  const int lane = tid & 31, warp = tid >> 5;
  const int tx0 = (t % ntx) * TILE_W, ty0 = (t / ntx) * TILE_H;
  const unsigned long long empty_key = (unsigned long long)zkey(BIG) << 32;
  for (int i = tid; i < TP; i += NT + 32) s_key[i] = empty_key;
  if (tid <= TILE_W) s_magic[tid] = magic_of(tid);
  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWARP);
    }
    s_zq = zq(BIG);
    s_big.n = 0;
    s_n = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The list: a dense tile's units with their z-mins (INT_MAX, always
  // skipped, where the unit's box misses the tile); an overflow tile's
  // units u = part (mod split) whose box meets it, in any order, never
  // skipped.
  const short4* ub = ubox + (size_t)b * U;
  int n;
  if (dense) {
    n = counts6[bt];
    for (int k = tid; k < n; k += NT + 32) {
      const int u = units[bt * S + k];
      s_unit[k] = u;
      s_zl[k] = clipped_area(ub[u], tx0, ty0) > 0 ? zu[(size_t)b * U + u]
                                                  : INT_MAX;
    }
  } else {
    for (int u = part + split * tid; u < U; u += split * (NT + 32))
      if (clipped_area(ub[u], tx0, ty0) > 0) {
        s_unit[atomicAdd(&s_n, 1)] = u;
      }
  }
  __syncthreads();
  if (!dense) n = s_n;

  if (warp == NWARP) {
    // ---- the producer warp walks the load sequence; lane r issues copy r
    int pk = 0;
    for (int q = 0;; ++q) {
      const int s = q % ring;
      // the slot's previous load released by every consumer warp (a fresh
      // barrier passes the first round)
      mbar_wait(empty + s, (unsigned)(((q / ring) & 1) ^ 1));
      const int zq_max = __shfl_sync(0xffffffffu, s_zq, 0);
      while (pk < n && dense && s_zl[pk] > zq_max) ++pk;
      if (pk >= n) {              // the end of the sequence
        if (lane == 0) {
          s_qpos[s] = n;
          mbar_arrive(full + s);
        }
        break;
      }
      if (lane == 0) s_qpos[s] = pk;
      const int u = s_unit[pk];
      stage_subblock(smem + L.coef + (size_t)s * SL.bytes, SL, full + s,
                     &rows, table, orig, fbox, b, nch, chunk, sub, u / nsub,
                     u % nsub, mode, lane);
      ++pk;
    }
  } else {
    // ---- the consumers: four warps, in step at each dense unit's end ----
    int zq_max = zq(BIG);
    int q = 0;                           // the next load of the sequence
    for (int k = 0; k < n; ++k) {
      if (dense && s_zl[k] > zq_max) {
        // skipped (flag stays 0): release the load issued for it, unread
        for (;; ++q) {
          const int s = q % ring;
          mbar_wait(full + s, (unsigned)((q / ring) & 1));
          if (s_qpos[s] != k) break;
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + s);
        }
        continue;
      }
      const int s = q % ring;
      mbar_wait(full + s, (unsigned)((q / ring) & 1));
      int took = consume_subblock(smem + L.coef + (size_t)s * SL.bytes, SL,
                                  sub, tx0, ty0, lane, warp, s_big, s_magic,
                                  s_key);
      __syncwarp();      // this warp is done with the slot
      if (lane == 0) mbar_arrive(empty + s);
      ++q;
      if (!dense) continue;
      consumers_sync();  // every warp is done with the unit
      took |= consume_big(s_big, tid, lane, warp, tx0, ty0, s_magic, s_key);
      // the slot's flag and the tile's new z max
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
        if (anyb) sflags[bt * S + k] = 1;
      }
    }
    if (!dense) {
      consumers_sync();  // every unit is done: the large faces left
      consume_big(s_big, tid, lane, warp, tx0, ty0, s_magic, s_key);
    }
  }

  if (dense || split == 1) {
    __syncthreads();
    for (int i = tid; i < TP; i += NT + 32)
      write_pixel(s_key[i], i, b, tx0, ty0, H, W, z_out, id_out);
    return;
  }
  // an overflow tile's cluster: each block merges and writes its share of
  // the pixels from every block's keys
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int share = TP / split;
  for (int i = part * share + tid; i < (part + 1) * share; i += NT + 32) {
    unsigned long long key = s_key[i];
    for (int r = 0; r < split; ++r)
      if (r != part) {
        const unsigned long long o = cluster.map_shared_rank(s_key, r)[i];
        key = o < key ? o : key;
      }
    write_pixel(key, i, b, tx0, ty0, H, W, z_out, id_out);
  }
  cluster.sync();        // no block leaves while another reads its keys
}

// Shared memory the kernel needs with a ring of one slot (bytes); the
// wrapper refuses shapes above the card's 227 KB.
extern "C" long raster_vis_v6_smem(int chunk, int nsub, int nch, int S,
                                   int split) {
  return (long)Layout6(chunk / nsub, S, list_cap(S, nch * nsub, split), 1)
      .total;
}

extern "C" int raster_vis_v6_launch(const float* table, const int* orig,
                                    const int* units, const int* counts6,
                                    const int* zu, const void* fbox,
                                    const void* ubox, float* z_out,
                                    int* id_out, unsigned char* sflags,
                                    int B, int T, int ntx, int nch,
                                    int chunk, int nsub, int S, int H, int W,
                                    int smem_target, int split,
                                    void* stream) {
  if (split < 1 || split > MAX_SPLIT || TP % split)
    return (int)cudaErrorInvalidValue;
  // as many ring slots as fit in `smem_target` bytes, one at least
  const int sub = chunk / nsub;
  const int cap = list_cap(S, nch * nsub, split);
  const size_t fixed = Layout6(sub, S, cap, 0).total;
  const size_t slot = SlotLayout(sub).bytes;
  const size_t target = (size_t)smem_target;
  int ring = (int)((target > fixed ? target - fixed : 0) / slot);
  ring = ring < 1 ? 1 : (ring > MAX_RING ? MAX_RING : ring);
  while (ring > 1 && Layout6(sub, S, cap, ring).total > 227 * 1024) --ring;
  const size_t smem = Layout6(sub, S, cap, ring).total;
  CUtensorMap rows;
  int err = 0;
  const int mode = staging_mode(&rows, table, orig, fbox, B, nch, chunk, sub,
                                &err);
  if (mode < 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      raster_vis_v6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(raster_vis_v6_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(T * split), (unsigned)B);
  cfg.blockDim = dim3(NT + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, raster_vis_v6_kernel, rows, table, orig, units,
                         counts6, zu, (const short4*)fbox,
                         (const short4*)ubox, z_out, id_out, sflags, T, ntx,
                         nch, chunk, nsub, S, H, W, ring, mode, split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
