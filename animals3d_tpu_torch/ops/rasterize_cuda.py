"""Tile visibility rasterizer: a hand-written CUDA kernel for Hopper
(`csrc/raster_vis.cu`) and its plain PyTorch version, with the per-face
cull boxes it reads (`csrc/cull_boxes.cu`, plain version `cull_boxes`).

Port of the Pallas kernel `_raster_kernel`
(`animals3d_tpu/ops/rasterize_pallas.py:153`, launched from
`_pallas_visibility` and prepared by `_rasterize_pallas_T`). The prep
around the kernel is plain PyTorch, as the JAX package left it to XLA:

  * per-face affine coefficients in struct-of-arrays form, with the
    `1e-4·|det|` edge bias, invalid faces as (a, b, c) = (0, 0, -1) and
    faces with any vertex behind the camera (w <= 1e-6) invalid;
  * one batch-shared face order: 32-face blocks sorted by the 3-D Morton
    code of their batch-0 world centroid, so 1024-face chunks are compact
    on screen in every view;
  * per chunk and per 128-face sub-block: screen bboxes, and the chunk's
    quantized z-min (`_zq`);
  * per (image, 16×32 tile): the chunks whose bbox overlaps it, sorted
    front to back by z-min, with an 8-bit mask of overlapping sub-blocks;
  * per face and image, a cull box (`cull_boxes`; on the card the kernel
    `cull`): a bound of every pixel centre its float32 edge tests can
    accept. Every variant tests a face only on its box;
  * variant 6 also: per unit (sub-block) and image, the union of its
    faces' boxes (`unit_boxes`; on the card `cull_units`, the cull kernel
    that folds them in the same launch).

The kernel (or `visibility_reference`) then computes, per pixel, the
nearest covering face — ties on exactly equal z go to the smallest
original face id — skipping a chunk when its quantized z-min is strictly
behind every pixel of the tile, plus per-(image, tile, chunk) flags of
whether any pixel took a face from the chunk (a superset of the chunks
that hold final winners). Kernel and plain version evaluate every affine
function as (a·px + b·py) + c with no fused multiply-add
(`ops.rasterize.affine`), so they agree bit for bit. (XLA's CPU compiler
contracts the JAX package's coefficient math into FMAs, so against the
JAX package a pixel on an edge shared by two faces may flip.)

K1 (`visibility`, variant 3) spreads each live sub-block's (face, pixel)
pairs, the pixels of each face's cull box in the tile, over its warps'
lanes (a large face's over the whole block), and keeps each pixel's winner
as a 64-bit (z, id) key in shared memory with `atomicMin`; a producer warp
brings the sub-blocks' rows by bulk copy into a shared-memory ring (see
its source note).

Two more kernels compute the same function (`variant` of `prepare` and
`rasterize_cuda`, the counterpart of the JAX package's `A3D_RASTER_V`):

  * variant 4, `visibility_v4` (`csrc/raster_vis_v4.cu`, port of
    `_raster_kernel_v4`): K1's walk (`tile_walk` of `csrc/raster_tile.cuh`,
    shared) with the trait of the TPU kernel: the original ids are not
    staged but rebuilt from the run bases `bbase` of `prepare` (the Morton
    order moves runs of 32 consecutive ids), so a live sub-block takes two
    copy requests instead of three. Its outputs equal K1's bit for bit,
    flags included, so its plain version is `visibility_reference` (on the
    ids rebuilt from `bbase`);
  * variant 6, `visibility_v6` (`csrc/raster_vis_v6.cu`, port of
    `_raster_kernel_v6`): per (image, tile), the overlapping 128-face
    sub-blocks ("units") in ascending quantized z-min, at most
    S = min(128, U, `v6_cap`) of them; the occlusion skip is per unit, the
    flags per list slot (scattered back to chunks by `chunk_flags_v6`),
    and a tile with more than S units scans every sub-block with no skip.
    Its plain version is `visibility_v6_reference`. K3 walks the lists
    with K1's structure, and a tile with more than S units only over the
    units whose box meets it, split over a cluster of blocks
    (`K3_SPLIT`); see its source note. Its z and face_id
    equal K1's wherever the skips are conservative; they are not where the
    plane equation's float32 rounding puts a face's depth below the
    least vertex depth its chunk or unit is skipped by, and there the two
    variants may skip different faces.

On a CPU tensor each wrapper runs the plain version; on a CUDA tensor it
launches its kernel from the library of `ops.kernels` or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.ops import kernels
from animals3d_tpu_torch.ops.rasterize import Rast, affine
from animals3d_tpu_torch.ops.resolve_cuda import TILE_H, TILE_W, TP

BIG = 3.0e38
BLOCK = 32           # face-block granularity of the Morton order
NSUB = 8             # sub-blocks per chunk for the bbox mask
ZQ_SCALE = 1048576.0
ZQ_CLAMP = 8.0
_INT_MAX = 2 ** 31 - 1


def _zq(z: torch.Tensor) -> torch.Tensor:
    """Floor-quantized z (int32). Floor quantization keeps the strict `>`
    occlusion skip conservative: it cannot change a winner or a tie."""
    return torch.floor(torch.clamp(z, -ZQ_CLAMP, ZQ_CLAMP) * ZQ_SCALE) \
        .to(torch.int32)


def _morton3(x, y, z):
    """Interleave the low 10 bits of three int coordinates (3-D Z-order)."""
    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def tile_pixels(height: int, width: int, device):
    """Pixel-centre coordinates in tile order: (px, py), each (T, TP)."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    nty, ntx = height // TILE_H, width // TILE_W

    def tiled(a):
        return a.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3) \
            .reshape(nty * ntx, TP)
    return tiled(px), tiled(py)


def _untile(x, B, height, width):
    """(B·T, TP) tile order → (B, H, W)."""
    nty, ntx = height // TILE_H, width // TILE_W
    return x.reshape(B, nty, ntx, TILE_H, TILE_W).permute(0, 1, 3, 2, 4) \
        .reshape(B, height, width)


def prepare(v_clip, v_pos0, faces, f_valid, resolution, chunk: int = 1024,
            nsub: int = NSUB, variant: int = 3, v6_cap: int = 128):
    """Everything the visibility kernel of `variant` reads (see the module
    docstring).

    v_clip (B, V, 4) clip positions; v_pos0 (V, 3) batch-0 world positions
    (they key the shared Morton block order); faces (F, 3); f_valid (F,);
    nsub sub-blocks per chunk (the JAX package's `A3D_NSUB`; 1 when it
    does not divide `chunk`). Returns a dict: table (B, nch, 12, chunk) f32
    rows [a0 a1 a2 az | b0 b1 b2 bz | c0 c1 c2 cz] so that
    e = (a·px + b·py) + c; orig (nch·chunk,) int32 original face id per
    sorted slot; order (B, T, nch) int32 chunk ids front to back
    (overlapping ones first); counts (B, T) int32; masks (B, T, nch) int32
    sub-block overlap bits by chunk id; zlo (B, nch) int32 quantized chunk
    z-min; nsub; fbox (B, nch·chunk, 4) int16 per-face cull boxes
    (`cull`; variant 6 `cull_units`). Variant 4 adds bbase
    (nch·chunk / 32,) int32, the original id of each 32-slot run's first
    slot (`orig[::32]`: the Morton order moves whole runs, so
    orig[s] = bbase[s // 32] + s % 32). Variant 6
    adds zu (B, U) int32 quantized unit z-min, units (B, T, S) int32 unit
    lists, counts6 (B, T) int32, S and ubox (B, U, 4) int16 per-unit boxes
    (`cull_units`: one launch makes both kinds of box).
    Raises ValueError for a variant that cannot run on these shapes (the
    JAX package falls back to variant 3 there).
    """
    height, width = resolution
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"resolution {resolution} must be a multiple of "
                         f"({TILE_H}, {TILE_W})")
    if variant not in (3, 4, 6):
        raise ValueError(f"variant {variant}: want 3, 4 or 6")
    if not 1 <= nsub <= 16:
        raise ValueError(f"nsub {nsub}: want 1 to 16")
    nsub = nsub if chunk % nsub == 0 and chunk >= nsub else 1
    if variant == 4 and (chunk // nsub) % BLOCK:
        raise ValueError(f"variant 4 needs sub-blocks of a multiple of "
                         f"{BLOCK} faces; chunk {chunk} / nsub {nsub}")
    if variant == 6 and nsub == 1:
        raise ValueError(f"variant 6 needs more than one sub-block per "
                         f"chunk; chunk {chunk}, nsub {nsub}")
    dev = v_clip.device
    B = v_clip.shape[0]
    Fn = faces.shape[0]
    Fp = -(-Fn // chunk) * chunk
    faces = faces.long()
    fv = v_clip.detach()[:, faces]                     # (B, F, 3, 4)
    p0 = v_pos0.detach()[faces]                        # (F, 3, 3)
    if Fp != Fn:
        fv = torch.cat([fv, fv.new_zeros((B, Fp - Fn, 3, 4))], 1)
        p0 = torch.cat([p0, p0.new_zeros((Fp - Fn, 3, 3))], 0)
        f_valid = torch.cat([f_valid, f_valid.new_zeros((Fp - Fn,))], 0)

    # ---- shared block order: 3-D Morton of batch-0 world centroids ----
    blk = min(BLOCK, chunk)
    nblk = Fp // blk
    ctr = (p0[:, 0] + p0[:, 1] + p0[:, 2]) / 3.0
    bval = f_valid.reshape(nblk, blk)
    nb = torch.clamp(bval.sum(1), min=1)[:, None]
    c = (ctr.reshape(nblk, blk, 3) * bval[..., None]).sum(1) / nb
    has = bval.any(1)
    lo = torch.where(has[:, None], c, torch.full_like(c, BIG)).amin(0)
    hi = torch.where(has[:, None], c, torch.full_like(c, -BIG)).amax(0)
    q = torch.clamp(((c - lo) / torch.clamp(hi - lo, min=1e-9) * 1023)
                    .to(torch.int32), 0, 1023)
    key = torch.where(has, _morton3(q[:, 0], q[:, 1], q[:, 2]),
                      torch.full_like(q[:, 0], 1 << 30))
    perm = torch.argsort(key, stable=True)
    orig = (perm[:, None] * blk + torch.arange(blk, device=dev)).reshape(Fp)
    fv = fv[:, orig]
    fval = f_valid[orig]

    # ---- face coefficients, (B, Fp) per quantity ----
    def ch(c_, vtx):
        return fv[:, :, vtx, c_]

    def safe(w):
        return torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))

    sw0, sw1, sw2 = safe(ch(3, 0)), safe(ch(3, 1)), safe(ch(3, 2))
    x0 = (ch(0, 0) / sw0 + 1.0) * (0.5 * width)
    x1 = (ch(0, 1) / sw1 + 1.0) * (0.5 * width)
    x2 = (ch(0, 2) / sw2 + 1.0) * (0.5 * width)
    y0 = (ch(1, 0) / sw0 + 1.0) * (0.5 * height)
    y1 = (ch(1, 1) / sw1 + 1.0) * (0.5 * height)
    y2 = (ch(1, 2) / sw2 + 1.0) * (0.5 * height)
    z0, z1, z2 = ch(2, 0) / sw0, ch(2, 1) / sw1, ch(2, 2) / sw2
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - x2 * y1
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - x0 * y2
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - x1 * y0
    sgn = torch.where(det >= 0, 1.0, -1.0)
    absdet = det.abs()
    inv = 1.0 / torch.clamp(absdet, min=1e-12)
    ok = (fval[None, :] & (absdet > 1e-12) & (ch(3, 0) > 1e-6)
          & (ch(3, 1) > 1e-6) & (ch(3, 2) > 1e-6))
    eps = 1e-4 * absdet
    ea0, ea1, ea2 = a0 * sgn, a1 * sgn, a2 * sgn
    eb0, eb1, eb2 = b0 * sgn, b1 * sgn, b2 * sgn
    ec0, ec1, ec2 = c0 * sgn, c1 * sgn, c2 * sgn
    za = (ea0 * z0 + ea1 * z1 + ea2 * z2) * inv
    zb = (eb0 * z0 + eb1 * z1 + eb2 * z2) * inv
    zc = (ec0 * z0 + ec1 * z1 + ec2 * z2) * inv
    ec0, ec1, ec2 = ec0 + eps, ec1 + eps, ec2 + eps

    def g(v, fill=0.0):         # invalid faces → (a, b, c) = (0, 0, -1)
        return torch.where(ok, v, torch.full_like(v, fill))
    nch = Fp // chunk
    table = torch.stack([g(ea0), g(ea1), g(ea2), g(za),
                         g(eb0), g(eb1), g(eb2), g(zb),
                         g(ec0, -1.0), g(ec1, -1.0), g(ec2, -1.0),
                         g(zc, -1.0)], 1)               # (B, 12, Fp)
    table = table.reshape(B, 12, nch, chunk).permute(0, 2, 1, 3).contiguous()

    # ---- per-(tile, chunk) lists + sub-block masks ----
    nty, ntx = height // TILE_H, width // TILE_W
    T = nty * ntx
    sub = chunk // nsub

    def box(v, fill, red):
        v = torch.where(ok, v, torch.full_like(v, fill)) \
            .reshape(B, nch, nsub, sub)
        return v.amin(-1) if red == "min" else v.amax(-1)
    lo_x = box(torch.minimum(torch.minimum(x0, x1), x2), BIG, "min")
    lo_y = box(torch.minimum(torch.minimum(y0, y1), y2), BIG, "min")
    hi_x = box(torch.maximum(torch.maximum(x0, x1), x2), -BIG, "max")
    hi_y = box(torch.maximum(torch.maximum(y0, y1), y2), -BIG, "max")
    tids = torch.arange(T, device=dev)
    tx0 = ((tids % ntx) * TILE_W).float()[None, :, None, None]
    ty0 = ((tids // ntx) * TILE_H).float()[None, :, None, None]
    ov_sub = ((lo_x[:, None] < tx0 + TILE_W) & (hi_x[:, None] >= tx0)
              & (lo_y[:, None] < ty0 + TILE_H) & (hi_y[:, None] >= ty0))
    masks = (ov_sub.to(torch.int32)
             << torch.arange(nsub, dtype=torch.int32, device=dev)).sum(-1) \
        .to(torch.int32)                                # (B, T, nch)
    overlap = masks > 0
    zmin = torch.where(ok, torch.minimum(torch.minimum(z0, z1), z2),
                       torch.full_like(z0, BIG))
    zlo = _zq(zmin.reshape(B, nch, chunk).amin(-1))      # (B, nch)
    zkey = torch.where(overlap, zlo[:, None, :],
                       torch.full_like(overlap, _INT_MAX, dtype=torch.int32))
    order = torch.argsort(zkey, dim=-1, stable=True).to(torch.int32)
    counts = overlap.sum(-1).to(torch.int32)
    out = {"table": table, "orig": orig.to(torch.int32).contiguous(),
           "order": order.contiguous(), "counts": counts.contiguous(),
           "masks": masks.contiguous(), "zlo": zlo.contiguous(),
           "nsub": nsub}
    if variant == 6:
        out["fbox"], ubox = cull_units(table, resolution, sub)
    else:
        out["fbox"] = cull(table, resolution)
    if variant == 4:
        # the run bases of `_rasterize_pallas_T` (:904), blk = BLOCK here
        out["bbase"] = (perm * blk).to(torch.int32).contiguous()
    if variant == 6:
        # units (sub-blocks) per tile in ascending (quantized z-min, unit
        # id): the stable sort of `_rasterize_pallas_T` (:843-858), without
        # its slab gather — the kernel reads a unit's columns of `table`
        U = nch * nsub
        ovu = ov_sub.reshape(B, T, U)
        zu = _zq(zmin.reshape(B, U, sub).amin(-1))          # (B, U)
        S = max(1, min(128, U, int(v6_cap)))
        ukey = torch.where(ovu, zu[:, None, :],
                           torch.full_like(ovu, _INT_MAX, dtype=torch.int32))
        units = torch.argsort(ukey, dim=-1, stable=True)[..., :S]
        out.update(zu=zu.contiguous(),
                   units=units.to(torch.int32).contiguous(),
                   counts6=ovu.sum(-1).to(torch.int32).contiguous(), S=S,
                   ubox=ubox)
    return out


def cull_boxes(table, resolution):
    """Per face (sorted slot) and image, the pixel index ranges
    [x0, x1, y0, y1] (B, nch·chunk, 4) int16 outside which the face's
    float32 edge tests accept no pixel centre; empty when x0 > x1 or
    y0 > y1. Variant 4's kernel tests only the pixels of its box.

    Derived from the coefficients themselves, in float64, so that the cull
    cannot change a winner. (A box of the vertices is not enough: the
    constant c = x1·y2 − x2·y1 of an edge is rounded to float32, which on a
    face a fraction of a pixel across can move the edge by more than the
    face's size.) (a·px + b·py) + c evaluated in float32 differs from its
    exact value by at most 4·2^-24·(|a|·W + |b|·H + |c|); so a pixel the
    kernel accepts satisfies a·x + b·y + c + E ≥ 0 with twice that bound E,
    for all three edges. Where the three edge normals span the plane
    positively, that region lies in the triangle of the three lines'
    pairwise intersections; elsewhere the box is the whole screen. A face
    with an edge of zero normal and a negative constant (the invalid
    faces' (0, 0, −1)) covers nothing.

    Each corner is (num_x, num_y)·r with r = 1/det correctly rounded, and
    the pads use |r| = 1/|det| (exact); two roundings, of the reciprocal
    and of the product, move a corner by at most 2·2^-53 of its size
    (~2.2e-16) where a quotient's one rounding moved it by 2^-53. The pad,
    1e-12 of the same terms over |det| plus 1e-3 pixels, covers that
    thousands of times over, so
    every box still holds every pixel centre the edge tests accept. A
    corner whose r overflows is not finite and gives the whole screen,
    which is always safe. The CUDA kernel does the same operations in the
    same order (`csrc/cull_boxes.cu`), so the two agree bit for bit."""
    height, width = resolution
    B, nch, _rows, chunk = table.shape
    t = table.permute(0, 1, 3, 2).reshape(B, nch * chunk, 12).double()
    a, b, c = t[..., 0:3], t[..., 4:7], t[..., 8:11]
    cp = c + 2.0 ** -21 * (a.abs() * width + b.abs() * height + c.abs()) \
        + 1e-30
    i, j = [1, 2, 0], [2, 0, 1]          # the lines meeting at corner k
    ai, bi, ci = a[..., i], b[..., i], cp[..., i]
    aj, bj, cj = a[..., j], b[..., j], cp[..., j]
    det = ai * bj - aj * bi              # cross products of the normals
    r = torch.where(det == 0, torch.ones_like(det), det).reciprocal()
    x = (bi * cj - bj * ci) * r
    y = (aj * ci - ai * cj) * r
    # float64 error of the corners, padded far above its 1e-16 scale
    ex = 1e-3 + 1e-12 * ((bi * cj).abs() + (bj * ci).abs()) * r.abs()
    ey = 1e-3 + 1e-12 * ((aj * ci).abs() + (ai * cj).abs()) * r.abs()
    spans = ((det > 0).all(-1) | (det < 0).all(-1)) \
        & torch.isfinite(x).all(-1) & torch.isfinite(y).all(-1) \
        & torch.isfinite(ex).all(-1) & torch.isfinite(ey).all(-1)
    x0 = torch.ceil((x - ex).amin(-1) - 0.5)
    x1 = torch.floor((x + ex).amax(-1) - 0.5)
    y0 = torch.ceil((y - ey).amin(-1) - 0.5)
    y1 = torch.floor((y + ey).amax(-1) - 0.5)
    full = ~spans
    x0 = torch.where(full, torch.zeros_like(x0), x0)
    x1 = torch.where(full, torch.full_like(x1, width - 1), x1)
    y0 = torch.where(full, torch.zeros_like(y0), y0)
    y1 = torch.where(full, torch.full_like(y1, height - 1), y1)
    none = ((a == 0) & (b == 0) & (c < 0)).any(-1)
    x0 = torch.where(none, torch.full_like(x0, width), x0)
    x1 = torch.where(none, torch.full_like(x1, -1), x1)
    box = torch.stack([x0.clamp(-1, width), x1.clamp(-1, width),
                       y0.clamp(-1, height), y1.clamp(-1, height)], -1)
    return box.to(torch.int16).contiguous()


def cull(table, resolution):
    """`cull_boxes` on the table's device: the CUDA kernel
    (`csrc/cull_boxes.cu`) for a CUDA table, the plain version for a CPU
    one; the same int16 boxes bit for bit. Variant 6 takes `cull_units`
    instead. Adds one to `cull.launches` per kernel launch."""
    if _device(table).type == "cpu":
        return cull_boxes(table, resolution)
    B, nch, _rows, chunk = table.shape
    kernels.check_tensors({"table": (table, torch.float32,
                                     (B, nch, 12, chunk))}, table.device)
    height, width = resolution
    out = torch.empty((B, nch * chunk, 4), dtype=torch.int16,
                      device=table.device)
    kernels.launch(kernels.library().cull_boxes_launch, "cull_boxes", table,
                   out, None, B, nch, chunk, chunk, height, width)
    cull.launches += 1
    return out


cull.launches = 0
tracing.register_launches(cull)


def unit_boxes(fbox, sub: int, resolution):
    """Per image and unit (each `sub` consecutive sorted slots, a sub-block),
    the union (B, U, 4) int16 of its faces' non-empty cull boxes
    (`cull_boxes`): every pixel centre any of its faces' float32 edge tests
    can accept lies in it. (W, -1, H, -1), empty, where every face's box is
    empty."""
    height, width = resolution
    B, F, _four = fbox.shape
    bx = fbox.long().reshape(B, F // sub, sub, 4)
    some = (bx[..., 0] <= bx[..., 1]) & (bx[..., 2] <= bx[..., 3])

    def fold(i, fill, red):
        v = torch.where(some, bx[..., i], torch.full_like(bx[..., i], fill))
        return v.amin(-1) if red == "min" else v.amax(-1)
    box = torch.stack([fold(0, width, "min"), fold(1, -1, "max"),
                       fold(2, height, "min"), fold(3, -1, "max")], -1)
    return box.to(torch.int16).contiguous()


def cull_units(table, resolution, sub: int):
    """The face boxes and the unit boxes of variant 6 in one launch:
    (`cull_boxes`, `unit_boxes` of those with units of `sub` slots) on the
    table's device — the cull kernel's instantiation that also folds each
    unit's boxes (`csrc/cull_boxes.cu`) for a CUDA table, the two plain
    versions for a CPU one; the same int16 boxes bit for bit. Raises
    ValueError where units of `sub` slots do not divide a chunk. Adds one
    to `cull_units.launches` per kernel launch."""
    B, nch, _rows, chunk = table.shape
    if sub < 1 or chunk % sub:
        raise ValueError(f"units of {sub} faces do not divide a chunk of "
                         f"{chunk}")
    if _device(table).type == "cpu":
        fbox = cull_boxes(table, resolution)
        return fbox, unit_boxes(fbox, sub, resolution)
    kernels.check_tensors({"table": (table, torch.float32,
                                     (B, nch, 12, chunk))}, table.device)
    height, width = resolution
    fbox = torch.empty((B, nch * chunk, 4), dtype=torch.int16,
                       device=table.device)
    ubox = torch.empty((B, nch * chunk // sub, 4), dtype=torch.int16,
                       device=table.device)
    kernels.launch(kernels.library().cull_boxes_launch, "cull_units", table,
                   fbox, ubox, B, nch, chunk, sub, height, width)
    cull_units.launches += 1
    return fbox, ubox


cull_units.launches = 0
tracing.register_launches(cull_units)


def _check_table(table, orig, resolution, nsub, ids="orig"):
    """The table, the ids (`orig`, one a sorted slot; or `bbase`, one a
    32-slot run) and the shapes every visibility kernel takes."""
    B, nch, rows, chunk = table.shape
    height, width = resolution
    if table.dtype != torch.float32 or rows != 12:
        raise ValueError(f"table: want float32 (B, nch, 12, chunk), got "
                         f"{table.dtype} {tuple(table.shape)}")
    per = BLOCK if ids == "bbase" else 1
    kernels.check_tensors({"table": (table, torch.float32, table.shape),
                           ids: (orig, torch.int32, (nch * chunk // per,))},
                          table.device)
    if height % TILE_H or width % TILE_W or nsub < 1 or chunk % nsub:
        raise ValueError(f"bad resolution {resolution} / chunk {chunk} / "
                         f"nsub {nsub}")
    if (chunk // nsub) * 13 * 4 > 227 * 1024:
        raise ValueError(f"sub-block of {chunk // nsub} faces exceeds "
                         "shared memory")
    return B, nch, chunk, (height // TILE_H) * (width // TILE_W)


def _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub,
                  fbox=None, ids="orig"):
    """The visibility inputs' types, shapes and device; and the cull boxes
    (B, nch·chunk, 4) int16 where given (K1's and K2's). ids="bbase": `orig`
    is variant 4's run bases, and a sub-block must be whole runs."""
    B, nch, chunk, T = _check_table(table, orig, resolution, nsub, ids)
    if ids == "bbase" and (chunk // nsub) % BLOCK:
        raise ValueError(f"variant 4 needs sub-blocks of a multiple of "
                         f"{BLOCK} faces; chunk {chunk} / nsub {nsub}")
    want = {"order": (order, torch.int32, (B, T, nch)),
            "counts": (counts, torch.int32, (B, T)),
            "masks": (masks, torch.int32, (B, T, nch)),
            "zlo": (zlo, torch.int32, (B, nch))}
    if fbox is not None:
        want["fbox"] = (fbox, torch.int16, (B, nch * chunk, 4))
    kernels.check_tensors(want, table.device)


def _check_inputs_v6(table, orig, units, counts6, zu, resolution, nsub,
                     fbox=None, ubox=None):
    """Variant 6's inputs; and the face and unit cull boxes where given
    (K3's)."""
    B, nch, chunk, T = _check_table(table, orig, resolution, nsub)
    if nsub < 2 or units.ndim != 3:
        raise ValueError(f"variant 6: nsub {nsub}, units {tuple(units.shape)}")
    want = {"units": (units, torch.int32, (B, T, units.shape[-1])),
            "counts6": (counts6, torch.int32, (B, T)),
            "zu": (zu, torch.int32, (B, nch * nsub))}
    if fbox is not None:
        want["fbox"] = (fbox, torch.int16, (B, nch * chunk, 4))
        want["ubox"] = (ubox, torch.int16, (B, nch * nsub, 4))
    kernels.check_tensors(want, table.device)


def _subblock_winners(table, orig, px, py, b, t, cid, g, sub):
    """Per pixel of tile t[n] of image b[n], the lexicographic minimum of
    (z, original id + 1) over the faces of sub-block g[n] of chunk cid[n]
    that cover it (z = BIG where none does): gz, gi, each (n, TP)."""
    chunk = table.shape[-1]
    slot = (g * sub)[:, None] + torch.arange(sub, device=table.device)
    cf = table[b[:, None], cid[:, None], :, slot]        # (n, sub, 12)
    ids = orig[cid[:, None] * chunk + slot]               # (n, sub)
    X, Y = px[t][:, :, None], py[t][:, :, None]

    def ev(i):
        return affine(cf[:, None, :, i], cf[:, None, :, i + 4],
                      cf[:, None, :, i + 8], X, Y)
    m = torch.minimum(torch.minimum(ev(0), ev(1)), ev(2))
    zcand = torch.where(m >= 0, ev(3), torch.full_like(m, BIG))
    gz = zcand.amin(-1)
    gid = torch.where(zcand <= gz[..., None], ids[:, None, :],
                      torch.full_like(ids[:, None, :], _INT_MAX)).amin(-1)
    return gz, gid + 1


def _take(gz, gi, za, ia):
    """The running winner (za, ia) after a candidate (gz, gi): smaller z
    wins, exactly equal z goes to the smaller id. Returns (z, id, took)."""
    take = (gz < za) | ((gz == za) & (za < BIG) & (gi < ia))
    return torch.where(take, gz, za), torch.where(take, gi, ia), take


def _outputs(z, fid, B, height, width):
    z = torch.where(fid > 0, z, torch.zeros_like(z))
    return _untile(z, B, height, width), _untile(fid, B, height, width)


def visibility_reference(table, orig, order, counts, masks, zlo, resolution,
                         nsub: int, stats: Optional[dict] = None):
    """Plain PyTorch version of the visibility kernel (same signature and
    outputs): z (B, H, W) f32 (0 on background), face_id (B, H, W) int32
    (original index + 1, 0 = background), flags (B, T, nch) uint8.

    Walks list position k for every (image, tile) at once, and within it
    the chunk's sub-blocks, exactly as a kernel block does. If `stats` is
    given it receives `visits`, an int64 (n, 4) tensor of the live
    (image, tile, chunk, sub-block) visits, those not skipped by the
    occlusion test or the sub-block mask. It is the plain version of
    variant 4's kernel too, whose outputs are the same."""
    _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub)
    height, width = resolution
    B, nch, _, chunk = table.shape
    dev = table.device
    T = (height // TILE_H) * (width // TILE_W)
    sub = chunk // nsub
    px, py = tile_pixels(height, width, dev)
    z = torch.full((B * T, TP), BIG, device=dev)
    fid = torch.zeros((B * T, TP), dtype=torch.int32, device=dev)
    flags = torch.zeros((B * T, nch), dtype=torch.uint8, device=dev)
    counts_f = counts.reshape(-1).long()
    order_f = order.reshape(B * T, nch).long()
    masks_f = masks.reshape(B * T, nch)
    visits = []
    for k in range(int(counts_f.max()) if counts_f.numel() else 0):
        r = torch.nonzero(counts_f > k)[:, 0]
        cid = order_f[r, k]
        b, t = r // T, r % T
        zr, idr = z[r], fid[r]
        live = zlo[b, cid] <= _zq(zr.amax(1))
        mbits = masks_f[r, cid]
        took = torch.zeros_like(zr, dtype=torch.bool)
        for g in range(nsub):
            act = torch.nonzero(live & (((mbits >> g) & 1) == 1))[:, 0]
            if act.numel() == 0:
                continue
            ba, ca = b[act], cid[act]
            ga = torch.full_like(ca, g)
            if stats is not None:
                visits.append(torch.stack([ba, t[act], ca, ga], 1))
            gz, gi = _subblock_winners(table, orig, px, py, ba, t[act], ca,
                                       ga, sub)
            zr[act], idr[act], tk = _take(gz, gi, zr[act], idr[act])
            took[act] |= tk
        z[r], fid[r] = zr, idr
        flags[r, cid] = took.any(1).to(torch.uint8)
    if stats is not None:
        stats["visits"] = torch.cat(visits) if visits else \
            torch.zeros((0, 4), dtype=torch.int64, device=dev)
    return (*_outputs(z, fid, B, height, width), flags.reshape(B, T, nch))


def visibility_v6_reference(table, orig, units, counts6, zu, resolution,
                            nsub: int, stats: Optional[dict] = None):
    """Plain PyTorch version of variant 6's kernel (same outputs): z,
    face_id as `visibility_reference`, and slot flags (B, T, S) uint8 —
    whether any pixel took a face from the unit in list slot k (0 where
    the unit was skipped).

    A tile with at most S units walks its list front to back and skips a
    unit whose quantized z-min is behind every pixel's winner. A tile with
    more scans every sub-block of every chunk with no skip and no flags
    (`_raster_kernel_v6` :603-628); `chunk_flags_v6` gives it the overlap
    row. If `stats` is given it receives `visits`, an int64 (n, 3) tensor
    of the dense tiles' live (image, tile, unit) visits, those the
    occlusion skip keeps."""
    _check_inputs_v6(table, orig, units, counts6, zu, resolution, nsub)
    height, width = resolution
    B, nch, _, chunk = table.shape
    S = units.shape[-1]
    dev = table.device
    T = (height // TILE_H) * (width // TILE_W)
    sub = chunk // nsub
    px, py = tile_pixels(height, width, dev)
    z = torch.full((B * T, TP), BIG, device=dev)
    fid = torch.zeros((B * T, TP), dtype=torch.int32, device=dev)
    sflags = torch.zeros((B * T, S), dtype=torch.uint8, device=dev)
    counts_f = counts6.reshape(-1).long()
    units_f = units.reshape(B * T, S).long()
    dense = counts_f <= S
    n_dense = int(torch.where(dense, counts_f, 0).max()) \
        if counts_f.numel() else 0
    visits = []
    for k in range(n_dense):
        r = torch.nonzero(dense & (counts_f > k))[:, 0]
        unit = units_f[r, k]
        b, t = r // T, r % T
        zr, idr = z[r], fid[r]
        act = torch.nonzero(zu[b, unit] <= _zq(zr.amax(1)))[:, 0]
        if act.numel() == 0:
            continue
        ua = unit[act]
        if stats is not None:
            visits.append(torch.stack([b[act], t[act], ua], 1))
        gz, gi = _subblock_winners(table, orig, px, py, b[act], t[act],
                                   ua // nsub, ua % nsub, sub)
        zr[act], idr[act], tk = _take(gz, gi, zr[act], idr[act])
        z[r], fid[r] = zr, idr
        sflags[r[act], k] = tk.any(1).to(torch.uint8)
    r = torch.nonzero(~dense)[:, 0]
    if r.numel():
        b, t = r // T, r % T
        zr, idr = z[r], fid[r]
        for cid in range(nch):
            for g in range(nsub):
                gz, gi = _subblock_winners(
                    table, orig, px, py, b, t, torch.full_like(b, cid),
                    torch.full_like(b, g), sub)
                zr, idr, _tk = _take(gz, gi, zr, idr)
        z[r], fid[r] = zr, idr
    if stats is not None:
        stats["visits"] = torch.cat(visits) if visits else \
            torch.zeros((0, 3), dtype=torch.int64, device=dev)
    return (*_outputs(z, fid, B, height, width), sflags.reshape(B, T, S))


def chunk_flags_v6(slot_flags, units, counts6, masks, nsub: int):
    """Variant 6's per-(image, tile, chunk) flags (B, T, nch) uint8, the
    contract of K1's: each slot's flag goes to its unit's chunk (by max);
    a tile with more than S units takes its overlap row; the result is
    ANDed with the overlap (`_rasterize_pallas_T` :874-879)."""
    S = units.shape[-1]
    won = torch.zeros(masks.shape, dtype=torch.int32, device=masks.device)
    won.scatter_reduce_(2, (units // nsub).long(), slot_flags.to(torch.int32),
                        "amax")
    overlap = masks > 0
    won = torch.where((counts6 <= S)[..., None], won > 0, overlap) & overlap
    return won.to(torch.uint8)


def _device(table):
    dev = table.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _outputs_cuda(B, resolution, nflags, device):
    """The visibility kernels' outputs: z and face_id (B, H, W), which every
    kernel writes in full, and zeroed flags (B, T, nflags) uint8."""
    height, width = resolution
    T = (height // TILE_H) * (width // TILE_W)
    z = torch.empty((B, height, width), dtype=torch.float32, device=device)
    fid = torch.empty((B, height, width), dtype=torch.int32, device=device)
    flags = torch.zeros((B, T, nflags), dtype=torch.uint8, device=device)
    return z, fid, flags


# the largest dynamic shared memory a block may have on the H100
SMEM_MAX = 227 * 1024
# K1's and K2's shared memory per block, which sets the depth of their ring
# of staged sub-blocks: two at chunk 1024, nsub 8 (K1's slots hold 60 bytes
# a face, K2's 56), and eight blocks on an SM (1,056 of the 1,280 blocks of
# 10 images at 256² at once)
K1_SMEM = 22 * 1024
# K3's: a ring of two units at chunk 1024, nsub 8 and a split of 4
K3_SMEM = 24 * 1024
# the blocks (a cluster) over which K3 splits a tile of more than S units:
# its units by cull box (404 at most on the full-width meshes) split to
# about a dense tile's S = 128 (1, 2, 4 or 8)
K3_SPLIT = 4


def visibility(table, orig, order, counts, masks, zlo, fbox, resolution,
               nsub: int):
    """Visibility on the tensors' device: the CUDA kernel K1 for CUDA
    tensors, `visibility_reference` for CPU tensors. fbox: the cull boxes
    of `prepare` (`cull`), checked on either device. Raises ValueError on
    inputs the kernel does not take: a sub-block and chunk list that
    overflow shared memory. Adds one to `visibility.launches` per kernel
    launch."""
    _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub,
                  fbox)
    if _device(table).type == "cpu":
        return visibility_reference(table, orig, order, counts, masks, zlo,
                                    resolution, nsub)
    height, width = resolution
    B, nch, _, chunk = table.shape
    lib = kernels.library()
    if lib.raster_vis_smem(chunk, nsub, nch) > SMEM_MAX:
        raise ValueError(f"K1: sub-block of {chunk // nsub} faces and "
                         f"{nch} chunks exceed shared memory")
    T = (height // TILE_H) * (width // TILE_W)
    z, fid, flags = _outputs_cuda(B, resolution, nch, table.device)
    kernels.launch(lib.raster_vis_launch, "raster_vis", table, orig, order,
                   counts, masks, zlo, fbox, z, fid, flags, B, T,
                   width // TILE_W, nch, chunk, nsub, height, width, K1_SMEM)
    visibility.launches += 1
    return z, fid, flags


visibility.launches = 0
tracing.register_launches(visibility)


def orig_of_runs(bbase):
    """The original id of every sorted slot (nch·chunk,) int32 from the run
    bases of variant 4: orig[s] = bbase[s // 32] + s % 32."""
    run = torch.arange(BLOCK, dtype=torch.int32, device=bbase.device)
    return (bbase[:, None] + run).reshape(-1)


def visibility_v4(table, bbase, order, counts, masks, zlo, fbox, resolution,
                  nsub: int):
    """Variant 4 visibility: the CUDA kernel K2 for CUDA tensors,
    `visibility_reference` (on `orig_of_runs(bbase)`) for CPU tensors; the
    same outputs as `visibility`. bbase: the run bases of `prepare(variant=
    4)`; fbox: its cull boxes. Raises ValueError on inputs the kernel does
    not take: a sub-block that is not whole 32-face runs, a sub-block and
    chunk list that overflow shared memory. Adds one to
    `visibility_v4.launches` per kernel launch."""
    _check_inputs(table, bbase, order, counts, masks, zlo, resolution, nsub,
                  fbox, ids="bbase")
    B, nch, _, chunk = table.shape
    if _device(table).type == "cpu":
        return visibility_reference(table, orig_of_runs(bbase), order,
                                    counts, masks, zlo, resolution, nsub)
    height, width = resolution
    lib = kernels.library()
    if lib.raster_vis_v4_smem(chunk, nsub, nch) > SMEM_MAX:
        raise ValueError(f"K2: sub-block of {chunk // nsub} faces and "
                         f"{nch} chunks exceed shared memory")
    T = (height // TILE_H) * (width // TILE_W)
    z, fid, flags = _outputs_cuda(B, resolution, nch, table.device)
    kernels.launch(lib.raster_vis_v4_launch, "raster_vis_v4", table, bbase,
                   order, counts, masks, zlo, fbox, z, fid, flags, B, T,
                   width // TILE_W, nch, chunk, nsub, height, width, K1_SMEM)
    visibility_v4.launches += 1
    return z, fid, flags


visibility_v4.launches = 0
tracing.register_launches(visibility_v4)


def visibility_v6(table, orig, units, counts6, zu, fbox, ubox, resolution,
                  nsub: int):
    """Variant 6 (dense unit lists) visibility: the CUDA kernel K3 for CUDA
    tensors, `visibility_v6_reference` for CPU tensors; returns z,
    face_id and slot flags (B, T, S) uint8. fbox, ubox: the face and unit
    cull boxes of `prepare`, checked on either device. Raises ValueError
    on inputs the kernel does not take: a list and sub-block that overflow
    shared memory, a `K3_SPLIT` other than 1, 2, 4 or 8. Adds one to
    `visibility_v6.launches` per kernel launch."""
    _check_inputs_v6(table, orig, units, counts6, zu, resolution, nsub, fbox,
                     ubox)
    if _device(table).type == "cpu":
        return visibility_v6_reference(table, orig, units, counts6, zu,
                                       resolution, nsub)
    height, width = resolution
    B, nch, _, chunk = table.shape
    S = units.shape[-1]
    if K3_SPLIT not in (1, 2, 4, 8):
        raise ValueError(f"K3_SPLIT {K3_SPLIT}: want 1, 2, 4 or 8")
    lib = kernels.library()
    if lib.raster_vis_v6_smem(chunk, nsub, nch, S, K3_SPLIT) > SMEM_MAX:
        raise ValueError(f"K3: sub-block of {chunk // nsub} faces and "
                         f"{nch * nsub} units exceed shared memory")
    T = (height // TILE_H) * (width // TILE_W)
    z, fid, sflags = _outputs_cuda(B, resolution, S, table.device)
    kernels.launch(lib.raster_vis_v6_launch, "raster_vis_v6", table, orig,
                   units, counts6, zu, fbox, ubox, z, fid, sflags, B, T,
                   width // TILE_W, nch, chunk, nsub, S, height, width,
                   K3_SMEM, K3_SPLIT)
    visibility_v6.launches += 1
    return z, fid, sflags


visibility_v6.launches = 0
tracing.register_launches(visibility_v6)


def rasterize_cuda(v_clip, faces, f_valid, resolution, v_pos0,
                   chunk: int = 1024, variant: int = 3, v6_cap: int = 128,
                   nsub: int = NSUB) -> Rast:
    """Rasterize (B, V, 4) clip-space vertices with the tile kernel of
    `variant` (3: K1, 4: K2, 6: K3; the counterpart of
    `rasterize_pallas(..., fv_rows=...)` under `A3D_RASTER_V`, with
    `v6_cap` for `A3D_V6_CAP` and `nsub` for `A3D_NSUB`). v_pos0: (V, 3)
    batch-0 world positions for the shared face order. The Rast's uv is
    None: `resolve` recomputes the barycentrics it needs. Raises
    ValueError for a variant that cannot run on these shapes."""
    prep = prepare(v_clip, v_pos0, faces, f_valid, resolution, chunk, nsub,
                   variant, v6_cap)
    common = (prep["table"], prep["orig"])
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    if variant == 3:
        z, fid, flags = visibility(*common, *lists, prep["fbox"], resolution,
                                   prep["nsub"])
    elif variant == 4:
        z, fid, flags = visibility_v4(prep["table"], prep["bbase"], *lists,
                                      prep["fbox"], resolution, prep["nsub"])
    else:
        z, fid, sflags = visibility_v6(*common, prep["units"],
                                       prep["counts6"], prep["zu"],
                                       prep["fbox"], prep["ubox"],
                                       resolution, prep["nsub"])
        flags = chunk_flags_v6(sflags, prep["units"], prep["counts6"],
                               prep["masks"], prep["nsub"])
    return Rast(uv=None, z=z, face_id=fid, flags=flags)
