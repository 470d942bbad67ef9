"""Tile visibility, plain PyTorch: the prep (per-face affine rows, the
Morton face order, per-tile chunk lists, cull boxes) and the chunk-scan
visibility, `visibility_reference`, for every image.

Frozen copy of `animals3d_tpu_torch/ops/rasterize_cuda.py` (the port's
plain versions) for the benchmark's reference: the kernel build, binding
and launches are taken out, so every call runs the plain version on the
tensors' device. Ties on exactly equal z go to the smallest original face
id; every affine function is (a·px + b·py) + c with no fused
multiply-add (`ops.rasterize.affine`).
"""
from __future__ import annotations

from typing import Optional

import torch

from refmodel import probe
from refmodel.ops.rasterize import Rast, affine

BIG = 3.0e38
TILE_H = 16          # pixel tile height
TILE_W = 32          # pixel tile width
TP = TILE_H * TILE_W
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
            nsub: int = NSUB):
    """Everything the visibility kernel reads (see the module docstring).

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
    (`cull`).
    """
    height, width = resolution
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"resolution {resolution} must be a multiple of "
                         f"({TILE_H}, {TILE_W})")
    if not 1 <= nsub <= 16:
        raise ValueError(f"nsub {nsub}: want 1 to 16")
    nsub = nsub if chunk % nsub == 0 and chunk >= nsub else 1
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
    out["fbox"] = cull(table, resolution)
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
    """The per-face cull boxes: `cull_boxes` on any device."""
    return cull_boxes(table, resolution)


def _check(tensors, device):
    """tensors: name → (tensor, dtype, shape); each must match, be
    contiguous and lie on `device`."""
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, table on {device}")


def _check_table(table, orig, resolution, nsub):
    """The table, the ids (`orig`, one a sorted slot) and the shapes the
    visibility kernel takes."""
    B, nch, rows, chunk = table.shape
    height, width = resolution
    if table.dtype != torch.float32 or rows != 12:
        raise ValueError(f"table: want float32 (B, nch, 12, chunk), got "
                         f"{table.dtype} {tuple(table.shape)}")
    _check({"table": (table, torch.float32, tuple(table.shape)),
            "orig": (orig, torch.int32, (nch * chunk,))}, table.device)
    if height % TILE_H or width % TILE_W or nsub < 1 or chunk % nsub:
        raise ValueError(f"bad resolution {resolution} / chunk {chunk} / "
                         f"nsub {nsub}")
    if (chunk // nsub) * 13 * 4 > 227 * 1024:
        raise ValueError(f"sub-block of {chunk // nsub} faces exceeds "
                         "shared memory")
    return B, nch, chunk, (height // TILE_H) * (width // TILE_W)


def _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub,
                  fbox=None):
    """The visibility inputs' types, shapes and device; and the cull boxes
    (B, nch·chunk, 4) int16 where given."""
    B, nch, chunk, T = _check_table(table, orig, resolution, nsub)
    want = {"order": (order, torch.int32, (B, T, nch)),
            "counts": (counts, torch.int32, (B, T)),
            "masks": (masks, torch.int32, (B, T, nch)),
            "zlo": (zlo, torch.int32, (B, nch))}
    if fbox is not None:
        want["fbox"] = (fbox, torch.int16, (B, nch * chunk, 4))
    _check(want, table.device)


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
    occlusion test or the sub-block mask."""
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


def rasterize_cuda(v_clip, faces, f_valid, resolution, v_pos0,
                   chunk: int = 1024, nsub: int = NSUB) -> Rast:
    """Rasterize (B, V, 4) clip-space vertices with the plain version of
    the default tile kernel (K1). v_pos0: (V, 3) batch-0 world positions
    for the shared face order. The Rast's uv is None: `resolve` recomputes
    the barycentrics it needs."""
    prep = prepare(v_clip, v_pos0, faces, f_valid, resolution, chunk, nsub)
    _check_inputs(prep["table"], prep["orig"], prep["order"],
                  prep["counts"], prep["masks"], prep["zlo"], resolution,
                  prep["nsub"], prep["fbox"])
    stats = {} if probe.active() else None
    z, fid, flags = visibility_reference(
        prep["table"], prep["orig"], prep["order"], prep["counts"],
        prep["masks"], prep["zlo"], resolution, prep["nsub"], stats=stats)
    if stats is not None:
        probe.record("raster", v_clip=v_clip, faces=faces, prep=prep,
                     resolution=resolution, visits=stats["visits"],
                     outputs=(z, fid, flags))
    return Rast(uv=None, z=z, face_id=fid, flags=flags)
