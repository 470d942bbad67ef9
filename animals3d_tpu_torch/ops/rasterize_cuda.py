"""Tile visibility rasterizer: a hand-written CUDA kernel for Hopper
(`csrc/raster_vis.cu`) and its plain PyTorch version.

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
    front to back by z-min, with an 8-bit mask of overlapping sub-blocks.

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

On a CPU tensor `visibility` runs the plain version; on a CUDA tensor it
launches the kernel (built from source with `nvcc` at first use into
`_build/`) or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

from animals3d_tpu_torch.ops.rasterize import (Rast, affine,
                                              compute_barycentrics)

BIG = 3.0e38
TILE_H = 16          # pixel tile height
TILE_W = 32          # pixel tile width
TP = TILE_H * TILE_W
BLOCK = 32           # face-block granularity of the Morton order
NSUB = 8             # sub-blocks per chunk for the bbox mask
ZQ_SCALE = 1048576.0
ZQ_CLAMP = 8.0
_INT_MAX = 2 ** 31 - 1

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "csrc", "raster_vis.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


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


def prepare(v_clip, v_pos0, faces, f_valid, resolution, chunk: int = 1024):
    """Everything the visibility kernel reads (see the module docstring).

    v_clip (B, V, 4) clip positions; v_pos0 (V, 3) batch-0 world positions
    (they key the shared Morton block order); faces (F, 3); f_valid (F,).
    Returns a dict: table (B, nch, 12, chunk) f32 rows [a0 a1 a2 az | b0 b1
    b2 bz | c0 c1 c2 cz] so that e = (a·px + b·py) + c; orig (nch·chunk,)
    int32 original face id per sorted slot; order (B, T, nch) int32 chunk
    ids front to back (overlapping ones first); counts (B, T) int32;
    masks (B, T, nch) int32 sub-block overlap bits by chunk id; zlo
    (B, nch) int32 quantized chunk z-min; nsub.
    """
    height, width = resolution
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"resolution {resolution} must be a multiple of "
                         f"({TILE_H}, {TILE_W})")
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
    nsub = NSUB if chunk % NSUB == 0 and chunk >= NSUB else 1
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
    return {"table": table, "orig": orig.to(torch.int32).contiguous(),
            "order": order.contiguous(), "counts": counts.contiguous(),
            "masks": masks.contiguous(), "zlo": zlo.contiguous(),
            "nsub": nsub}


def _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub):
    B, nch, rows, chunk = table.shape
    height, width = resolution
    T = (height // TILE_H) * (width // TILE_W)
    want = {"table": (table, torch.float32, (B, nch, 12, chunk)),
            "orig": (orig, torch.int32, (nch * chunk,)),
            "order": (order, torch.int32, (B, T, nch)),
            "counts": (counts, torch.int32, (B, T)),
            "masks": (masks, torch.int32, (B, T, nch)),
            "zlo": (zlo, torch.int32, (B, nch))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
    if height % TILE_H or width % TILE_W or chunk % nsub:
        raise ValueError(f"bad resolution {resolution} / chunk {chunk} / "
                         f"nsub {nsub}")
    if (chunk // nsub) * 13 * 4 > 227 * 1024:
        raise ValueError(f"sub-block of {chunk // nsub} faces exceeds "
                         "shared memory")


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
    sub_ar = torch.arange(sub, device=dev)
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
            if stats is not None:
                visits.append(torch.stack(
                    [ba, t[act], ca, torch.full_like(ca, g)], 1))
            cf = table[ba, ca, :, g * sub:(g + 1) * sub]   # (Ra, 12, sub)
            ids = orig[(ca * chunk + g * sub)[:, None] + sub_ar]
            X = px[t[act]][:, :, None]
            Y = py[t[act]][:, :, None]

            def ev(i):
                return affine(cf[:, i, None, :], cf[:, i + 4, None, :],
                              cf[:, i + 8, None, :], X, Y)
            m = torch.minimum(torch.minimum(ev(0), ev(1)), ev(2))
            zcand = torch.where(m >= 0, ev(3), torch.full_like(m, BIG))
            gz = zcand.amin(-1)
            gid = torch.where(zcand <= gz[..., None], ids[:, None, :],
                              torch.full_like(ids[:, None, :], _INT_MAX)) \
                .amin(-1)
            gi = gid + 1
            za, ia = zr[act], idr[act]
            take = (gz < za) | ((gz == za) & (za < BIG) & (gi < ia))
            zr[act] = torch.where(take, gz, za)
            idr[act] = torch.where(take, gi, ia)
            took[act] |= take
        z[r], fid[r] = zr, idr
        flags[r, cid] = took.any(1).to(torch.uint8)
    if stats is not None:
        stats["visits"] = torch.cat(visits) if visits else \
            torch.zeros((0, 4), dtype=torch.int64, device=dev)
    z = torch.where(fid > 0, z, torch.zeros_like(z))
    return (_untile(z, B, height, width), _untile(fid, B, height, width),
            flags.reshape(B, T, nch))


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def library_path() -> str:
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()) \
            .hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libraster_vis-{digest}.so")


def build() -> str:
    """Compile the kernel library with nvcc unless it is already built.
    Returns the compiler's output (register and shared-memory use)."""
    out = library_path()
    if os.path.exists(out):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", _SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out}:\n{proc.stdout}")
    os.replace(out + ".tmp", out)
    return proc.stdout


_LIB = None


def _library():
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(library_path())
        lib.raster_vis_launch.argtypes = [ctypes.c_void_p] * 9 + \
            [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.raster_vis_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def visibility(table, orig, order, counts, masks, zlo, resolution,
               nsub: int):
    """Visibility on the tensors' device: the CUDA kernel for CUDA
    tensors, `visibility_reference` for CPU tensors. Adds one to
    `visibility.launches` per kernel launch."""
    dev = table.device
    if dev.type == "cpu":
        return visibility_reference(table, orig, order, counts, masks, zlo,
                                    resolution, nsub)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_inputs(table, orig, order, counts, masks, zlo, resolution, nsub)
    height, width = resolution
    B, nch, _, chunk = table.shape
    T = (height // TILE_H) * (width // TILE_W)
    lib = _library()
    z = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    fid = torch.empty((B, height, width), dtype=torch.int32, device=dev)
    flags = torch.zeros((B, T, nch), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.raster_vis_launch(
            table.data_ptr(), orig.data_ptr(), order.data_ptr(),
            counts.data_ptr(), masks.data_ptr(), zlo.data_ptr(),
            z.data_ptr(), fid.data_ptr(), flags.data_ptr(),
            B, T, width // TILE_W, nch, chunk, nsub, height, width, stream)
    if err != 0:
        raise RuntimeError(f"raster_vis kernel launch failed: cudaError {err}")
    visibility.launches += 1
    return z, fid, flags


visibility.launches = 0


def rasterize_cuda(v_clip, faces, f_valid, resolution, v_pos0,
                   chunk: int = 1024) -> Rast:
    """Rasterize (B, V, 4) clip-space vertices with the tile kernel (the
    counterpart of `rasterize_pallas(..., fv_rows=...)`). v_pos0: (V, 3)
    batch-0 world positions for the shared face order."""
    prep = prepare(v_clip, v_pos0, faces, f_valid, resolution, chunk)
    z, fid, flags = visibility(prep["table"], prep["orig"], prep["order"],
                               prep["counts"], prep["masks"], prep["zlo"],
                               resolution, prep["nsub"])
    uv = compute_barycentrics(v_clip, faces, fid, resolution)
    return Rast(uv=uv, z=z, face_id=fid, flags=flags)
