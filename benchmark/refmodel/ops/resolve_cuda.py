"""Resolve rows, forward and backward, plain PyTorch: the per-pixel row
gather of `ops.rasterize.resolve` (`resolve_fwd`, channel-major in tile
order) and its transpose,

    d_pf[b, f, :] = sum of g[b, p, :] over the pixels p whose winner is f,

with background pixels (`face_id == 0`) contributing nothing.

Frozen copy of the plain versions in `animals3d_tpu_torch/ops/resolve_cuda.py`
for the benchmark's reference; the kernel launches are taken out.
"""
from __future__ import annotations

import torch

from refmodel import probe


def _check(g, face_id, num_faces):
    if g.ndim != 3 or g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: want float32 or bfloat16 (B, P, R), got "
                         f"{g.dtype} {tuple(g.shape)}")
    if face_id.dtype != torch.int32 or tuple(face_id.shape) != g.shape[:2]:
        raise ValueError(f"face_id: want int32 {tuple(g.shape[:2])}, got "
                         f"{face_id.dtype} {tuple(face_id.shape)}")
    if not g.is_contiguous() or not face_id.is_contiguous():
        raise ValueError("g and face_id must be contiguous")
    if face_id.device != g.device:
        raise ValueError(f"face_id is on {face_id.device}, g on {g.device}")
    if num_faces <= 0:
        raise ValueError(f"num_faces {num_faces}")


def resolve_bwd_reference(g, face_id, num_faces: int):
    """Plain PyTorch version of `resolve_bwd`: one `index_add_` per image
    on the 0-based face ids, background rows masked to zero."""
    _check(g, face_id, num_faces)
    B, _P, R = g.shape
    out = torch.zeros((B, num_faces, R), dtype=torch.float32, device=g.device)
    fg = (face_id > 0) & (face_id <= num_faces)
    sel = torch.clamp(face_id.long() - 1, 0, num_faces - 1)
    rows = torch.where(fg[..., None], g.float(), torch.zeros((), device=g.device))
    for b in range(B):
        out[b].index_add_(0, sel[b], rows[b])
    return out


def resolve_bwd(g, face_id, num_faces: int):
    """d_pf (B, F, R) float32 from pixel cotangents g (B, P, R) and 1-based
    winner ids face_id (B, P) int32 (0 = background): the plain version."""
    if probe.active():
        fg = (face_id > 0) & (face_id <= num_faces)
        rows = torch.arange(g.shape[0], device=g.device)[:, None] \
            * (num_faces + 1) + face_id.long()
        probe.record("resolve_bwd", B=g.shape[0], P=g.shape[1], R=g.shape[2],
                     F=num_faces, fg=int(fg.sum()),
                     rows=int(torch.unique(rows[fg]).numel()))
    return resolve_bwd_reference(g, face_id, num_faces)


TILE_H, TILE_W = 16, 32          # the visibility kernels' pixel tiles
TP = TILE_H * TILE_W


def _check_fwd(pf, face_id, resolution):
    height, width = resolution
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"resolution {resolution} must be a multiple of "
                         f"({TILE_H}, {TILE_W})")
    if pf.ndim != 3 or pf.dtype != torch.float32 or pf.shape[1] == 0:
        raise ValueError(f"pf: want float32 (B, F, R), got {pf.dtype} "
                         f"{tuple(pf.shape)}")
    want = (pf.shape[0], height * width)
    if face_id.dtype != torch.int32 or tuple(face_id.shape) != want:
        raise ValueError(f"face_id: want int32 {want}, got {face_id.dtype} "
                         f"{tuple(face_id.shape)}")
    if not pf.is_contiguous() or not face_id.is_contiguous():
        raise ValueError("pf and face_id must be contiguous")
    if face_id.device != pf.device:
        raise ValueError(f"face_id is on {face_id.device}, pf on {pf.device}")


def to_tile_order(x, resolution):
    """(B, H·W, R) raster-order rows → (B, R, T·TP) channel-major in tile
    order (tile-major over 16×32 tiles, rows within a tile)."""
    height, width = resolution
    B, _P, R = x.shape
    nty, ntx = height // TILE_H, width // TILE_W
    return x.reshape(B, nty, TILE_H, ntx, TILE_W, R) \
        .permute(0, 5, 1, 3, 2, 4).reshape(B, R, height * width)


def from_tile_order(x, resolution):
    """The inverse of `to_tile_order`: (B, R, T·TP) → (B, H·W, R)."""
    height, width = resolution
    B, R, _P = x.shape
    nty, ntx = height // TILE_H, width // TILE_W
    return x.reshape(B, R, nty, ntx, TILE_H, TILE_W) \
        .permute(0, 2, 4, 3, 5, 1).reshape(B, height * width, R)


def resolve_fwd_reference(pf, face_id, resolution):
    """Plain PyTorch version of `resolve_fwd`: an index into pf and the
    permute to tile order, background rows zero."""
    _check_fwd(pf, face_id, resolution)
    B, F, R = pf.shape
    fg = (face_id > 0) & (face_id <= F)
    sel = torch.clamp(face_id.long() - 1, 0, F - 1)
    rows = pf[torch.arange(B, device=pf.device)[:, None], sel]   # (B, P, R)
    rows = torch.where(fg[..., None], rows, torch.zeros((), device=pf.device))
    return to_tile_order(rows, resolution).contiguous()


def resolve_fwd(pf, face_id, resolution):
    """Resolve rows (B, R, T·TP) float32, channel-major in tile order: the
    plain version."""
    return resolve_fwd_reference(pf, face_id, resolution)
