"""Resolve rows, forward and backward: hand-written CUDA kernels for
Hopper (`csrc/resolve_fwd.cu`, `csrc/resolve_bwd.cu`) and their plain
PyTorch versions.

`resolve_bwd` ports the Pallas kernel `_resolve_bwd_kernel`
(`animals3d_tpu/ops/rasterize_pallas.py:1097`, launched by
`resolve_grad_pallas`): the transpose of the per-pixel row gather of
`ops.rasterize.resolve`,

    d_pf[b, f, :] = Σ g[b, p, :] over the pixels p whose winner is face f.

Only the contract is kept; the TPU's one-hot matrix product, tile lists
and Morton id synthesis have no counterpart. Background pixels
(`face_id == 0`) contribute nothing whatever their cotangent holds. The
kernel is bound by bytes; it scatters with float32 atomics, so where a
face collects several pixels the order of the additions changes from run
to run.

`resolve_fwd` ports `_resolve_fwd_kernel` (:1269, launched by
`resolve_rows_pallas` :1326): the rows pf[b, face_id − 1] of every pixel,
written channel-major in tile order (B, R, T·TP), the layout the tile-order
branch of `resolve` consumes. On the TPU it is a one-hot matrix product
over the rasterizer's winner-chunk lists, because the TPU gathers rows
slowly; here a pixel's winner id addresses its row directly, so the kernel
needs neither the winner-chunk lists nor the flags. Background rows are
zero (the JAX contract lets them alias face 0; `resolve` masks them
anyway). The kernel gives each warp a tile row of 32 pixels (eight of
them a block, a half tile): the warp copies the whole row of each run of
its pixels with one winner into shared memory (`cp.async`, a row read
once per run, consecutive lanes on consecutive addresses), and each lane
then writes its pixel's channels from there, so that a warp stores 128
contiguous bytes of each channel's tile-order segment.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel from the library of `ops.kernels` or raises.
"""
from __future__ import annotations

import torch

from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.ops import kernels

TILE_H, TILE_W = 16, 32          # the visibility kernels' pixel tiles
TP = TILE_H * TILE_W


def _check(g, face_id, num_faces):
    if g.ndim != 3 or g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: want float32 or bfloat16 (B, P, R), got "
                         f"{g.dtype} {tuple(g.shape)}")
    kernels.check_tensors({"g": (g, g.dtype, g.shape),
                           "face_id": (face_id, torch.int32, g.shape[:2])},
                          g.device)
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
    """d_pf (B, F, R) float32 from pixel cotangents g (B, P, R) (float32 or
    bfloat16; accumulated in float32) and 1-based winner ids face_id (B, P)
    int32 (0 = background). The CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Adds one to `resolve_bwd.launches` per kernel
    launch."""
    dev = g.device
    if dev.type == "cpu":
        return resolve_bwd_reference(g, face_id, num_faces)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(g, face_id, num_faces)
    B, P, R = g.shape
    out = torch.zeros((B, num_faces, R), dtype=torch.float32, device=dev)
    kernels.launch(kernels.library().resolve_bwd_launch, "resolve_bwd", g,
                   face_id, out, B, P, R, num_faces,
                   int(g.dtype == torch.bfloat16))
    resolve_bwd.launches += 1
    return out


resolve_bwd.launches = 0
tracing.register_launches(resolve_bwd)


def _check_fwd(pf, face_id, resolution):
    height, width = resolution
    if height % TILE_H or width % TILE_W:
        raise ValueError(f"resolution {resolution} must be a multiple of "
                         f"({TILE_H}, {TILE_W})")
    if pf.ndim != 3 or pf.dtype != torch.float32 or pf.shape[1] == 0:
        raise ValueError(f"pf: want float32 (B, F, R), got {pf.dtype} "
                         f"{tuple(pf.shape)}")
    kernels.check_tensors({"pf": (pf, torch.float32, pf.shape),
                           "face_id": (face_id, torch.int32,
                                       (pf.shape[0], height * width))},
                          pf.device)


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
    """Resolve rows (B, R, T·TP) float32, channel-major in tile order, from
    per-face rows pf (B, F, R) float32 and 1-based winner ids face_id
    (B, H·W) int32 in raster order (0 = background, whose rows are zero).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Adds one to `resolve_fwd.launches` per kernel launch."""
    dev = pf.device
    if dev.type == "cpu":
        return resolve_fwd_reference(pf, face_id, resolution)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_fwd(pf, face_id, resolution)
    height, width = resolution
    B, F, R = pf.shape
    out = torch.empty((B, R, height * width), dtype=torch.float32, device=dev)
    kernels.launch(kernels.library().resolve_fwd_launch, "resolve_fwd", pf,
                   face_id, out, B, F, R, height, width)
    resolve_fwd.launches += 1
    return out


resolve_fwd.launches = 0
tracing.register_launches(resolve_fwd)
