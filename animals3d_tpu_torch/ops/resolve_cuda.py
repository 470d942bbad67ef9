"""Resolve backward: a hand-written CUDA kernel for Hopper
(`csrc/resolve_bwd.cu`) and its plain PyTorch version.

Port of the Pallas kernel `_resolve_bwd_kernel`
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

On CPU tensors `resolve_bwd` runs the plain version; on CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import torch


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
    from animals3d_tpu_torch.ops.rasterize_cuda import library
    lib = library()
    B, P, R = g.shape
    out = torch.zeros((B, num_faces, R), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.resolve_bwd_launch(
            g.data_ptr(), face_id.data_ptr(), out.data_ptr(), B, P, R,
            num_faces, int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"resolve_bwd kernel launch failed: cudaError "
                           f"{err}")
    resolve_bwd.launches += 1
    return out


resolve_bwd.launches = 0
