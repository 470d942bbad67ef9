"""Shading math: normal preparation (port of `animals3d_tpu.ops.shading`,
the reference's renderutils family). Elementwise chains; autograd gives
their backward. The port's BSDFs, sRGB and image losses serve no cell of
the benchmark and are left out of this copy."""
from __future__ import annotations

import torch

_NORMAL_THRESHOLD = 0.1


def dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def reflect(x, n):
    return 2 * dot(x, n) * n - x


def safe_normalize(x, eps=1e-20):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def prepare_shading_normal(pos, view_pos, smooth_nrm, geom_nrm,
                           two_sided_shading: bool = True,
                           perturbed_nrm=None, smooth_tng=None,
                           opengl: bool = True):
    """Bent shading normal. With a tangent-space `perturbed_nrm` (a normal
    map) the smooth normal is first bent by it in the (tangent,
    bitangent, normal) frame of `smooth_tng`; then, for back-facing
    surfaces, both normals flip, and the geometric normal blends into the
    smooth one by how much the smooth normal faces the viewer (threshold
    0.1)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if perturbed_nrm is not None:
        smooth_tng = safe_normalize(smooth_tng)
        bitng = safe_normalize(torch.linalg.cross(
            *torch.broadcast_tensors(smooth_tng, smooth_nrm)))
        sgn = -1.0 if opengl else 1.0
        smooth_nrm = safe_normalize(
            smooth_tng * perturbed_nrm[..., 0:1]
            + sgn * bitng * perturbed_nrm[..., 1:2]
            + smooth_nrm * torch.clamp(perturbed_nrm[..., 2:3], min=0.0))
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / _NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)


# ---- BSDFs (`renderutils/bsdf.py:57-160`) ----------------------------------
