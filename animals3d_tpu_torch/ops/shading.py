"""Shading-normal math used by `render_mesh`
(port of the relevant part of `animals3d_tpu.ops.shading`)."""
from __future__ import annotations

import torch

_NORMAL_THRESHOLD = 0.1


def dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def safe_normalize(x, eps=1e-20):
    return x * torch.rsqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


def prepare_shading_normal(pos, view_pos, smooth_nrm, geom_nrm,
                           two_sided_shading: bool = True):
    """Bent shading normal with no normal map (the training/eval path):
    flip for back-facing surfaces, then blend geometric → smooth normal by
    how much the smooth normal faces the viewer (threshold 0.1)."""
    smooth_nrm = safe_normalize(smooth_nrm)
    view_vec = safe_normalize(view_pos - pos)
    if two_sided_shading:
        front = dot(geom_nrm, view_vec) > 0
        smooth_nrm = torch.where(front, smooth_nrm, -smooth_nrm)
        geom_nrm = torch.where(front, geom_nrm, -geom_nrm)
    t = torch.clamp(dot(view_vec, smooth_nrm) / _NORMAL_THRESHOLD, 0.0, 1.0)
    return geom_nrm + t * (smooth_nrm - geom_nrm)
