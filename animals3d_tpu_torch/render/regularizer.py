"""Mesh smoothness regularizers (port of `animals3d_tpu.render.
regularizer`): the uniform Laplacian and a normal-consistency term,
capacity-aware (invalid vertices and faces contribute nothing). An API of
the reference that no training path uses."""
from __future__ import annotations

import torch

from animals3d_tpu_torch.geometry.mesh import Mesh


def laplace_regularizer_const(mesh: Mesh):
    """Mean over valid vertices of ||Σ_j (v_j − v_i)||² / deg², the sums
    over each vertex's face edges."""
    v = mesh.v_pos                                    # (B, V, 3)
    f = mesh.t_pos_idx
    B, V, _ = v.shape
    w = mesh.f_valid.to(v.dtype)
    acc = v.new_zeros((B, V, 3))
    deg = v.new_zeros((V,))
    for a, b in ((0, 1), (1, 2), (2, 0)):
        va, vb = f[:, a], f[:, b]
        d = (v[:, vb] - v[:, va]) * w[None, :, None]
        acc = acc.index_add(1, va, d).index_add(1, vb, -d)
        deg = deg.index_add(0, va, w).index_add(0, vb, w)
    lap = acc / torch.clamp(deg, min=1.0)[None, :, None]
    sq = (lap * lap).sum(-1)
    valid = mesh.v_valid[None].to(v.dtype)
    return (sq * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def normal_consistency(mesh: Mesh):
    """1 − cos between the vertex normals at both ends of each valid
    face's edges, averaged over the edges and then the batch."""
    f = mesh.t_pos_idx
    n = mesh.v_nrm                                    # (B, V, 3)
    adj = torch.cat([f[:, 0:2], f[:, 1:3], f[:, ::2]], 0)        # (3F, 2)
    w = torch.cat([mesh.f_valid] * 3).to(n.dtype)
    d = 1.0 - (n[:, adj[:, 0]] * n[:, adj[:, 1]]).sum(-1)        # (B, 3F)
    return ((d * w).sum(-1) / torch.clamp(w.sum(), min=1.0)).mean()
