"""Base predictor: category prior shape (SDF + marching tets) and the DINO
feature field (port of `animals3d_tpu.predictors.base`).

The eval path sweeps the SDF MLP densely over the lattice; the banded and
fused sweeps of the JAX package (training / offline options) are not
ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from animals3d_tpu_torch.geometry.mesh import make_mesh
from animals3d_tpu_torch.networks.mlp import CoordMLP
from animals3d_tpu_torch.ops import dmtet
from animals3d_tpu_torch.predictors.config import BasePredictorConfig


class BasePredictor(nn.Module):

    def __init__(self, cfg: BasePredictorConfig):
        super().__init__()
        self.cfg = cfg
        shape = cfg.cfg_shape
        if shape.sparse_band_eval:
            raise NotImplementedError("the banded SDF sweep is not ported")
        scalar = 2 * np.pi / shape.spatial_scale * 0.9
        self.netSDF = CoordMLP(
            3, 1, shape.num_layers, nf=shape.hidden_size, activation=None,
            min_max=None, n_harmonic_functions=shape.embedder_freq,
            embedder_scalar=scalar, embed_concat_pts=shape.embed_concat_pts)
        dino = cfg.cfg_dino
        self.netDINO = CoordMLP(
            3, dino.feature_dim, dino.num_layers, nf=dino.hidden_size,
            activation=dino.activation,
            min_max=(tuple(dino.minmax),) * dino.feature_dim,
            n_harmonic_functions=dino.embedder_freq, embedder_scalar=scalar,
            embed_concat_pts=dino.embed_concat_pts,
            symmetrize=dino.symmetrize)

    def get_sdf(self, pts):
        """SDF with x-mirror symmetrization and analytic init bias."""
        shape = self.cfg.cfg_shape
        pts_in = torch.cat([pts[..., :1].abs(), pts[..., 1:]], -1) \
            if shape.symmetrize else pts
        sdf = self.netSDF(pts_in)
        init = shape.init_sdf
        if init is None:
            pass
        elif isinstance(init, (int, float)):
            sdf = sdf + init
        elif init == "sphere":
            r = shape.spatial_scale * 0.25
            sdf = sdf + (r - torch.linalg.norm(pts, dim=-1, keepdim=True))
        elif init == "ellipsoid":
            r = shape.spatial_scale * 0.15
            scaled = torch.cat([pts[..., :2], pts[..., 2:] / 2], -1)
            sdf = sdf + (r - torch.linalg.norm(scaled, dim=-1, keepdim=True))
        else:
            raise NotImplementedError(init)
        return sdf

    def dino_field(self, pts):
        return self.netDINO(pts)

    def get_prior_mesh(self, grid, v_cap: int, f_cap: int):
        """SDF over the lattice (no jitter at eval) → marching tets →
        batch-1 Mesh. Returns (mesh, sdf)."""
        pos = grid.verts * self.cfg.cfg_shape.spatial_scale
        sdf = self.get_sdf(pos)[..., 0]
        out = dmtet.marching_tets(pos, sdf, grid, v_cap, f_cap)
        mesh = make_mesh(out.verts[None], out.faces, out.v_valid,
                         out.f_valid, out.num_verts, out.num_faces,
                         face_gidx=out.face_gidx)
        return mesh, sdf

    def forward(self, grid, v_cap: int, f_cap: int):
        return self.get_prior_mesh(grid, v_cap, f_cap)
