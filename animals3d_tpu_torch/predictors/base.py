"""Base predictor: category prior shape (SDF + marching tets) and the DINO
feature field (port of `animals3d_tpu.predictors.base`).

The eval path sweeps the SDF MLP densely over the lattice, in blocks of
`EVAL_SWEEP_ROWS` rows (each row's value is the same function of that row
alone); training (jittered sweeps) goes through the fused kernels of
`ops.fused_mlp`, which keep the (N, 256) activations out of device memory.
With `condition_choice="mod"` (Fauna) the SDF is the weight-modulated
`CoordMLPMod`, conditioned by a (1, 128) feature that the DINO field takes
too; the fused sweep stays off for it, as in the JAX package. With
`cfg_shape.sparse_band_eval` on an even lattice of res 64 or more, the
banded sweep (`ops.dmtet.sdf_lattice_banded`) comes first: it evaluates
the coarse sublattice and a band of segments around the surface, both
recomputed in the backward, and neither fused kernel runs.

The eval prior (no jitter, no condition, grad off, as in `reconstruct`) is
a function of netBase's weights, the lattice and its caps, the config and
the numerics alone, so `get_prior_mesh` keeps the last one it made and
returns it again while none of those has changed: a parameter or buffer
written in place (its version), replaced (its identity or address), another
grid, resolution or cap, another precision policy, TF32 switched, or
inference mode entered or left. Any such change, and any call with
jitter, a condition, grad on or a lattice or weight made in inference mode,
computes the prior afresh.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.geometry.mesh import make_mesh
from animals3d_tpu_torch.networks.mlp import CoordMLP, CoordMLPMod
from animals3d_tpu_torch.noise import Noise, uniform
from animals3d_tpu_torch.ops import dmtet, fused_mlp
from animals3d_tpu_torch.precision import compute_dtype
from animals3d_tpu_torch.predictors.config import BasePredictorConfig

# rows of one block of the eval sweep: the plain MLP's (N, 256) float32
# activations of the 257³ lattice take 17 GB a layer
EVAL_SWEEP_ROWS = 1 << 21


class BasePredictor(nn.Module):
    """`condition_choice`: None, or "mod" for the modulated SDF (Fauna's
    bank); `dino_extra_feat_dim`: the width of the DINO field's condition
    (0, or the bank's dimension)."""

    def __init__(self, cfg: BasePredictorConfig,
                 condition_choice: Optional[str] = None,
                 dino_extra_feat_dim: int = 0):
        super().__init__()
        self.cfg = cfg
        self.condition_choice = condition_choice
        shape = cfg.cfg_shape
        scalar = 2 * np.pi / shape.spatial_scale * 0.9
        sdf_cls, extra = (CoordMLPMod, dict(condition_dim=128)) \
            if condition_choice == "mod" else (CoordMLP, {})
        self.netSDF = sdf_cls(
            3, 1, shape.num_layers, nf=shape.hidden_size, activation=None,
            min_max=None, n_harmonic_functions=shape.embedder_freq,
            embedder_scalar=scalar, embed_concat_pts=shape.embed_concat_pts,
            **extra)
        dino = cfg.cfg_dino
        self.netDINO = CoordMLP(
            3, dino.feature_dim, dino.num_layers, nf=dino.hidden_size,
            activation=dino.activation,
            min_max=(tuple(dino.minmax),) * dino.feature_dim,
            n_harmonic_functions=dino.embedder_freq, embedder_scalar=scalar,
            embed_concat_pts=dino.embed_concat_pts,
            extra_feat_dim=dino_extra_feat_dim, symmetrize=dino.symmetrize)
        # the last eval prior: (objects, values, storages, (mesh, sdf)) of
        # `_prior_inputs`
        self._held_prior = None

    def get_sdf(self, pts, feats=None):
        """SDF with x-mirror symmetrization and analytic init bias; `feats`
        conditions the modulated SDF."""
        shape = self.cfg.cfg_shape
        pts_in = torch.cat([pts[..., :1].abs(), pts[..., 1:]], -1) \
            if shape.symmetrize else pts
        sdf = self.netSDF(pts_in, feats) if self.condition_choice == "mod" \
            else self.netSDF(pts_in)
        init = self._init_sdf(pts)
        return sdf + (init[..., None] if torch.is_tensor(init) else init)

    def _eval_sdf(self, pos, feats=None):
        """`get_sdf(pos, feats)[..., 0]`, in blocks of `EVAL_SWEEP_ROWS`
        rows. Each row's value is a function of that row alone, and under
        autograd the blocks keep the same activations a single call
        would."""
        return torch.cat([self.get_sdf(pos[i:i + EVAL_SWEEP_ROWS],
                                       feats)[..., 0]
                          for i in range(0, pos.shape[0], EVAL_SWEEP_ROWS)])

    def dino_field(self, pts, feats=None):
        return self.netDINO(pts, feats)

    # ---- fused lattice sweep ---------------------------------------------
    def _use_fused_sweep(self, training: bool = False) -> bool:
        """Gate of the fused netSDF sweep (`ops.fused_mlp`): on for
        training (the backward recomputes the activations instead of
        storing 5 × (N, 256) of them), off for eval, and only for the
        unconditional 256-wide net: never for the modulated SDF."""
        shape = self.cfg.cfg_shape
        return (training and self.condition_choice != "mod"
                and shape.num_layers >= 2
                and shape.hidden_size == 256
                and fused_mlp.coordmlp_sweep_params_ok(self.netSDF,
                                                       shape.num_layers))

    def _init_sdf(self, pos):
        """The analytic init bias of `get_sdf`, (N,)."""
        shape = self.cfg.cfg_shape
        init = shape.init_sdf
        if init is None:
            return 0.0
        if isinstance(init, (int, float)):
            return init
        if init == "sphere":
            return shape.spatial_scale * 0.25 - torch.linalg.norm(pos, dim=-1)
        if init == "ellipsoid":
            scaled = torch.cat([pos[..., :2], pos[..., 2:] / 2], -1)
            return shape.spatial_scale * 0.15 \
                - torch.linalg.norm(scaled, dim=-1)
        raise NotImplementedError(init)

    def _fused_sdf_sweep(self, pos):
        """`get_sdf(pos)[..., 0]` with the MLP trunk evaluated by the fused
        kernels: the same symmetrize, harmonic embedding and init bias."""
        shape = self.cfg.cfg_shape
        pts_in = torch.cat([pos[..., :1].abs(), pos[..., 1:]], -1) \
            if shape.symmetrize else pos
        sdf = fused_mlp.mlp_sweep(self.netSDF, self.netSDF.embed(pts_in),
                                  num_layers=shape.num_layers)
        return sdf + self._init_sdf(pos)

    def _use_band(self, grid) -> bool:
        """Gate of the banded sweep: the option, on an even lattice of res
        64 or more."""
        return (self.cfg.cfg_shape.sparse_band_eval and grid.is_lattice
                and grid.res % 2 == 0 and grid.res >= 64)

    # ---- prior mesh -------------------------------------------------------
    def get_prior_mesh(self, grid, v_cap: int, f_cap: int, jitter=None,
                       feats=None):
        """Optional global grid jitter → SDF over the grid → marching
        tets → batch-1 Mesh. `jitter` is a uniform [0, 1) scalar (None at
        eval): the grid shifts by (2·jitter − 1)·jitter_grid·scale; the
        sweep is banded where `_use_band` lets it, else goes through the
        fused kernels where their gate lets it. `feats` (1, 128)
        conditions the modulated SDF. Returns (mesh, sdf).

        With no jitter, no `feats` and grad off, the call returns the
        (mesh, sdf) it returned last, the same tensors, unless an input
        of `_prior_inputs` changed since; then it computes and keeps the
        new pair. Callers read the pair and never write into it. Counters
        (`tracing.count`): `netbase.prior_hits` (held pair returned),
        `netbase.prior_misses` (computed and kept), `netbase.prior_bypass`
        (jitter, `feats`, grad, or an input made in inference mode:
        computed, not kept); on a hit, the held mesh's `mesh.faces` and
        `mesh.face_slots`, as marching tets counts them."""
        inputs = None
        if jitter is None and feats is None and not torch.is_grad_enabled():
            inputs = self._prior_inputs(grid, v_cap, f_cap)
        if inputs is None:
            tracing.count("netbase.prior_bypass", 1)
            return self._make_prior_mesh(grid, v_cap, f_cap, jitter, feats)
        objects, values, storages = inputs
        held = self._held_prior
        if held is not None and held[1] == values \
                and all(a is b for a, b in zip(held[0], objects)):
            mesh, sdf = held[3]
            tracing.count("netbase.prior_hits", 1)
            if tracing.on():
                tracing.count("mesh.faces", mesh.num_faces)
                tracing.count("mesh.face_slots", f_cap)
            return mesh, sdf
        tracing.count("netbase.prior_misses", 1)
        self._held_prior = None     # its memory back before the sweep
        out = self._make_prior_mesh(grid, v_cap, f_cap, None, None)
        self._held_prior = (objects, values, storages, out)
        return out

    def _prior_inputs(self, grid, v_cap: int, f_cap: int):
        """What the eval prior is a function of besides the code:
        (objects, values, storages). The objects (the config, the grid,
        its positions and netBase's parameters and buffers) compare by
        identity; the values (resolution, caps, precision policy, TF32,
        inference mode, each tensor's version and address) by equality.
        A version moves with every in-place write (an optimizer step,
        `copy_`, `load_state_dict`); an address with a new tensor under
        the same object (`.to`, `param.data = ...`). The storages are held
        so that no other tensor can take a held address. None where one
        of the tensors was made in inference mode: it has no version."""
        tensors = (grid.verts, *self.parameters(), *self.buffers())
        if any(t.is_inference() for t in tensors):
            return None
        objects = (self.cfg, grid, *tensors)
        values = (grid.res, v_cap, f_cap, compute_dtype(),
                  torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32,
                  torch.is_inference_mode_enabled(),
                  tuple((t._version, t.data_ptr()) for t in tensors))
        return objects, values, [t.untyped_storage() for t in tensors]

    def _make_prior_mesh(self, grid, v_cap: int, f_cap: int, jitter,
                         feats):
        """`get_prior_mesh`'s computation."""
        shape = self.cfg.cfg_shape
        pos = grid.verts * shape.spatial_scale
        if jitter is not None and shape.jitter_grid > 0:
            pos = pos + (jitter * 2 - 1) * shape.jitter_grid \
                * shape.spatial_scale
        if self._use_band(grid):
            sdf = dmtet.sdf_lattice_banded(
                lambda p: self.get_sdf(p, feats)[..., 0], pos, grid.res,
                band_tau=shape.band_tau, seg_cap=shape.band_seg_cap)[0]
        elif self._use_fused_sweep(training=jitter is not None):
            sdf = self._fused_sdf_sweep(pos)
        else:
            sdf = self._eval_sdf(pos, feats)
        out = dmtet.marching_tets(pos, sdf, grid, v_cap, f_cap)
        mesh = make_mesh(out.verts[None], out.faces, out.v_valid,
                         out.f_valid, out.num_verts, out.num_faces,
                         face_gidx=out.face_gidx)
        return mesh, sdf

    def forward(self, grid, v_cap: int, f_cap: int, jitter=None,
                feats=None):
        return self.get_prior_mesh(grid, v_cap, f_cap, jitter=jitter,
                                   feats=feats)

    # ---- regularizers -----------------------------------------------------
    def sdf_reg_losses(self, grid, sdf, mesh, gen=None, noise: Noise = None,
                       feats=None):
        """BCE edge consistency + eikonal penalty on 5000 random + 5000
        near-surface points. The eikonal term differentiates the gradient
        of the plain `get_sdf` (`create_graph=True`); it never goes through
        the fused kernels. `feats` conditions the modulated SDF (the
        caller detaches it)."""
        shape = self.cfg.cfg_shape
        noise = noise or Noise()
        dev = sdf.device
        bce = dmtet.sdf_bce_for_grid(sdf, grid)
        n = 5000
        rand_pts = (uniform(noise.rand_pts_u, (n, 3), gen, dev) - 0.5) \
            * shape.spatial_scale
        v_cap = mesh.v_pos.shape[1]
        # the vertex buffer is compacted: indices below num_verts are valid
        if noise.surf_idx is not None:
            idx = noise.surf_idx.to(dev).long()
        else:
            hi = torch.clamp(mesh.num_verts, min=1).to(dev)
            idx = torch.floor(uniform(None, (n,), gen, dev) * hi).long()
        surf = mesh.v_pos[0].detach()[idx.clamp(0, v_cap - 1)]
        surf = surf + (uniform(noise.surf_u, (n, 3), gen, dev) - 0.5) \
            * 0.1 * shape.spatial_scale
        pts = torch.cat([rand_pts, surf], 0).requires_grad_(True)
        with torch.enable_grad():
            val = self.get_sdf(pts, feats)[..., 0]
            grads, = torch.autograd.grad(val.sum(), pts, create_graph=True)
        eikonal = ((torch.linalg.norm(grads, dim=-1) - 1.0) ** 2).mean()
        return {"sdf_bce_reg_loss": bce, "sdf_gradient_reg_loss": eikonal}
