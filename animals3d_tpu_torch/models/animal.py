"""AnimalModel: the MagicPony model wiring (port of the inference part of
`animals3d_tpu.models.animal`).

`reconstruct` is single-image reconstruction: netBase (prior SDF over the
lattice + marching tets) → netInstance (DINO ViT, pose, articulation,
skinning) → `render_mesh` of the input view. The losses, regularizers and
training forward are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch.device import get_device
from animals3d_tpu_torch.geometry import tets as tetlib
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors import (BasePredictor, BasePredictorConfig,
                                            InstancePredictor,
                                            InstancePredictorConfig)
from animals3d_tpu_torch.render.render import render_mesh


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    spatial_scale: float = 5.0
    background_mode: str = "none"
    render_flow: bool = False
    cam_pos_z_offset: float = 10.0
    fov: float = 25.0
    renderer_spp: int = 1
    render_default: bool = False


@dataclasses.dataclass(frozen=True)
class AnimalModelConfig:
    name: str = "MagicPony"
    enable_render: bool = True


class AnimalModel(nn.Module):
    """MagicPony base model. Parameters live in `netBase`/`netInstance`
    on `device` (default CUDA; the CPU only when asked for)."""

    def __init__(self, cfg: dict, device="cuda"):
        super().__init__()
        self.device = get_device(device)
        self.cfg_raw = cfg
        self.name = cfg.get("name", "MagicPony")
        self.cfg_model = cfglib.bind(AnimalModelConfig, cfg)
        self.cfg_render = cfglib.bind(RenderConfig, cfg.get("cfg_render"))
        self.cfg_predictor_base = cfglib.bind(BasePredictorConfig,
                                              cfg.get("cfg_predictor_base"))
        self.cfg_predictor_instance = cfglib.bind(
            InstancePredictorConfig, cfg.get("cfg_predictor_instance"))
        ds = cfg.get("dataset") or {}
        self.data_type = ds.get("data_type", "image")
        self.in_image_size = ds.get("in_image_size", 256)
        self.out_image_size = ds.get("out_image_size", 256)
        self.num_frames = ds.get("num_frames", 1)
        self.netBase = BasePredictor(self.cfg_predictor_base)
        self.netInstance = InstancePredictor(self.cfg_predictor_instance,
                                             image_size=self.in_image_size)
        self._grids: Dict[int, tetlib.DeviceTetGrid] = {}
        self.to(self.device)

    # -- grids and phases ---------------------------------------------------
    def grid_for_phase(self, phase: Phase):
        shape_cfg = self.cfg_predictor_base.cfg_shape
        res = shape_cfg.grid_res_coarse if phase.use_coarse_grid \
            else shape_cfg.grid_res
        if res not in self._grids:
            self._grids[res] = tetlib.DeviceTetGrid(
                tetlib.load_tet_grid(res), self.device)
        v_cap, f_cap = tetlib.default_capacity(
            res, getattr(shape_cfg, "mesh_cap_scale", 6.0))
        return self._grids[res], v_cap, f_cap

    def phase_for_iter(self, total_iter: int, is_training: bool = True):
        shape_cfg = self.cfg_predictor_base.cfg_shape
        inst = self.cfg_predictor_instance
        coarse = shape_cfg.grid_res_coarse_iter_range is not None and \
            cfglib.in_range(total_iter, shape_cfg.grid_res_coarse_iter_range,
                            default_indicator=-1)
        deform = inst.enable_deform and cfglib.in_range(
            total_iter, inst.cfg_deform.deform_iter_range,
            default_indicator=-1)
        arti = inst.enable_articulation and cfglib.in_range(
            total_iter, inst.cfg_articulation.articulation_iter_range,
            default_indicator=-1)
        attach = inst.enable_articulation and cfglib.in_range(
            total_iter, inst.cfg_articulation.attach_legs_to_body_iter_range,
            default_indicator=-1)
        return Phase(use_coarse_grid=bool(coarse), deform_on=bool(deform),
                     articulation_on=bool(arti), attach_legs=bool(attach),
                     is_training=bool(is_training),
                     constrain_legs=bool(inst.cfg_articulation.constrain_legs),
                     zeroy=bool(inst.cfg_pose.lookat_zeroy))

    # -- init ---------------------------------------------------------------
    def init_params(self, seed: int = 0) -> dict:
        """Initialize every parameter from `seed` (the JAX package's init
        distributions, drawn from one `torch.Generator` on the CPU) and
        return the state dict."""
        gen = torch.Generator().manual_seed(int(seed))
        self.to("cpu")
        for m in self.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        self.to(self.device)
        return self.state_dict()

    # -- rendering ----------------------------------------------------------
    def background_image(self, N, h, w, dtype=torch.float32):
        mode = self.cfg_render.background_mode
        dev = self.device
        if mode in ("none", "black", "background", "input"):
            # contexts without a real background fall back to black
            return torch.zeros((N, h, w, 3), dtype=dtype, device=dev)
        if mode == "white":
            return torch.ones((N, h, w, 3), dtype=dtype, device=dev)
        if mode == "checkerboard":
            ys = (torch.arange(h, device=dev) // 8)[:, None]
            xs = (torch.arange(w, device=dev) // 8)[None, :]
            checker = ((ys + xs) % 2).to(dtype) * 0.5 + 0.25
            return checker[None, :, :, None].expand(N, h, w, 3)
        raise NotImplementedError(mode)

    def render(self, render_modes, shape, mvp, w2c, campos, resolution,
               im_features=None, light_params=None, prior_mesh=None,
               use_dino: bool = False, background=None):
        h, w = resolution
        material_fn = None
        if im_features is not None:
            material_fn = lambda tex_pos: self.netInstance.sample_texture(
                tex_pos, im_features)
        dino_fn = self.netBase.dino_field if use_dino else None
        if background is None:
            background = self.background_image(mvp.shape[0], h, w)
        return render_mesh(shape, mvp, w2c, campos, (h, w),
                           material_fn=material_fn, light_params=light_params,
                           background=background,
                           spp=self.cfg_render.renderer_spp,
                           render_modes=render_modes, prior_mesh=prior_mesh,
                           dino_fn=dino_fn)

    # -- forwards -----------------------------------------------------------
    def forward_base(self, grid, v_cap: int, f_cap: int):
        """Prior mesh and SDF (no grid jitter: the eval forward)."""
        return self.netBase(grid, v_cap, f_cap)

    def instance_forward(self, images, prior_mesh, total_iter, phase: Phase):
        return self.netInstance(images, prior_mesh, total_iter, phase)

    @torch.no_grad()
    def reconstruct(self, params, images, total_iter: int):
        """Single-image reconstruction: netBase → netInstance →
        render(["shaded"]) of the input view, at the eval phase of
        `total_iter`. `params` is this model itself (or None) or a state
        dict to load first; images (B, F, 3, H, W) in [0, 1]. Returns the
        shaded RGBA (B·F, 4, H, W) and the instance predictor's 12-tuple."""
        if params is not None and params is not self:
            self.load_state_dict(params)
        phase = self.phase_for_iter(total_iter, is_training=False)
        grid, v_cap, f_cap = self.grid_for_phase(phase)
        prior_mesh, _sdf = self.forward_base(grid, v_cap, f_cap)
        out = self.instance_forward(images, prior_mesh, total_iter, phase)
        (shape, _pose_raw, _pose, mvp, w2c, campos, im_features, _feat_key,
         _deformation, _arti_params, light_params, _aux) = out
        H = self.in_image_size
        renders = self.render(["shaded"], shape, mvp, w2c, campos, (H, H),
                              im_features=im_features,
                              light_params=light_params,
                              prior_mesh=prior_mesh)
        return renders["shaded"], out
