"""AnimalModel: the MagicPony model wiring and loss orchestration (port of
`animals3d_tpu.models.animal`).

`reconstruct` is single-image reconstruction: netBase (prior SDF over the
lattice + marching tets) → netInstance (DINO ViT, pose, articulation,
skinning) → `render_mesh` of the input view. `forward` is the training
forward: the same chain with grid jitter and random pose sampling, renders
of `shaded` and `dino_pred`, the reconstruction losses weighted by the
pose hypothesis' probability, the logit loss and the regularizers; it
returns (total_loss, (metrics, aux)) and `loss.backward()` is the whole
backward pass. Subclasses hook in as in the JAX package: `make_net_base`
and `make_net_instance` build the predictors, `forward_base` returns
(prior mesh, sdf, class vector, bank aux) from the batch (Fauna's memory
bank), and `extra_losses` adds to the total after the weighted sum
(Fauna's mask discriminator; Ponymation's VAE losses), `render_cameras`
picks the cameras the forward renders from (Ponymation's default view),
`use_recon_losses` switches the reconstruction losses off (Ponymation's
stage 2) and `frozen_param` names the parameters no optimizer steps
(Ponymation's stages). Sequence data (F > 1) adds the flow loss, where
the config renders flow and the batch has flows, and the temporal
smoothness terms.

Batch contract: a dict with images (B, F, 3, H, W) in [0, 1], masks
(B, F, 1, H, W), mask_dt (B, F, 2, H, W), mask_valid (B, F, H, W),
flows (B, F - 1, 2, H, W) or None, dino_features (B, F, D, h, w) or None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch.device import get_device
from animals3d_tpu_torch.geometry import tets as tetlib
from animals3d_tpu_torch.geometry.mesh import take_rows
from animals3d_tpu_torch.noise import Noise, uniform
from animals3d_tpu_torch.ops.image import resize_nchw
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors import (BasePredictor, BasePredictorConfig,
                                            InstancePredictor,
                                            InstancePredictorConfig)
from animals3d_tpu_torch.render.render import render_mesh
from animals3d_tpu_torch.utils.smooth_loss import smooth_loss


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 0.0001
    weight_decay: float = 0.0
    # MultiStepLR: lr × gamma at each milestone iteration
    use_scheduler: bool = False
    scheduler_milestone: tuple = (1, 2, 3, 4, 5)
    scheduler_gamma: float = 0.5


@dataclasses.dataclass(frozen=True)
class LossConfig:
    mask_loss_weight: float = 10.0
    mask_dt_loss_weight: float = 0.0
    mask_inv_dt_loss_weight: float = 100.0
    rgb_loss_weight: float = 1.0
    flow_loss_weight: float = 0.0
    dino_feat_im_loss_weight: float = 10.0
    sdf_reg_decay_start_iter: int = 10000
    sdf_bce_reg_loss_weight: float = 0.0
    sdf_gradient_reg_loss_weight: float = 0.01
    logit_loss_weight: float = 1.0
    logit_loss_target_weight: float = 0.0
    logit_loss_dino_feat_im_loss_multiplier: float = 50.0
    arti_reg_loss_iter_range: Tuple[float, float] = (60000, float("inf"))
    arti_reg_loss_weight: float = 0.1
    deform_reg_loss_weight: float = 10.0
    prior_normal_reg_loss_weight: float = 0.0
    instance_normal_reg_loss_weight: float = 0.0
    # sequences: temporal smoothness, and Ponymation's stage-2 VAE losses
    smooth_type: str = "dislocation"
    loss_type: str = "l2"
    arti_smooth_loss_weight: float = 0.0
    deform_smooth_loss_weight: float = 0.0
    campose_smooth_loss_weight: float = 0.0
    camposevel_smooth_loss_weight: float = 0.0
    artivel_smooth_loss_weight: float = 0.0
    bone_smooth_loss_weight: float = 0.0
    bonevel_smooth_loss_weight: float = 0.0
    arti_recon_loss_weight: float = 0.0
    kld_loss_weight: float = 0.001
    # Fauna: the generator's mask-discriminator loss, and the
    # iteration-scheduled dicts {start iteration: weight} in their order
    mask_disc_loss_weight: float = 0.1
    mask_disc_loss_rv_weight: float = 0.0
    mask_disc_loss_iv_weight: float = 0.0
    logit_loss_dino_feat_im_loss_multiplier_dict: Any = None
    dino_feat_im_loss_weight_dict: Any = None
    logit_loss_mask_multiplier: float = 0.05
    logit_loss_mask_inv_dt_multiplier: float = 0.05


def expand_bf(x, b, f):
    return None if x is None else x.reshape(b, f, *x.shape[1:])


def collapse_bf(x):
    return None if x is None else x.reshape(-1, *x.shape[2:])


def _in_range(total_iter, rng_pair) -> float:
    lo, hi = float(rng_pair[0]), float(rng_pair[1])
    return float(total_iter >= lo and (total_iter < hi or not np.isfinite(hi)))


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
    on `device` (default CUDA; the CPU only when asked for).
    `raster_variant` (3, 4 or 6) and `resolve_rows` ("gather" or "kernel")
    select the render's visibility kernel and resolve path
    (`render.render.render_mesh`); the defaults are the JAX package's."""

    def __init__(self, cfg: dict, device="cuda", raster_variant: int = 3,
                 resolve_rows: str = "gather"):
        super().__init__()
        if raster_variant not in (3, 4, 6):
            raise ValueError(f"raster_variant {raster_variant}: want 3, 4 "
                             "or 6")
        if resolve_rows not in ("gather", "kernel"):
            raise ValueError(f"resolve_rows {resolve_rows!r}: want 'gather' "
                             "or 'kernel'")
        self.raster_variant = raster_variant
        self.resolve_rows = resolve_rows
        self.device = get_device(device)
        self.cfg_raw = cfg
        self.name = cfg.get("name", "MagicPony")
        self.cfg_model = cfglib.bind(AnimalModelConfig, cfg)
        self.cfg_render = cfglib.bind(RenderConfig, cfg.get("cfg_render"))
        self.cfg_loss = cfglib.bind(LossConfig, cfg.get("cfg_loss"))
        self.cfg_optim_base = cfglib.bind(OptimizerConfig,
                                          cfg.get("cfg_optim_base"))
        self.cfg_optim_instance = cfglib.bind(OptimizerConfig,
                                              cfg.get("cfg_optim_instance"))
        self.cfg_predictor_base = cfglib.bind(BasePredictorConfig,
                                              cfg.get("cfg_predictor_base"))
        self.cfg_predictor_instance = cfglib.bind(
            InstancePredictorConfig, cfg.get("cfg_predictor_instance"))
        ds = cfg.get("dataset") or {}
        self.data_type = ds.get("data_type", "image")
        self.in_image_size = ds.get("in_image_size", 256)
        self.out_image_size = ds.get("out_image_size", 256)
        self.num_frames = ds.get("num_frames", 1)
        self.dino_feature_dim = self.cfg_predictor_base.cfg_dino.feature_dim
        self.netBase = self.make_net_base()
        self.netInstance = self.make_net_instance()
        self._grids: Dict[int, tetlib.DeviceTetGrid] = {}
        self.to(self.device)

    # -- construction hooks (Fauna overrides them) -------------------------
    def make_net_base(self):
        return BasePredictor(self.cfg_predictor_base)

    def make_net_instance(self):
        return InstancePredictor(self.cfg_predictor_instance,
                                 image_size=self.in_image_size)

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
               use_dino: bool = False, background=None, class_vector=None,
               num_frames=None, spp=None):
        """`class_vector` (1 or N, dim) conditions the DINO field; one row
        is broadcast to the N images. `num_frames` groups the images into
        sequences for the flow mode. `spp`, where given, overrides the
        config's `renderer_spp`."""
        h, w = resolution
        N = mvp.shape[0]
        material_fn = None
        if im_features is not None:
            material_fn = lambda tex_pos: self.netInstance.sample_texture(
                tex_pos, im_features)
        if class_vector is not None and class_vector.shape[0] == 1 and N > 1:
            class_vector = class_vector.expand(N, class_vector.shape[1])
        dino_fn = None
        if use_dino:
            dino_fn = lambda tex_pos: self.netBase.dino_field(tex_pos,
                                                              class_vector)
        if background is None:
            background = self.background_image(N, h, w)
        return render_mesh(shape, mvp, w2c, campos, (h, w),
                           material_fn=material_fn, light_params=light_params,
                           background=background,
                           spp=spp or self.cfg_render.renderer_spp,
                           render_modes=render_modes, prior_mesh=prior_mesh,
                           dino_fn=dino_fn, num_frames=num_frames,
                           raster_variant=self.raster_variant,
                           resolve_rows=self.resolve_rows)

    # -- loss weights -------------------------------------------------------
    def loss_weight(self, name: str, total_iter):
        return getattr(self.cfg_loss, f"{name}_weight")

    def logit_weight(self, name: str, total_iter):
        """Weight of each recon loss inside the logit-loss target."""
        weight = self.loss_weight(name, total_iter)
        if name == "dino_feat_im_loss":
            weight = weight \
                * self.cfg_loss.logit_loss_dino_feat_im_loss_multiplier
        return weight

    # -- losses -------------------------------------------------------------
    def compute_reconstruction_losses(self, image_pred, image_gt, mask_pred,
                                      mask_gt, mask_dt, mask_valid, dino_gt,
                                      dino_pred, background_mode="none",
                                      flow_pred=None, flow_gt=None):
        """Per-(B, F) unreduced losses; the flow loss (where both flows
        (B, F - 1, 2, H, W) are given and F > 1) is per (B, F - 1): the
        squared error at the pixels of both masks, zero for a frame pair
        whose ground truth exceeds 0.5 in magnitude at any of them."""
        losses = {}
        B, Fr = image_pred.shape[:2]

        def mean_bf(x):
            return x.reshape(B, Fr, -1).mean(2)

        mask_pred_valid = mask_pred * mask_valid
        losses["mask_loss"] = mean_bf((mask_pred_valid - mask_gt) ** 2)
        losses["mask_dt_loss"] = mean_bf(mask_pred * mask_dt[:, :, 1])
        losses["mask_inv_dt_loss"] = mean_bf((1 - mask_pred)
                                             * mask_dt[:, :, 0])

        # intersection mask eroded by one pixel (3x3 mean > 0.99)
        with torch.no_grad():
            both = (mask_pred_valid > 0).to(image_pred.dtype) * mask_gt
            eroded = F.avg_pool2d(collapse_bf(both)[:, None], 3, stride=1,
                                  padding=1, count_include_pad=True)
            both = expand_bf((eroded[:, 0] > 0.99).to(image_pred.dtype), B,
                             Fr)

        rgb = (image_pred - image_gt).abs()
        if background_mode not in ("background", "input"):
            rgb = rgb * both[:, :, None]
        losses["rgb_loss"] = mean_bf(rgb)

        if flow_pred is not None and flow_gt is not None and Fr > 1:
            fl = (flow_pred - flow_gt) ** 2
            fl_mask = both[:, :-1, None].expand(flow_gt.shape)
            large = ((flow_gt.abs() > 0.5) * fl_mask).reshape(B, Fr - 1, -1) \
                .sum(2) > 0
            fl = fl * fl_mask * (1 - large[:, :, None, None, None]
                                 .to(fl.dtype))
            denom = torch.clamp(fl_mask.reshape(B, Fr - 1, -1).sum(2),
                                min=1.0)
            losses["flow_loss"] = fl.reshape(B, Fr - 1, -1).sum(2) / denom

        if dino_pred is not None and dino_gt is not None:
            dl = (dino_pred - dino_gt) ** 2 * both[:, :, None]
            losses["dino_feat_im_loss"] = mean_bf(dl)
        return losses

    def compute_regularizers(self, grid, sdf, prior_mesh, gen=None,
                             noise: Noise = None, arti_params=None,
                             deformation=None, class_vector=None,
                             pose_raw=None, posed_bones=None,
                             batch_size: int = 1, num_frames: int = 1):
        """SDF regularizers (the eikonal term conditioned by the detached
        `class_vector` where there is one), articulation and deformation
        magnitudes, the prior's normal consistency and, on sequence data,
        the temporal smoothness of the deformation, the articulation and
        its velocity, the camera pose and its velocity, and the posed
        bones and their velocity (`utils.smooth_loss`, each where its
        weight is positive)."""
        feats = None if class_vector is None else class_vector.detach()
        losses = dict(self.netBase.sdf_reg_losses(grid, sdf, prior_mesh,
                                                  gen=gen, noise=noise,
                                                  feats=feats))
        if arti_params is not None:
            losses["arti_reg_loss"] = (arti_params ** 2).mean()
        if deformation is not None:
            losses["deform_reg_loss"] = (deformation ** 2).mean()
        if prior_mesh is not None and \
                self.cfg_loss.prior_normal_reg_loss_weight > 0:
            faces = prior_mesh.t_pos_idx
            adj = torch.cat([faces[:, 0:2], faces[:, 1:3]], 0)
            n = take_rows(prior_mesh.v_nrm[0], adj)            # (2F, 2, 3)
            diffs = 1.0 - (n[:, 0] * n[:, 1]).sum(-1)
            w = torch.cat([prior_mesh.f_valid] * 2).to(diffs.dtype)
            losses["prior_normal_reg_loss"] = \
                (diffs * w).sum() / torch.clamp(w.sum(), min=1.0)
        if "sequence" in self.data_type and self.num_frames > 1:
            cl = self.cfg_loss

            def sm(x):
                return smooth_loss(x, cl.smooth_type, cl.loss_type)
            b, f = batch_size, num_frames
            if cl.deform_smooth_loss_weight > 0 and deformation is not None:
                losses["deform_smooth_loss"] = sm(expand_bf(deformation, b,
                                                            f))
            if arti_params is not None:
                if cl.arti_smooth_loss_weight > 0:
                    losses["arti_smooth_loss"] = sm(arti_params)
                if cl.artivel_smooth_loss_weight > 0:
                    losses["artivel_smooth_loss"] = sm(
                        arti_params[:, 1:] - arti_params[:, :-1])
            if pose_raw is not None:
                campose = expand_bf(pose_raw, b, f)
                if cl.campose_smooth_loss_weight > 0:
                    losses["campose_smooth_loss"] = sm(campose)
                if cl.camposevel_smooth_loss_weight > 0:
                    losses["camposevel_smooth_loss"] = sm(
                        campose[:, 1:] - campose[:, :-1])
            if posed_bones is not None:
                if cl.bone_smooth_loss_weight > 0:
                    losses["bone_smooth_loss"] = sm(posed_bones)
                if cl.bonevel_smooth_loss_weight > 0:
                    losses["bonevel_smooth_loss"] = sm(
                        posed_bones[:, 1:] - posed_bones[:, :-1])
        return losses

    # -- forwards -----------------------------------------------------------
    def forward_base(self, grid, v_cap: int, f_cap: int, jitter=None,
                     batch=None):
        """(prior mesh, sdf, class vector, bank aux); `jitter` (a uniform
        scalar) is the training forward's grid jitter, None at eval.
        MagicPony's prior has no condition: (mesh, sdf, None, {})."""
        prior_mesh, sdf = self.netBase(grid, v_cap, f_cap, jitter=jitter)
        return prior_mesh, sdf, None, {}

    def instance_forward(self, images, prior_mesh, total_iter, phase: Phase,
                         gen=None, noise: Noise = None):
        return self.netInstance(images, prior_mesh, total_iter, phase,
                                gen=gen, noise=noise)

    def forward(self, batch, total_iter, gen=None, phase: Phase = None,
                grid=None, noise: Noise = None):
        """The training forward. Random sites (grid jitter, pose sampling,
        eikonal points) take their values from `noise` where it has them
        and draw the rest from `gen`. Returns (total_loss, (metrics, aux))."""
        if phase is None:
            phase = self.phase_for_iter(total_iter)
        noise = noise or Noise()
        images = batch["images"]
        B, Fr = images.shape[:2]
        h = w = self.out_image_size
        mask_gt = (batch["masks"][:, :, 0] > 0.9).to(images.dtype)
        mask_dt = batch["mask_dt"] / self.in_image_size
        mask_valid = batch["mask_valid"]
        flow_gt = batch.get("flows")
        dino_feat_im = batch.get("dino_features")

        dino_gt = None
        if dino_feat_im is not None:
            d = resize_nchw(collapse_bf(dino_feat_im), (h, w))
            dino_gt = expand_bf(d, B, Fr)[:, :, :self.dino_feature_dim]
        image_gt = images
        if self.out_image_size != self.in_image_size:
            image_gt = expand_bf(resize_nchw(collapse_bf(image_gt), (h, w)),
                                 B, Fr)
            if flow_gt is not None:
                flow_gt = expand_bf(resize_nchw(collapse_bf(flow_gt),
                                                (h, w)), B, Fr - 1)

        _g, v_cap, f_cap = self.grid_for_phase(phase)
        if grid is None:
            grid = _g
        jitter = uniform(noise.jitter_u, (), gen, self.device) \
            if phase.is_training else None
        prior_mesh, sdf, class_vector, _bank_aux = self.forward_base(
            grid, v_cap, f_cap, jitter=jitter, batch=batch)

        (shape, pose_raw, pose, mvp, w2c, campos, im_features, _feat_key,
         deformation, arti_params, light_params, fw_aux) = \
            self.instance_forward(images, prior_mesh, total_iter, phase,
                                  gen=gen, noise=noise)

        final_losses = {}
        metrics = {}
        mask_pred = image_pred = dino_pred = flow_pred = None
        do_render = self.cfg_model.enable_render or not phase.is_training
        if do_render:
            # the batch shrinks at generation time (1 sequence × F frames)
            N_out = mvp.shape[0]
            if N_out != B * Fr:
                B = N_out // Fr
            render_flow = self.cfg_render.render_flow and Fr > 1
            render_modes = ["shaded", "dino_pred"] + \
                (["flow"] if render_flow else [])
            bg_mode = self.cfg_render.background_mode
            if bg_mode in ("background", "input"):
                raise NotImplementedError(
                    f"background_mode {bg_mode!r} in the training forward")
            r_mvp, r_w2c, r_campos = self.render_cameras(mvp, w2c, campos)
            renders = self.render(
                render_modes, shape, r_mvp, r_w2c, r_campos, (h, w),
                im_features=im_features, light_params=light_params,
                prior_mesh=prior_mesh, use_dino=True,
                class_vector=class_vector, num_frames=Fr)
            shaded = expand_bf(renders["shaded"], B, Fr)
            dino_pred = expand_bf(renders["dino_pred"], B, Fr)
            if render_flow:
                flow_pred = expand_bf(renders["flow"], B, Fr)[:, :-1]
            image_pred = shaded[:, :, :3]
            mask_pred = shaded[:, :, 3]

        if do_render and self.use_recon_losses(phase) and \
                image_pred.shape[:2] == image_gt.shape[:2]:
            losses = self.compute_reconstruction_losses(
                image_pred, image_gt, mask_pred, mask_gt, mask_dt, mask_valid,
                dino_gt, dino_pred, background_mode=bg_mode,
                flow_pred=flow_pred, flow_gt=flow_gt)

            # hypothesis-probability weighting + logit loss
            rot_logit = fw_aux["rot_logit"]
            rot_prob = fw_aux["rot_prob"].detach()
            num_hypos = self.netInstance.num_pose_hypos
            logit_target = torch.zeros((B, Fr), dtype=images.dtype,
                                       device=images.device)
            for name, loss in losses.items():
                # (B, F - 1) losses (flow) pad to (B, F) for the target
                n = loss.shape[1]
                loss_bf = loss if n == Fr else F.pad(loss, (0, Fr - n))
                logit_target = logit_target \
                    + loss_bf * self.logit_weight(name, total_iter)
                loss = loss * rot_prob.reshape(B, Fr)[:, :n] * num_hypos
                if name == "flow_loss":
                    ri = fw_aux["rot_idx"].reshape(B, Fr)
                    loss = loss * (ri[:, 1:] == ri[:, :-1]).to(loss.dtype)
                final_losses[name] = loss.mean()
            logit_target = collapse_bf(logit_target).detach()
            final_losses["logit_loss"] = \
                ((rot_logit - logit_target) ** 2).mean()
            metrics["logit_loss_target"] = logit_target.mean()

        final_losses.update(self.compute_regularizers(
            grid, sdf, prior_mesh, gen=gen, noise=noise,
            arti_params=arti_params, deformation=deformation,
            class_vector=class_vector, pose_raw=pose_raw,
            posed_bones=fw_aux.get("posed_bones"), batch_size=B,
            num_frames=Fr))

        total = 0.0
        tex_range = self.cfg_predictor_instance.cfg_texture.texture_iter_range
        for name, loss in final_losses.items():
            weight = self.loss_weight(name, total_iter)
            if isinstance(weight, (int, float)) and weight <= 0:
                continue
            gate = 1.0
            if name == "rgb_loss":
                gate = _in_range(total_iter, tex_range)
            if name == "arti_reg_loss":
                gate = _in_range(total_iter,
                                 self.cfg_loss.arti_reg_loss_iter_range)
            total = total + loss * weight * gate

        ctx = dict(phase=phase, gen=gen, noise=noise,
                   class_vector=class_vector, mask_gt=mask_gt,
                   mask_pred=mask_pred, shape=shape, prior_mesh=prior_mesh,
                   w2c=w2c, fw_aux=fw_aux)
        total = total + self.extra_losses(batch, total_iter, final_losses,
                                          metrics, ctx)

        metrics.update(final_losses)
        metrics["loss"] = total
        aux = {"mask_pred": mask_pred, "image_pred": image_pred,
               "shape": shape, "prior_mesh": prior_mesh, "pose": pose,
               "mvp": mvp, "w2c": w2c, "campos": campos,
               "im_features": im_features, "light_params": light_params,
               "arti_params": arti_params, "class_vector": class_vector,
               "pose_raw": pose_raw,
               "deformation": deformation, "sdf": sdf, "mask_gt": mask_gt,
               "dino_pred": dino_pred, "dino_gt": dino_gt,
               "flow_pred": flow_pred, "flow_gt": flow_gt,
               "rots_probs": fw_aux.get("rots_probs"),
               "posed_bones": fw_aux.get("posed_bones"),
               "rot_idx": fw_aux["rot_idx"],
               "rand_pose_flag": fw_aux["rand_pose_flag"]}
        return total, (metrics, aux)

    @torch.no_grad()
    def reconstruct(self, params, images, total_iter: int):
        """Single-image reconstruction: netBase (for Fauna through the
        memory bank, queried by the images' class tokens) → netInstance →
        render(["shaded"]) of the input view, at the eval phase of
        `total_iter`. `params` is this model itself (or None) or a state
        dict to load first; images (B, F, 3, H, W) in [0, 1]. Returns the
        shaded RGBA (B·F, 4, H, W) and the instance predictor's 12-tuple."""
        if params is not None and params is not self:
            self.load_state_dict(params)
        phase = self.phase_for_iter(total_iter, is_training=False)
        grid, v_cap, f_cap = self.grid_for_phase(phase)
        prior_mesh, _sdf, _class_vector, _bank_aux = self.forward_base(
            grid, v_cap, f_cap, batch={"images": images})
        out = self.instance_forward(images, prior_mesh, total_iter, phase)
        (shape, _pose_raw, _pose, mvp, w2c, campos, im_features, _feat_key,
         _deformation, _arti_params, light_params, _aux) = out
        H = self.in_image_size
        renders = self.render(["shaded"], shape, mvp, w2c, campos, (H, H),
                              im_features=im_features,
                              light_params=light_params,
                              prior_mesh=prior_mesh)
        return renders["shaded"], out

    # -- hooks for subclasses ------------------------------------------------
    def extra_losses(self, batch, total_iter, final_losses, metrics, ctx):
        """Added to the total after the weighted sum; may add entries to
        `final_losses` and `metrics`. `ctx` holds the forward's phase,
        gen, noise, class vector, masks, posed shape, prior, w2c and the
        instance predictor's aux (`fw_aux`)."""
        return 0.0

    def use_recon_losses(self, phase: Phase) -> bool:
        return True

    def render_cameras(self, mvp, w2c, campos):
        """The cameras the training forward renders from."""
        return mvp, w2c, campos

    def frozen_param(self, keys) -> bool:
        """Whether the parameter at module path `keys` (its name split at
        the dots) is frozen: a subclass that freezes some keeps them
        without gradient, so that no optimizer holds them."""
        return False
