"""Ponymation: video reconstruction (stage 1) and a transformer motion VAE
that generates articulation sequences (stage 2) (port of
`animals3d_tpu.models.ponymation`).

  * the stage is the config's `enable_motion_vae`: stage 1 trains only
    `netArticulation`, stage 2 only `netVAE` (`frozen_param`); the frozen
    parameters are kept without gradient, so the optimizers hold only the
    trained net, as the JAX package's `optax.set_to_zero` partitions leave
    the others where they are;
  * stage 2 switches the reconstruction losses off (`use_recon_losses`)
    and adds the teacher-distillation `arti_recon_loss` and `kld_loss`;
  * with `render_default` the forward renders from a canonical camera
    turned −120° about y, `offset_extra` further away (`default_cameras`);
  * outside training, with the VAE on, the instance forward is
    `generate` (one sequence of `num_frames` frames).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch.geometry.skinning import euler_angles_to_matrix
from animals3d_tpu_torch.models.animal import AnimalModel, RenderConfig
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors.motion_vae import (MotionVAEConfig,
                                                       MotionVAEPredictor)
from animals3d_tpu_torch.render.camera import perspective


@dataclasses.dataclass(frozen=True)
class PonymationRenderConfig(RenderConfig):
    offset_extra: float = 4.0


class Ponymation(AnimalModel):

    def __init__(self, cfg: dict, device="cuda", **render):
        pred_inst = cfg.get("cfg_predictor_instance") or {}
        self.enable_motion_vae = bool(pred_inst.get("enable_motion_vae",
                                                    True))
        self.cfg_motion_vae = cfglib.bind(MotionVAEConfig,
                                          pred_inst.get("cfg_motion_vae"))
        super().__init__(cfg, device=device, **render)
        self.cfg_render = cfglib.bind(PonymationRenderConfig,
                                      cfg.get("cfg_render"))
        self._default_cameras = None
        for name, p in self.named_parameters():
            if self.frozen_param(name.split(".")):
                p.requires_grad_(False)

    def make_net_instance(self):
        return MotionVAEPredictor(self.cfg_predictor_instance,
                                  enable_motion_vae=self.enable_motion_vae,
                                  cfg_motion_vae=self.cfg_motion_vae,
                                  image_size=self.in_image_size)

    # -- stage-dependent trainability ----------------------------------------
    def frozen_param(self, keys) -> bool:
        if keys[0] not in ("netInstance", "netBase"):
            return False
        if self.enable_motion_vae:                    # stage 2: only netVAE
            return "netVAE" not in keys
        return "netArticulation" not in keys          # stage 1

    # -- the default (canonical) camera ---------------------------------------
    def default_cameras(self, N: int):
        """(mvp, w2c, campos) of the canonical view for N images."""
        if self._default_cameras is None:
            pose_cfg = self.cfg_predictor_instance.cfg_pose
            z_off = pose_cfg.cam_pos_z_offset + self.cfg_render.offset_extra
            w2c = np.eye(4, dtype=np.float32)
            w2c[2, 3] = -z_off
            proj = perspective(pose_cfg.fov / 180 * np.pi)
            mtx = np.eye(4, dtype=np.float32)
            rot = euler_angles_to_matrix(torch.tensor(
                [0.0, -120.0 / 180 * np.pi, 0.0]), "XYZ").numpy()
            mtx[:3, :3] = rot
            w2c_a = (w2c @ mtx).astype(np.float32)
            mvp_a = (proj @ w2c @ mtx).astype(np.float32)
            campos = (np.array([0, 0, z_off], np.float32)
                      @ np.linalg.inv(rot).T)
            self._default_cameras = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=self.device)
                for a in (mvp_a, w2c_a, campos))
        mvp, w2c, campos = self._default_cameras
        return (mvp[None].expand(N, 4, 4), w2c[None].expand(N, 4, 4),
                campos[None].expand(N, 3))

    def render_cameras(self, mvp, w2c, campos):
        if self.cfg_render.render_default:
            return self.default_cameras(mvp.shape[0])
        return mvp, w2c, campos

    # -- stage 2: generation outside training ----------------------------------
    def instance_forward(self, images, prior_mesh, total_iter, phase: Phase,
                         gen=None, noise=None):
        if self.enable_motion_vae and not phase.is_training:
            return self.netInstance.generate(
                images, prior_mesh, total_iter, phase, 1, self.num_frames,
                gen=gen, noise=noise)
        return super().instance_forward(images, prior_mesh, total_iter,
                                        phase, gen=gen, noise=noise)

    # -- stage-2 losses ---------------------------------------------------------
    def use_recon_losses(self, phase: Phase) -> bool:
        return not self.enable_motion_vae

    def extra_losses(self, batch, total_iter, final_losses, metrics, ctx):
        """The teacher's angles against the VAE's (`arti_recon_loss`,
        mean squared error) and the KL divergence of the VAE's posterior
        (`kld_loss` = −0.5 · the batch mean of the sum over latent dims of
        1 + logvar − mu² − e^logvar), each where its weight is positive
        and the forward made its inputs."""
        fw_aux = ctx["fw_aux"]
        cl = self.cfg_loss
        total = 0.0
        if cl.arti_recon_loss_weight > 0 and \
                "articulation_angles_gt" in fw_aux:
            recon = ((fw_aux["articulation_angles_pred"]
                      - fw_aux["articulation_angles_gt"]) ** 2).mean()
            final_losses["arti_recon_loss"] = recon
            metrics["arti_recon_loss"] = recon
            total = total + recon * cl.arti_recon_loss_weight
        if cl.kld_loss_weight > 0 and "log_var_vae" in fw_aux:
            mu, logvar = fw_aux["mu_vae"], fw_aux["log_var_vae"]
            kld = -0.5 * (1 + logvar - mu ** 2 - logvar.exp()).sum(1).mean()
            final_losses["kld_loss"] = kld
            metrics["kld_loss"] = kld
            total = total + kld * cl.kld_loss_weight
        return total
