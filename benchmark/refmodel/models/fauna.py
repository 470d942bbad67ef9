"""3D-Fauna: pan-category quadruped reconstruction with a semantic
base-shape memory bank and a mask-discriminator GAN loss (port of
`animals3d_tpu.models.fauna`).

  * netBase is a `BankPredictor`: the frozen instance ViT's class tokens
    query the memory bank, and the batch mean of the retrieved embeddings
    conditions the modulated SDF and the DINO field (`forward_base`);
  * inside the discriminator window (`phase.disc_on`) `extra_losses`
    renders the posed shape from a random azimuth and asks the mask
    discriminator to call its mask real; the masks, conditioned on the
    detached class vector, are recorded for the discriminator's own step;
  * the discriminator step is separate (`discriminator_loss`, with the R1
    penalty as a gradient of a gradient); the trainer runs it after the
    generator step with its own Adam, and the generator's optimizers never
    touch `netDisc`;
  * iteration-scheduled weight dicts (`parse_dict_definition`) are
    piecewise-constant functions of the iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from refmodel import config as cfglib
from refmodel.models.animal import AnimalModel, OptimizerConfig
from refmodel.networks import discriminator as disc_lib
from refmodel.noise import Noise, uniform_rows
from refmodel.phase import Phase
from refmodel.predictors.bank import BankPredictor
from refmodel.predictors.config import BankConfig
from refmodel.predictors.fauna import (FaunaAdditionalConfig,
                                                  FaunaInstancePredictor)
from refmodel.render.camera import perspective


@dataclasses.dataclass(frozen=True)
class MaskDiscriminatorConfig:
    enable_iter: Tuple[int, int] = (80000, 300000)
    disc_gt: bool = False
    disc_iv: bool = True
    disc_iv_label: str = "Real"
    mask_disc_loss_weight: float = 0.1
    discriminator_loss_weight: float = 1.0
    disc_reg_mul: float = 10.0


def parse_dict_definition(dict_cfg, total_iter) -> float:
    """An iteration-scheduled weight dict {start iteration: weight}, in its
    order: the weight of the interval [start_i, start_{i+1}) that holds
    `total_iter`, and the last weight outside them all."""
    iters = list(dict_cfg.keys())
    weights = list(dict_cfg.values())
    w = float(weights[-1])
    for i in range(len(iters) - 1):
        if float(iters[i]) <= total_iter < float(iters[i + 1]):
            w = float(weights[i])
    return w


class Fauna(AnimalModel):

    def __init__(self, cfg: dict, device="cuda", **render):
        pred_base = cfg.get("cfg_predictor_base") or {}
        pred_inst = cfg.get("cfg_predictor_instance") or {}
        self.cfg_bank = cfglib.bind(BankConfig, pred_base.get("cfg_bank"))
        self.cfg_additional = cfglib.bind(FaunaAdditionalConfig,
                                          pred_inst.get("cfg_additional"))
        self.cfg_mask_discriminator = cfglib.bind(
            MaskDiscriminatorConfig, cfg.get("cfg_mask_discriminator"))
        self.cfg_optim_discriminator = cfglib.bind(
            OptimizerConfig, cfg.get("cfg_optim_discriminator"))
        super().__init__(cfg, device=device, **render)
        self.netDisc = disc_lib.DCDiscriminator(
            in_dim=self.cfg_bank.memory_bank_dim + 1,
            img_size=self.out_image_size)
        self.to(self.device)

    # -- construction -------------------------------------------------------
    def make_net_base(self):
        return BankPredictor(self.cfg_predictor_base, self.cfg_bank)

    def make_net_instance(self):
        """The Fauna tweaks (`InstancePredictorFauna.py:33-34,46`): texture
        `in_layer_relu`, articulation id-add and `bone_y_threshold`, pose
        temperature clipped at 10."""
        inst = self.cfg_predictor_instance
        inst = dataclasses.replace(
            inst,
            cfg_texture=dataclasses.replace(inst.cfg_texture,
                                            in_layer_relu=True),
            cfg_articulation=dataclasses.replace(
                inst.cfg_articulation, enable_articulation_idadd=True,
                bone_y_threshold=self.cfg_additional.bone_y_threshold),
            cfg_pose=dataclasses.replace(inst.cfg_pose, temp_clip_high=10.0))
        self.cfg_predictor_instance = inst
        return FaunaInstancePredictor(inst, self.cfg_additional,
                                      image_size=self.in_image_size)

    def phase_for_iter(self, total_iter: int, is_training: bool = True):
        p = super().phase_for_iter(total_iter, is_training)
        add = self.cfg_additional
        leg_started = (add.iter_leg_rotation_start > 0
                       and total_iter > add.iter_leg_rotation_start)
        lo, hi = self.cfg_mask_discriminator.enable_iter
        return p._replace(
            constrain_legs=not leg_started,
            leg_rot_started=bool(leg_started),
            zeroy=bool(self.cfg_predictor_instance.cfg_pose.lookat_zeroy
                       and total_iter < add.nozeroy_start),
            disc_on=bool(is_training and lo < total_iter < hi))

    # -- scheduled weights ---------------------------------------------------
    def loss_weight(self, name: str, total_iter):
        if name == "dino_feat_im_loss" and \
                self.cfg_loss.dino_feat_im_loss_weight_dict:
            return parse_dict_definition(
                self.cfg_loss.dino_feat_im_loss_weight_dict, total_iter)
        if name == "mask_disc_loss":
            return self.cfg_mask_discriminator.mask_disc_loss_weight
        if name in ("mask_disc_loss_rv", "mask_disc_loss_iv"):
            return 0.0
        return super().loss_weight(name, total_iter)

    def logit_weight(self, name: str, total_iter):
        cl = self.cfg_loss
        if name == "dino_feat_im_loss" and cl.dino_feat_im_loss_weight_dict \
                and cl.logit_loss_dino_feat_im_loss_multiplier_dict:
            return parse_dict_definition(cl.dino_feat_im_loss_weight_dict,
                                         total_iter) * \
                parse_dict_definition(
                    cl.logit_loss_dino_feat_im_loss_multiplier_dict,
                    total_iter)
        w = self.loss_weight(name, total_iter)
        if name == "mask_loss":
            return w * cl.logit_loss_mask_multiplier
        if name == "mask_inv_dt_loss":
            return w * cl.logit_loss_mask_inv_dt_multiplier
        return w

    # -- bank-conditioned base forward ---------------------------------------
    def forward_base(self, grid, v_cap: int, f_cap: int, jitter=None,
                     batch=None):
        """The class tokens of the batch's images query the bank; its batch
        mean (1, dim) conditions the prior. Returns (prior mesh, sdf,
        class vector (1, dim), {"bank_embedding": (batch mean, per-image
        embeddings, {"weights", "pick_idx"})})."""
        cls_tok = self.netInstance.frozen_vit_class_token(batch["images"])
        batch_mean, embeddings, weight_aux = \
            self.netBase.retrieve_memory_bank(cls_tok)
        prior_mesh, sdf = self.netBase(grid, v_cap, f_cap, jitter=jitter,
                                       feats=batch_mean[None])
        bank_aux = {"bank_embedding": (batch_mean, embeddings, weight_aux)}
        return prior_mesh, sdf, batch_mean[None], bank_aux

    # -- GAN pieces ----------------------------------------------------------
    def random_view_cameras(self, w2c_pred, b: int, gen=None,
                            noise: Noise = None):
        """(mvp, w2c, campos) of b random views: the predicted camera's
        translation, turned about the y axis by a random azimuth in whole
        degrees (`noise.rv_deg`, else drawn from `gen`)."""
        dev = w2c_pred.device
        noise = noise or Noise()
        if noise.rv_deg is not None:
            deg = noise.rv_deg.to(dev)
        else:
            deg = torch.floor(uniform_rows(None, (b,), gen, dev) * 360)
        angle = deg.float() * (2 * np.pi / 360)
        c, s = torch.cos(angle), torch.sin(angle)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        rot = torch.stack([
            torch.stack([c, zero, s, zero], -1),
            torch.stack([zero, one, zero, zero], -1),
            torch.stack([-s, zero, c, zero], -1),
            torch.stack([zero, zero, zero, one], -1)], -2)     # (b, 4, 4)
        w2c = torch.eye(4, device=dev).repeat(b, 1, 1)
        w2c[:, :3, 3] = w2c_pred.detach()[:b, :3, 3]
        proj = torch.as_tensor(perspective(self.cfg_render.fov / 180 * np.pi),
                               device=dev)
        mvp = torch.einsum("ij,bjk->bik", proj, w2c)
        campos = -w2c[:, :3, 3]
        mvp = torch.einsum("bij,bjk->bik", mvp, rot)
        campos = torch.einsum("bji,bj->bi", rot[:, :3, :3], campos)
        return mvp, w2c, campos

    def get_random_view_mask(self, w2c_pred, shape, prior_mesh, gen=None,
                             noise: Noise = None):
        """The posed shape's mask (b, 1, H, W) from `random_view_cameras`,
        rendered without texture or light."""
        mvp, w2c, campos = self.random_view_cameras(
            w2c_pred, shape.v_pos.shape[0], gen, noise)
        res = (self.out_image_size, self.out_image_size)
        renders = self.render(["shaded"], shape, mvp, w2c, campos, res,
                              prior_mesh=prior_mesh)
        return torch.clamp(renders["shaded"][:, 3:], 0.0, 1.0)

    @staticmethod
    def _with_condition(mask, class_vector):
        """mask (N, 1, H, W) ⊕ the detached class vector broadcast over its
        pixels → (N, 1 + dim, H, W)."""
        cond = class_vector.detach().reshape(1, -1, 1, 1)
        cond = cond.expand(mask.shape[0], cond.shape[1], *mask.shape[2:])
        return torch.cat([mask, cond.to(mask.dtype)], 1)

    def extra_losses(self, batch, total_iter, final_losses, metrics, ctx):
        """Inside the discriminator window: the generator's loss (the
        random view's mask must look real; the input view's too where
        `disc_iv_label` is not "Real"), as `mask_disc_loss`, and the
        detached conditioned masks in `metrics["_disc_record"]`."""
        phase: Phase = ctx["phase"]
        if not phase.disc_on:
            return 0.0
        mdc = self.cfg_mask_discriminator
        class_vector = ctx["class_vector"][0]                  # (dim,)
        mask_gt, mask_pred = ctx["mask_gt"], ctx["mask_pred"]
        B, Fr = mask_gt.shape[:2]
        mask_rv = self.get_random_view_mask(ctx["w2c"], ctx["shape"],
                                            ctx["prior_mesh"], ctx["gen"],
                                            ctx["noise"])
        mask_iv = mask_pred.reshape(B * Fr, 1, *mask_pred.shape[2:])
        mask_gt_ = mask_gt.reshape(B * Fr, 1, *mask_gt.shape[2:])
        D = self.netDisc
        gen_loss = disc_lib.bce_loss_target(
            D(self._with_condition(mask_rv, class_vector)), 1.0)
        count = 1
        if mdc.disc_iv and mdc.disc_iv_label != "Real":
            gen_loss = gen_loss + disc_lib.bce_loss_target(
                D(self._with_condition(mask_iv, class_vector)), 1.0)
            count += 1
        gen_loss = gen_loss / count
        final_losses["mask_disc_loss"] = gen_loss
        metrics["mask_disc_loss"] = gen_loss
        metrics["_disc_record"] = {
            name: self._with_condition(m, class_vector).detach()
            for name, m in (("mask_gt", mask_gt_), ("mask_iv", mask_iv),
                            ("mask_rv", mask_rv))}
        return gen_loss * mdc.mask_disc_loss_weight

    def discriminator_loss(self, record):
        """The discriminator's loss on a recorded step: the random view is
        fake; the input view (and the ground truth where `disc_gt`) real,
        each with `disc_reg_mul` × its R1 penalty, or fake where
        `disc_iv_label` is not "Real"."""
        mdc = self.cfg_mask_discriminator
        D = self.netDisc
        bce = disc_lib.bce_loss_target
        loss = bce(D(record["mask_rv"]), 0.0)
        count = 1
        if mdc.disc_gt:
            gp = mdc.disc_reg_mul * disc_lib.r1_penalty(D, record["mask_gt"])
            loss = loss + bce(D(record["mask_gt"]), 1.0) + gp
            count += 1
        if mdc.disc_iv:
            if mdc.disc_iv_label == "Real":
                gp = mdc.disc_reg_mul * disc_lib.r1_penalty(
                    D, record["mask_iv"])
                loss = loss + bce(D(record["mask_iv"]), 1.0) + gp
            else:
                loss = loss + bce(D(record["mask_iv"]), 0.0)
            count += 1
        return loss / count * mdc.discriminator_loss_weight
