"""Ponymation (Sun et al., ECCV 2024) for the benchmark's reference: a
frozen copy of `models/ponymation.py` of `animals3d_tpu_torch`
(3DAnimals `model/models/Ponymation.py`), in plain float32 PyTorch.

  * stage 2 (the config's `enable_motion_vae`) trains only `netVAE`
    (`frozen_param`); the frozen parameters are kept without gradient, so
    the optimizers hold only the trained net;
  * it switches the reconstruction losses off (`use_recon_losses`) and
    adds the teacher-distillation `arti_recon_loss` and `kld_loss`
    (`extra_losses`).

`refmodel.models.build_model` does not dispatch to this class: the
benchmark's `pony_train` entry builds it directly. This copy is of stage 2
alone, which the benchmark's Ponymation cell trains with the render off:
stage 1 (which trains `netArticulation` on the reconstruction, flow and
smoothness losses that `refmodel.models.animal` leaves out), the port's
canonical render camera (`render_default`) and its generation outside
training are left out, and a stage-1 config raises.
"""
from __future__ import annotations

from refmodel import config as cfglib
from refmodel.models.animal import AnimalModel
from refmodel.phase import Phase
from refmodel.predictors.motion_vae import (MotionVAEConfig,
                                            MotionVAEPredictor)


class Ponymation(AnimalModel):

    def __init__(self, cfg: dict, device="cuda", **render):
        pred_inst = cfg.get("cfg_predictor_instance") or {}
        if not pred_inst.get("enable_motion_vae", True):
            raise NotImplementedError("the reference Ponymation is of "
                                      "stage 2 (enable_motion_vae) alone")
        self.cfg_motion_vae = cfglib.bind(MotionVAEConfig,
                                          pred_inst.get("cfg_motion_vae"))
        super().__init__(cfg, device=device, **render)
        for name, p in self.named_parameters():
            if self.frozen_param(name.split(".")):
                p.requires_grad_(False)

    def make_net_instance(self):
        return MotionVAEPredictor(self.cfg_predictor_instance,
                                  cfg_motion_vae=self.cfg_motion_vae,
                                  image_size=self.in_image_size)

    def frozen_param(self, keys) -> bool:
        return keys[0] in ("netInstance", "netBase") and "netVAE" not in keys

    def use_recon_losses(self, phase: Phase) -> bool:
        return False

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
