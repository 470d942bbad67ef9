"""The training step of the reference: one Adam (AdamW where the
predictor's config has weight decay) per predictor, a MultiStepLR where
asked for, the forward, the backward and a step of each; Fauna's
discriminator step with its own Adam.

Frozen copy of `Optimizer`, `make_optimizer`, `train_step` and `disc_step`
of `animals3d_tpu_torch/trainer.py` for the benchmark's reference, with
the data-parallel reductions and the checkpoint state taken out (the
reference runs one process).
"""
from __future__ import annotations

import torch


class Optimizer:
    """One Adam (AdamW where `weight_decay` is non-zero) per predictor,
    `base` (netBase) and `instance` (netInstance), each with its config's
    learning rate and, where `use_scheduler` is set, a MultiStepLR stepped
    once per iteration. Frozen parameters, which the model keeps without
    gradient (the DINO ViT, and those its `frozen_param` names:
    Ponymation's stages), are in no group, and a predictor with none left
    gets no optimizer (Ponymation's stage 1 has no `base` Adam), as the
    JAX trainer's `set_to_zero` partitions leave them where they are.
    A model with a discriminator (Fauna) also gets `disc`, a plain Adam on
    `netDisc` at `cfg_optim_discriminator.lr` (`optax.adam` in the JAX
    trainer), which `step` and `zero_grad` leave alone: `disc_step` runs
    it. Its state is saved with the others but never restored: the JAX
    trainer keeps no such state and starts the discriminator's Adam afresh
    at the first discriminator step of every run, a resumed one too."""

    def __init__(self, model):
        self.optimizers, self.schedulers = {}, {}
        self.disc = None
        if getattr(model, "netDisc", None) is not None:
            self.disc = torch.optim.Adam(
                model.netDisc.parameters(),
                lr=model.cfg_optim_discriminator.lr, eps=1e-8)
        for name, net, cfg in (
                ("base", model.netBase, model.cfg_optim_base),
                ("instance", model.netInstance, model.cfg_optim_instance)):
            params = [p for p in net.parameters() if p.requires_grad]
            if not params:
                continue
            if cfg.weight_decay:
                # optax.adamw's defaults: eps 1e-8, decoupled decay
                opt = torch.optim.AdamW(params, lr=cfg.lr, eps=1e-8,
                                        weight_decay=cfg.weight_decay)
            else:
                opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)
            self.optimizers[name] = opt
            if cfg.use_scheduler:
                self.schedulers[name] = torch.optim.lr_scheduler.MultiStepLR(
                    opt, milestones=[int(m) for m in cfg.scheduler_milestone],
                    gamma=cfg.scheduler_gamma)

    def step(self):
        """A step of every optimizer. A grouped parameter the step did not
        reach (netDeform before its phase; netArticulation in Ponymation's
        stage 1 before articulation starts) takes a zero gradient, as in
        the JAX trainer, whose optax Adam counts every step of a
        partition: torch's Adam skips a parameter without gradient, and
        would start its bias correction later."""
        for opt in self.optimizers.values():
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            opt.step()
        for sched in self.schedulers.values():
            sched.step()

    def trained(self) -> list:
        """The parameters of every optimizer but `disc`."""
        return [p for opt in self.optimizers.values()
                for g in opt.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def _all(self) -> dict:
        """Every optimizer by name, `disc` included where there is one."""
        return {**self.optimizers,
                **({"disc": self.disc} if self.disc is not None else {})}


def make_optimizer(model) -> Optimizer:
    return Optimizer(model)


def train_step(model, optimizer: Optimizer, batch, total_iter, gen=None,
               phase=None, noise=None):
    """One training step: forward, backward, the gradients, optimizer step. Returns
    the metrics (detached tensors)."""
    loss, (metrics, _aux) = model.forward(batch, total_iter, gen, phase,
                                          noise=noise)
    if loss.requires_grad:       # else no trained parameter reaches the loss
        loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in metrics.items()}


def disc_step(model, optimizer: Optimizer, record):
    """The discriminator's step on the masks the generator step recorded:
    `discriminator_loss` (its R1 penalty included), backward into
    `netDisc` alone, a step of the `disc` Adam. The generator's backward leaves gradients
    on `netDisc`; they are dropped first. Returns the detached loss."""
    model.netDisc.zero_grad(set_to_none=True)
    loss = model.discriminator_loss(record)
    loss.backward()
    optimizer.disc.step()
    model.netDisc.zero_grad(set_to_none=True)
    return loss.detach()
