"""Optimizer and training step (port of `make_optimizer` and the body of
`Trainer._train_step_for` of `animals3d_tpu.trainer`).

The train loop, checkpointing, loaders, logging and the CLI are not ported
yet.
"""
from __future__ import annotations

import torch


class Optimizer:
    """One Adam (AdamW where `weight_decay` is non-zero) per predictor,
    `base` (netBase) and `instance` (netInstance), each with its config's
    learning rate and, where `use_scheduler` is set, a MultiStepLR stepped
    once per iteration. Frozen parameters (the DINO ViT) are in no group."""

    def __init__(self, model):
        self.optimizers, self.schedulers = {}, {}
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
        for opt in self.optimizers.values():
            opt.step()
        for sched in self.schedulers.values():
            sched.step()

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)


def make_optimizer(model) -> Optimizer:
    return Optimizer(model)


def train_step(model, optimizer: Optimizer, batch, total_iter, gen=None,
               phase=None, noise=None):
    """One training step: forward, backward, optimizer step. Returns the
    metrics (detached tensors)."""
    loss, (metrics, _aux) = model.forward(batch, total_iter, gen, phase,
                                          noise=noise)
    loss.backward()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)
    return {k: v.detach() if torch.is_tensor(v) else v
            for k, v in metrics.items()}
