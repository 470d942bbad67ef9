"""Faults of the Ponymation training cells (the `pony_train` entry),
planted under the timed path beside those of `faults`, which the check
has to catch (`correct` false):

- `KldDropped`: the KL term left out of the loss (the `kld_loss` term is
  still computed and reported; the loss and its gradient lack it).
- `EpsZero`: the VAE's ε set to zero, so that the posterior's mean is
  decoded (ε is still drawn, so the later draws stay in step).
- `SkinHalf`: the meshes skinned with half the VAE's angles (the losses
  read the angles themselves, so only the posed meshes show it).

The readings for the limits of such a cell, for the program, the controls
and every fault (`faults.planted`'s too):

    python3 benchmark/harness/faults_pony.py --workload ponymation.stage2 \
        --what program,control,bf16,unchanged,halfbatch,klddropped,epszero,\
skinhalf --seeds 1,2,3

which runs `calibrate` with this module's sides (`side_of`)."""
from __future__ import annotations

import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.path.append(os.path.dirname(HERE))

from harness import faults  # noqa: E402
from harness.sides import Side  # noqa: E402


class KldDropped(Side):
    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        if not getattr(model, "_fault_hooked", False):
            extra = model.extra_losses

            def without_kld(batch, total_iter, final_losses, metrics, ctx):
                total = extra(batch, total_iter, final_losses, metrics, ctx)
                return total - final_losses["kld_loss"] \
                    * model.cfg_loss.kld_loss_weight
            model.extra_losses = without_kld
            model._fault_hooked = True
        return super().train_step(model, optimizer, batch, total_iter, gen,
                                  phase)


class EpsZero(Side):
    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        vae = model.netInstance.netVAE
        if not getattr(vae, "_fault_hooked", False):
            fwd = vae.forward
            vae.forward = lambda inputs, pos, nframes, batch_size, eps: fwd(
                inputs, pos, nframes, batch_size, torch.zeros_like(eps))
            vae._fault_hooked = True
        return super().train_step(model, optimizer, batch, total_iter, gen,
                                  phase)


class _HalfAngles:
    """A skinning module whose `skinning` takes half the angles."""

    def __init__(self, sk):
        self._sk = sk

    def __getattr__(self, name):
        return getattr(self._sk, name)

    def skinning(self, v_pos, bones, structure, angles, **kwargs):
        return self._sk.skinning(v_pos, bones, structure, 0.5 * angles,
                                 **kwargs)


class SkinHalf(Side):
    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        from animals3d_tpu_torch.predictors import motion_vae
        sk = motion_vae.sk
        motion_vae.sk = _HalfAngles(sk)
        try:
            return super().train_step(model, optimizer, batch, total_iter,
                                      gen, phase)
        finally:
            motion_vae.sk = sk


def planted(kind: str) -> Side:
    """The program's side with the fault `kind` planted: this module's or
    `faults.planted`'s."""
    cls = {"klddropped": KldDropped, "epszero": EpsZero,
           "skinhalf": SkinHalf}.get(kind)
    if cls is None:
        return faults.planted(kind)
    return cls("animals3d_tpu_torch", name=kind)


def side_of(what: str) -> Side:
    """program; control (the reference in float8 in the program's place);
    bf16 (the reference with bfloat16 matmul operands, the precision next
    below the float32 that the configuration states); or a planted
    fault."""
    from harness import sides
    from harness.entries import pony_train
    if what == "program":
        return sides.program()
    if what in ("control", "bf16"):
        return pony_train.reference_side(
            "fp8" if what == "control" else "bf16", name=what)
    return planted(what)


def main(argv=None) -> int:
    from harness import calibrate
    calibrate.side_of = side_of
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
