"""Faults planted under the timed path, which the check has to catch
(`correct` false): each is the program's side with one thing broken.

- `Unchanged`: a training step that returns its state unchanged (the
  forward and backward run, no optimizer steps).
- `HalfBatch`: half of the batch left out of each step, the mean taken
  over the rest.
- `Altered`: a reconstruction whose answer is altered where it is made
  (the first image of each batch mirrored left to right).
- `SdfZero`, `SdfScaled`: netSDF's gradient (K7's, where the sweep is
  fused) zeroed, or doubled, before it reaches the optimizer; the rest of
  the step as it is.

A cell on one chip has no exchange between chips to leave out."""
from __future__ import annotations

from harness.sides import Side


class Unchanged(Side):
    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        loss, (metrics, _aux) = model.forward(batch, total_iter, gen, phase)
        loss.backward()
        optimizer.zero_grad(set_to_none=True)
        for opt in optimizer._all().values():
            for g in opt.param_groups:
                for p in g["params"]:
                    st = opt.state[p]
                    if "exp_avg" not in st:   # Adam state as after a step
                        st["step"] = p.new_zeros(())
                        st["exp_avg"] = p.detach().new_zeros(p.shape)
                        st["exp_avg_sq"] = p.detach().new_zeros(p.shape)
        return {k: v.detach() if hasattr(v, "detach") else v
                for k, v in metrics.items()}

    def disc_step(self, model, optimizer, record):
        model.netDisc.zero_grad(set_to_none=True)
        return model.discriminator_loss(record).detach()


class HalfBatch(Side):
    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        half = {k: v if v is None else v[:max(1, v.shape[0] // 2)]
                for k, v in batch.items()}
        return super().train_step(model, optimizer, half, total_iter, gen,
                                  phase)


class Altered(Side):
    def reconstruct(self, model, images, total_iter: int):
        rgba, out = super().reconstruct(model, images, total_iter)
        rgba = rgba.clone()
        rgba[0] = rgba[0].flip(-1)
        return rgba, out


class SdfZero(Side):
    factor = 0.0

    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        if not getattr(model, "_fault_hooked", False):
            for p in model.netBase.netSDF.parameters():
                p.register_hook(lambda g, f=self.factor: g * f)
            model._fault_hooked = True
        return super().train_step(model, optimizer, batch, total_iter, gen,
                                  phase)


class SdfScaled(SdfZero):
    factor = 2.0


def planted(kind: str) -> Side:
    """The program's side with the fault `kind` planted."""
    cls = {"unchanged": Unchanged, "halfbatch": HalfBatch,
           "altered": Altered, "sdfzero": SdfZero,
           "sdfscaled": SdfScaled}[kind]
    return cls("animals3d_tpu_torch", name=kind)
