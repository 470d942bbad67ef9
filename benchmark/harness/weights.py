"""The weights of a cell, made by the benchmark from the seed.

The reference's copy of the model (`refmodel`, the port's initializers)
is built on the device and every module's `init_weights` draws from one
`torch.Generator` on the device, in the order `init_params` walks them.
Both sides load the resulting state: the program never makes the weights
it is judged on. The distributions are the port's (the JAX package's
init distributions); the draws differ from `init_params`', which draws on
the host."""
from __future__ import annotations

import torch


def make(ref_cfg: dict, seed: int, device) -> dict:
    """The state dict (parameters and buffers) of a fresh reference model
    of `ref_cfg`, initialized from `seed` on `device`."""
    from harness.sides import reference
    model = reference().build(ref_cfg, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    return state
