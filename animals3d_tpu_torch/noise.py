"""The random numbers of one training forward.

`torch.Generator` and `jax.random` give different numbers from the same
seed, so every random site of the training forward takes either the drawn
values (a `Noise`, as the parity tests hand to both packages) or a
generator to draw them from. The fields are uniform [0, 1) draws, except
the index fields (the random pose hypothesis, the surface vertices,
`generate`'s frame), the random view's whole degrees and the standard
normal draws whose names end in `_normal` (Ponymation's VAE ε and
`generate`'s z before its 1.5 scale).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Noise:
    jitter_u: Optional[torch.Tensor] = None    # () global grid jitter
    rand_idx: Optional[torch.Tensor] = None    # (N,) int random pose hypothesis
    best_u: Optional[torch.Tensor] = None      # (N,) < p_best keeps the best
    rand_pts_u: Optional[torch.Tensor] = None  # (5000, 3) eikonal points
    surf_idx: Optional[torch.Tensor] = None    # (5000,) int surface vertices
    surf_u: Optional[torch.Tensor] = None      # (5000, 3) surface offsets
    rv_deg: Optional[torch.Tensor] = None      # (N,) int random view, degrees
    vae_normal: Optional[torch.Tensor] = None  # (z_tokens, B, D) VAE ε
    gen_pick: Optional[torch.Tensor] = None    # () int frame `generate` takes
    gen_z_normal: Optional[torch.Tensor] = None  # (z_tokens, S, D) its z


def uniform(value, shape, gen: Optional[torch.Generator], device):
    """`value` on `device` if given, else a fresh U[0, 1) draw of `shape`
    from `gen` (made on the generator's device)."""
    if value is not None:
        return torch.as_tensor(value, dtype=torch.float32, device=device)
    if gen is None:
        raise ValueError("a random site needs its value or a generator")
    return torch.rand(shape, generator=gen, device=gen.device).to(device)


def normal(value, shape, gen: Optional[torch.Generator], device):
    """`value` on `device` if given, else a fresh standard normal draw of
    `shape` from `gen` (made on the generator's device)."""
    if value is not None:
        return torch.as_tensor(value, dtype=torch.float32, device=device)
    if gen is None:
        raise ValueError("a random site needs its value or a generator")
    return torch.randn(shape, generator=gen, device=gen.device).to(device)
