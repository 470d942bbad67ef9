"""Static schedule switches (which submodules and grid a forward uses).

Everything here changes the *structure* of the forward (enabled
submodules, grid resolution, constraint sets); smooth schedules
(temperatures, loss-weight ramps) are plain values computed per call.
A training run visits only a handful of phases (reference schedule:
coarse→fine at 100k, articulation at 10k, leg attach at 60k, deform at 90k,
Fauna leg-rotation release at 300k, discriminator window 80k-300k).
"""
from __future__ import annotations

from typing import NamedTuple


class Phase(NamedTuple):
    use_coarse_grid: bool = False
    deform_on: bool = False
    articulation_on: bool = False
    attach_legs: bool = False
    is_training: bool = True
    # Fauna extensions
    constrain_legs: bool = False
    zeroy: bool = True
    leg_rot_started: bool = False
    disc_on: bool = False

    @property
    def key(self):
        return tuple(self)
