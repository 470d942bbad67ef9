"""Fauna instance predictor (port of `animals3d_tpu.predictors.fauna`).

The Fauna model sets the texture's `in_layer_relu`, the articulation
id-add, `bone_y_threshold` and the pose temperature clip of 10 through
the config; what this class changes is the order and the set of the
articulation constraints, which depend on the phase's `constrain_legs`
(until `iter_leg_rotation_start`) and `leg_rot_started` (after it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors.config import InstancePredictorConfig
from animals3d_tpu_torch.predictors.instance import InstancePredictor


@dataclasses.dataclass(frozen=True)
class FaunaAdditionalConfig:
    """`FaunaInstanceAdditionalConfig` (`InstancePredictorFauna.py:15-22`)."""
    iter_leg_rotation_start: int = 300000
    forbid_leg_rotate: bool = True
    small_leg_angle: bool = True
    reg_body_rotate_mult: float = 0.1
    bone_y_threshold: float = 0.4
    nozeroy_start: int = 20000


def _scaled(angles, entries):
    """angles × a scale of ones set to each (bones, axis, value) entry."""
    scale = torch.ones_like(angles)
    for bones, axis, value in entries:
        scale[:, :, list(bones), axis] = value
    return angles * scale


class FaunaInstancePredictor(InstancePredictor):

    def __init__(self, cfg: InstancePredictorConfig,
                 cfg_additional: FaunaAdditionalConfig,
                 image_size: int = 256):
        super().__init__(cfg, image_size=image_size)
        self.cfg_additional = cfg_additional

    def apply_articulation_constraints(self, angles, phase: Phase):
        """multiplier → tanh → static roots → the leg clamp until the leg
        rotation starts → after it, the top and bottom leg bones' bends
        and twists (small or none) → radians → the body bones' twist
        scaled by `reg_body_rotate_mult` in radian space."""
        a = self.cfg.cfg_articulation
        add = self.cfg_additional
        angles = torch.tanh(angles * a.output_multiplier)
        nb = a.num_body_bones
        if a.static_root_bones:
            angles = _scaled(angles, [([nb // 2 - 1, nb - 1], slice(None),
                                       0.0)])
        legs = nb + np.arange(a.num_leg_bones * a.num_legs)
        if phase.constrain_legs:
            angles = _scaled(angles, [(legs, 2, 0.3), (legs, 1, 0.3)])
        if phase.leg_rot_started and add.forbid_leg_rotate:
            entries = []
            if add.small_leg_angle:
                top = [8, 11, 14, 17]
                entries += [(top, 1, 0.05), (top, 2, 0.05)]
            bottom = [9, 10, 12, 13, 15, 16, 18, 19]
            entries += [(bottom, 1, 0.0), (bottom, 2, 0.0)]
            angles = _scaled(angles, entries)
        angles = angles * (a.max_arti_angle / 180.0 * np.pi)
        mult = add.reg_body_rotate_mult * 180.0 / (a.max_arti_angle * np.pi)
        return _scaled(angles, [(range(nb), 2, mult)])
