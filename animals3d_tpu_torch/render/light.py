"""Directional light (port of `DirectionalLight`, `directional_shade` and
`fixed_direction_light` of `animals3d_tpu.render.light`): an MLP predicts
a light direction in the upper hemisphere plus ambient and diffuse
intensities; the Visualizer relights with a fixed one. The environment
light of the pbr path is not ported yet."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from animals3d_tpu_torch.networks.mlp import MLP
from animals3d_tpu_torch.ops import shading


class DirectionalLight(nn.Module):
    """MLP(feat) → (light_dir, ambient, diffuse), (B, 5)."""

    def __init__(self, cin: int, mlp_layers: int = 5,
                 mlp_hidden_size: int = 256,
                 intensity_min_max: Optional[Sequence] = None):
        super().__init__()
        self.mlp = MLP(cin, 4, mlp_layers, mlp_hidden_size,
                       activation="sigmoid")
        self.intensity_min_max = intensity_min_max

    def forward(self, feat):
        out = self.mlp(feat)
        direction = torch.cat([out[..., 0:1] * 2 - 1,
                               torch.full_like(out[..., :1], 0.5),
                               out[..., 1:2] * 2 - 1], -1)
        direction = shading.safe_normalize(direction)
        intensity = out[..., 2:]
        if self.intensity_min_max is not None:
            mm = torch.as_tensor(self.intensity_min_max, dtype=out.dtype,
                                 device=out.device)
            intensity = intensity * (mm[:, 1] - mm[:, 0]) + mm[:, 0]
        return torch.cat([direction, intensity], -1)

    def shade(self, feat, kd, normal):
        """kd, normal (B, H, W, 3), the normal in camera space →
        (shaded, shading)."""
        return directional_shade(self(feat), kd, normal)


def directional_shade(light_params, kd, normal):
    """shaded = (amb + diff·max(l·n, 0)) · kd for (B, 5) light params and
    (B, H, W, 3) kd / camera-space normal. Returns (shaded, shading)."""
    light_dir = light_params[..., None, None, 0:3]
    amb = light_params[..., None, None, 3:4]
    diff = light_params[..., None, None, 4:5]
    shade = amb + diff * torch.clamp(shading.dot(light_dir, normal), min=0.0)
    return shade * kd, shade


def fixed_direction_light(direction, amb: float, diff: float, batch: int):
    """Constant (batch, 5) light params: the normalized `direction` (3,),
    ambient and diffuse intensities."""
    d = shading.safe_normalize(torch.as_tensor(direction).reshape(1, 3))
    d = d.expand(batch, 3)
    intens = torch.tensor([[amb, diff]], dtype=d.dtype,
                          device=d.device).expand(batch, 2)
    return torch.cat([d, intens], -1)
