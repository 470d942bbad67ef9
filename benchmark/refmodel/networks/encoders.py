"""Convolutional encoders (port of `animals3d_tpu.networks.encoders`;
NCHW throughout, where flax is NHWC inside).

`Encoder32` is the conv head MagicPony puts on DINO patch features: 3×
(stride-2 4×4 conv + GroupNorm + LeakyReLU) down to 4×4 for a 32×32
input, then a valid conv to 1×1. The port's other encoders serve no cell
of the benchmark and are left out of this copy.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from refmodel.networks.mlp import get_activation, uniform_
from refmodel.precision import compute_dtype, rounded


class Conv(nn.Conv2d):
    """Conv computing in the compute dtype, bias-free unless `bias`; init
    U(±1/sqrt(fan_in)) (the JAX package's torch-like variance scaling),
    the bias zeroed."""

    def __init__(self, cin, cout, kernel, stride, padding,
                 bias: bool = False):
        super().__init__(cin, cout, kernel, stride, padding, bias=bias)

    def init_weights(self, gen):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        uniform_(self.weight, 1.0 / math.sqrt(fan_in), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        cd = compute_dtype()
        return F.conv2d(rounded(x), rounded(self.weight),
                        None if self.bias is None else self.bias.to(cd),
                        self.stride, self.padding)


class GroupNorm(nn.GroupNorm):
    """flax GroupNorm (eps 1e-6), computing in float32."""

    def __init__(self, num_groups, channels):
        super().__init__(num_groups, channels, eps=1e-6)

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return super().forward(x.float())


class Encoder32(nn.Module):
    """(B, C, S, S) feature map → (B, cout) vector."""

    def __init__(self, cin: int, cout: int, size: int, nf: int = 256,
                 activation: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.n_down = 0
        c = cin
        while size > 4:
            setattr(self, f"conv_{self.n_down}", Conv(c, nf, 4, 2, 1))
            setattr(self, f"norm_{self.n_down}", GroupNorm(nf // 4, nf))
            c = nf
            size //= 2
            self.n_down += 1
        self.conv_out = Conv(c, cout, size, 1, 0)

    def forward(self, x):
        for i in range(self.n_down):
            x = getattr(self, f"conv_{i}")(x)
            x = F.leaky_relu(getattr(self, f"norm_{i}")(x), 0.2)
        x = get_activation(self.activation)(self.conv_out(x))
        return x.reshape(x.shape[0], -1)
