"""DCGAN-style mask discriminator and its GAN losses (Fauna; port of
`animals3d_tpu.networks.discriminator`).

log2(img_size) − 2 stride-2 4×4 convolutions without bias (padding 1,
LeakyReLU 0.2) on the (1 + class_dim)-channel mask ⊕ condition input,
then a VALID 4×4 output convolution; NCHW/OIHW where flax is NHWC/HWIO
(`convert_jax` transposes the kernels). The convolutions are
`F.conv2d` in float32: the JAX package leaves them to XLA, in float32.
The R1 penalty differentiates D's input gradient again
(`create_graph=True`).
"""
from __future__ import annotations

from math import log2

import torch
import torch.nn.functional as F
from torch import nn

from refmodel.networks.mlp import lecun_normal_


class DiscConv(nn.Conv2d):
    """Bias-free float32 convolution with flax's default init (truncated
    normal, variance 1/fan_in)."""

    def __init__(self, cin, cout, stride, padding):
        super().__init__(cin, cout, 4, stride, padding, bias=False)

    def init_weights(self, gen):
        lecun_normal_(self.weight, self.in_channels * 16, gen)

    def forward(self, x):
        return F.conv2d(x.float(), self.weight, None, self.stride,
                        self.padding)


class DCDiscriminator(nn.Module):

    def __init__(self, in_dim: int = 1, out_dim: int = 1, n_feat: int = 512,
                 img_size: int = 256):
        super().__init__()
        self.out_dim = out_dim
        self.n_layers = int(log2(img_size) - 2)
        cin = in_dim
        for i in range(self.n_layers):
            feat = int(n_feat / (2 ** (self.n_layers - 1 - i)))
            setattr(self, f"conv_{i}", DiscConv(cin, feat, 2, 1))
            cin = feat
        self.conv_out = DiscConv(cin, out_dim, 1, 0)

    def forward(self, x):                       # (B, C, H, W)
        for i in range(self.n_layers):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.2)
        return self.conv_out(x).reshape(x.shape[0], self.out_dim)


def bce_loss_target(d_out, target: float):
    """BCE-with-logits against a constant target, in the JAX package's
    form max(d, 0) − d·t + log1p(exp(−|d|))."""
    return (torch.clamp(d_out, min=0) - d_out * target
            + torch.log1p(torch.exp(-d_out.abs()))).mean()


def r1_penalty(disc_fn, x):
    """R1 gradient penalty: the batch mean of ‖∂ sum(D(x)) / ∂x‖² per
    sample. The gradient keeps its graph, so the penalty differentiates
    with respect to D's weights."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        grads, = torch.autograd.grad(disc_fn(x).sum(), x, create_graph=True)
    return (grads.reshape(grads.shape[0], -1) ** 2).sum(-1).mean()
