"""Convolutional encoders (port of `animals3d_tpu.networks.encoders`;
NCHW throughout, where flax is NHWC inside).

`Encoder32` is the conv head MagicPony puts on DINO patch features: 3×
(stride-2 4×4 conv + GroupNorm + LeakyReLU) down to 4×4 for a 32×32
input, then a valid conv to 1×1. `Encoder` is the generic image encoder
of the same form. The torchvision-architecture encoders (`VGGEncoder`,
`ResnetEncoder`, `ResnetDepthEncoder`, reference `encoders.py:91-146`)
are API surface that no shipped config uses; their batch norms are
pinned to the running statistics (`FrozenBatchNorm`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch.networks.mlp import Dense, get_activation, uniform_
from animals3d_tpu_torch.precision import compute_dtype


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
        return F.conv2d(x.to(cd), self.weight.to(cd),
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


class Encoder(nn.Module):
    """Generic image encoder: stride-2 4×4 convs (GroupNorm, LeakyReLU)
    doubling the width up to 512 until the map is 4×4, then a valid 4×4
    conv to 1×1. (B, cin, in_size, in_size) → (B, cout)."""

    def __init__(self, cin: int, cout: int, in_size: int = 128, nf: int = 64,
                 activation: Optional[str] = None):
        super().__init__()
        self.activation = activation
        self.n_down = 0
        c, size = cin, in_size
        while size > 4:
            w = min(nf, 512)
            setattr(self, f"conv_{self.n_down}", Conv(c, w, 4, 2, 1))
            setattr(self, f"norm_{self.n_down}", GroupNorm(w // 4, w))
            c, size, nf = w, size // 2, min(nf * 2, 512)
            self.n_down += 1
        self.conv_out = Conv(c, cout, 4, 1, 0)

    def forward(self, x):
        for i in range(self.n_down):
            x = getattr(self, f"conv_{i}")(x)
            x = F.leaky_relu(getattr(self, f"norm_{i}")(x), 0.2)
        x = get_activation(self.activation)(self.conv_out(x))
        return x.reshape(x.shape[0], -1)


_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16Features(nn.Module):
    """torchvision `vgg16().features`: 3×3 / pad-1 convs with bias + ReLU,
    2×2 max pools."""

    def __init__(self, cin: int = 3):
        super().__init__()
        i = 0
        for item in _VGG16_PLAN:
            if item != "M":
                setattr(self, f"conv_{i}", Conv(cin, item, 3, 1, 1,
                                                bias=True))
                cin = item
                i += 1

    def forward(self, x):
        i = 0
        for item in _VGG16_PLAN:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"conv_{i}")(x))
                i += 1
        return x


def _adaptive_avg_pool(x, out_hw: int):
    """AdaptiveAvgPool2d to out_hw × out_hw for (B, C, H, W) sizes
    divisible by it (the reference's cases: 224² → 7², global → 1²):
    the bins are then equal windows, those of `F.adaptive_avg_pool2d`."""
    h, w = x.shape[2], x.shape[3]
    if h == out_hw and w == out_hw:
        return x
    if h % out_hw or w % out_hw:
        raise ValueError(f"adaptive pool of {h}×{w} to {out_hw}: the sizes "
                         "must divide")
    return F.avg_pool2d(x, (h // out_hw, w // out_hw))


class VGGEncoder(nn.Module):
    """vgg16 features + 7×7 adaptive average pool + 25088 → 4096 → cout
    head (ReLU between)."""

    def __init__(self, cout: int):
        super().__init__()
        self.features = VGG16Features()
        self.linear1 = Dense(25088, 4096, init="lecun")
        self.linear2 = Dense(4096, cout, init="lecun")

    def forward(self, x):
        x = _adaptive_avg_pool(self.features(x), 7)
        x = F.relu(self.linear1(x.reshape(x.shape[0], -1)))
        return self.linear2(x)


class FrozenBatchNorm(nn.Module):
    """Batch norm pinned to its running statistics (torch `.eval()` BN),
    in float32; mean and var are parameters, as in the flax tree."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        inv = torch.rsqrt(self.var + self.eps) * self.weight
        shift = self.bias - self.mean * inv
        return x.float() * inv[:, None, None] + shift[:, None, None]


class BasicBlock(nn.Module):
    """torchvision resnet BasicBlock: two 3×3 convs with frozen BN and an
    identity or 1×1-projection skip."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, stride, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = Conv(features, features, 3, 1, 1)
        self.bn2 = FrozenBatchNorm(features)
        self.project = stride != 1 or cin != features
        if self.project:
            self.downsample = Conv(cin, features, 1, stride, 0)
            self.downsample_bn = FrozenBatchNorm(features)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.project:
            x = self.downsample_bn(self.downsample(x))
        return F.relu(x + y)


class ResNet18Trunk(nn.Module):
    """torchvision resnet18 without its fc: conv1 / bn / relu / max pool
    and 4 stages of 2 BasicBlocks. Returns {layer1..layer4: (B, C, H, W),
    pooled: (B, 512)}."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.conv1 = Conv(cin, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        c = 64
        for li, (feats, stride) in enumerate(
                [(64, 1), (128, 2), (256, 2), (512, 2)], start=1):
            setattr(self, f"layer{li}_0", BasicBlock(c, feats, stride))
            setattr(self, f"layer{li}_1", BasicBlock(feats, feats, 1))
            c = feats

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        taps = {}
        for li in range(1, 5):
            x = getattr(self, f"layer{li}_1")(getattr(self, f"layer{li}_0")(x))
            taps[f"layer{li}"] = x
        taps["pooled"] = x.mean((2, 3))
        return taps


class ResnetEncoder(nn.Module):
    """resnet18 trunk + 512 → cout linear."""

    def __init__(self, cout: int):
        super().__init__()
        self.resnet = ResNet18Trunk()
        self.final_linear = Dense(512, cout, init="lecun")

    def forward(self, x):
        return self.final_linear(self.resnet(x)["pooled"])


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class ResnetDepthEncoder(nn.Module):
    """resnet18 over a 3-channel depth image with ImageNet normalization:
    (global pooled (B, 512), layer2 features (B, 128, H/8, W/8))."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet18Trunk()

    def forward(self, x):
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype,
                            device=x.device)[:, None, None]
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype,
                           device=x.device)[:, None, None]
        taps = self.resnet((x - mean) / std)
        return taps["pooled"], taps["layer2"]
