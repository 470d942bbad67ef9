"""Coordinate MLPs and harmonic embeddings (port of `animals3d_tpu.networks.mlp`).

Same layer layout, activation order and min-max output mapping as the JAX
package, so a flax parameter tree maps 1:1 onto these modules
(`convert_jax.load_jax_params`): `MLP` layers are bias-free,
`CoordMLP.in_layer` has a bias, the conditioning feature is ReLU'd with
the pixel half and folded into `layer_0` (`SplitFirstDense`), and the
embedding is [sin block | cos block] with per-coordinate contiguous
frequencies. Fauna's weight-modulated SDF is `CoordMLPMod` (`MLPMod` of
`LinearMod` layers, conditioned through a 2-layer `style_mlp`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch.device import constant
from animals3d_tpu_torch.precision import compute_dtype


def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


def lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


class Dense(nn.Linear):
    """Linear layer computing in the mixed-precision compute dtype.

    init: "torch" = U(±1/sqrt(fan_in)) weight with the bias zeroed unless
    `bias_fan_in` (the JAX package's `networks.mlp.dense`); "lecun" =
    flax's default (truncated-normal weight, zero bias). `float32=True`
    computes in float32 whatever the policy (flax `nn.Dense` without a
    dtype)."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 init: str = "torch", bias_fan_in: Optional[int] = None,
                 float32: bool = False):
        super().__init__(cin, cout, bias=bias)
        self.init_kind = init
        self.bias_fan_in = bias_fan_in
        self.float32 = float32

    def init_weights(self, gen: torch.Generator):
        fan_in = self.in_features
        if self.init_kind == "lecun":
            lecun_normal_(self.weight, fan_in, gen)
        else:
            uniform_(self.weight, 1.0 / math.sqrt(fan_in) if fan_in else 0.0,
                     gen)
        if self.bias is not None:
            if self.init_kind == "torch" and self.bias_fan_in:
                uniform_(self.bias, 1.0 / math.sqrt(self.bias_fan_in), gen)
            else:
                with torch.no_grad():
                    self.bias.zero_()

    def forward(self, x):
        cd = torch.float32 if self.float32 else compute_dtype()
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


def get_activation(name: Optional[str]):
    if name is None:
        return lambda x: x
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": F.relu,
            "softplus": F.softplus, "elu": F.elu,
            "leakyrelu": lambda x: F.leaky_relu(x, 0.2)}[name]


def harmonic_embedding(x: torch.Tensor, n_harmonic_functions: int = 10,
                       scalar: float = 1.0) -> torch.Tensor:
    """[..., D] → [..., D*2*n] with (sin | cos) blocks, per-coordinate
    contiguous frequencies scalar * 2^i."""
    freqs = scalar * (2.0 ** torch.arange(n_harmonic_functions,
                                          dtype=x.dtype, device=x.device))
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(embed), torch.cos(embed)], -1)


class SplitFirstDense(Dense):
    """Bias-free dense over a (pixel ⊕ broadcast-feature) concat, computed
    as x @ W_pix + feat @ W_feat without materializing the concat. The
    weight is the fused layer's (out, dx + df), like `_SplitFirstDense`."""

    def __init__(self, dx: int, df: int, cout: int):
        super().__init__(dx + df, cout, bias=False)
        self.dx = dx

    def forward(self, x, feat):
        cd = compute_dtype()
        W = self.weight.to(cd)
        pix = F.linear(x.to(cd), W[:, :self.dx])
        per_img = F.linear(feat.to(cd), W[:, self.dx:])
        per_img = per_img.reshape(feat.shape[0], *([1] * (x.ndim - 2)), -1)
        return pix + per_img


class MLP(nn.Module):
    """Bias-free Linear/ReLU stack with an optional output activation.
    `split_dim` > 0 folds a per-image (B, split_dim) feature into layer_0."""

    def __init__(self, cin: int, cout: int, num_layers: int, nf: int = 256,
                 activation: Optional[str] = None, split_dim: int = 0):
        super().__init__()
        self.num_layers = num_layers
        self.activation = activation
        first_out = cout if num_layers == 1 else nf
        if split_dim:
            self.layer_0 = SplitFirstDense(cin, split_dim, first_out)
        else:
            self.layer_0 = Dense(cin, first_out, bias=False)
        for i in range(1, num_layers - 1):
            setattr(self, f"layer_{i}", Dense(nf, nf, bias=False))
        if num_layers > 1:
            setattr(self, f"layer_{num_layers - 1}",
                    Dense(nf, cout, bias=False))

    def forward(self, x, split_feat=None):
        if split_feat is not None:
            x = self.layer_0(x, split_feat)
        else:
            x = self.layer_0(x)
        for i in range(1, self.num_layers):
            x = getattr(self, f"layer_{i}")(F.relu(x))
        # back to float32 at the network boundary (precision.py)
        return get_activation(self.activation)(x.float())


def _apply_min_max(out, min_max):
    if min_max is None:
        return out
    mm = constant(min_max, out.device, out.dtype)
    return out * (mm[:, 1] - mm[:, 0]) + mm[:, 0]


class CoordMLP(nn.Module):
    """3D-field MLP: harmonic-embed points, optionally fold in a
    conditioning feature, bias-free MLP, then min-max range mapping."""

    def __init__(self, cin: int, cout: int, num_layers: int, nf: int = 256,
                 activation: Optional[str] = None,
                 min_max: Optional[Sequence] = None,
                 n_harmonic_functions: int = 10, embedder_scalar: float = 1.0,
                 embed_concat_pts: bool = True, extra_feat_dim: int = 0,
                 symmetrize: bool = False, in_layer_relu: bool = False):
        super().__init__()
        self.n_harmonic_functions = n_harmonic_functions
        self.embedder_scalar = embedder_scalar
        self.embed_concat_pts = embed_concat_pts
        self.extra_feat_dim = extra_feat_dim
        self.symmetrize = symmetrize
        self.in_layer_relu = in_layer_relu
        self.min_max = None if min_max is None else \
            tuple(tuple(float(v) for v in r) for r in min_max)
        if n_harmonic_functions > 0:
            dim_in = cin * 2 * n_harmonic_functions + \
                (cin if embed_concat_pts else 0)
        else:
            dim_in = cin
        self.in_layer = Dense(dim_in, nf, bias=True, bias_fan_in=dim_in)
        self.mlp = MLP(nf, cout, num_layers, nf, activation,
                       split_dim=extra_feat_dim)

    def embed(self, x):
        if self.symmetrize:
            x = torch.cat([x[..., :1].abs(), x[..., 1:]], -1)
        if self.n_harmonic_functions <= 0:
            return x
        e = harmonic_embedding(x, self.n_harmonic_functions,
                               self.embedder_scalar)
        return torch.cat([x, e], -1) if self.embed_concat_pts else e

    def forward(self, x, feat=None):
        # x: (B, ..., cin); feat: (B, C) broadcast over the point dims
        h = self.in_layer(self.embed(x))
        if self.in_layer_relu:
            h = F.relu(h)
        split_feat = None
        if feat is not None:
            if feat.shape[-1] != self.extra_feat_dim:
                raise ValueError(f"feat dim {feat.shape[-1]} != "
                                 f"{self.extra_feat_dim}")
            # relu(concat(x, feat)) = concat(relu(x), relu(feat))
            split_feat = F.relu(feat.reshape(feat.shape[0], -1))
        out = self.mlp(F.relu(h), split_feat=split_feat)
        return _apply_min_max(out.float(), self.min_max)


class LinearMod(nn.Module):
    """StyleGAN-style modulated-demodulated linear layer, bias-free.

    The weight is kept as (out, in), as `nn.Linear` keeps it; flax keeps it
    as (in, out) under the leaf name `weight`, which `convert_jax`
    transposes (`FLAX_WEIGHT_IN_OUT`). Only the first style vector of the
    batch modulates, as in the reference. The input axis is scaled by the
    style, then each output row is divided by sqrt(sum over the input axis
    of the squared weight + 1e-5). Computes in float32 whatever the
    precision policy: flax promotes the bf16 activation against the
    float32 weight."""

    FLAX_WEIGHT_IN_OUT = True

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))

    def init_weights(self, gen: torch.Generator):
        fan_in = self.weight.shape[1]
        uniform_(self.weight, 1.0 / math.sqrt(fan_in) if fan_in else 0.0, gen)

    def forward(self, x, style):
        style = style.reshape(-1, style.shape[-1])[0].float()     # (in,)
        w = self.weight * style[None, :]
        w = w / torch.sqrt((w * w).sum(1, keepdim=True) + 1e-5)
        return F.linear(x.float(), w)


class MLPMod(nn.Module):
    """`LinearMod` / ReLU stack with an optional output activation."""

    def __init__(self, cin: int, cout: int, num_layers: int, nf: int = 256,
                 activation: Optional[str] = None):
        super().__init__()
        self.num_layers = num_layers
        self.activation = activation
        for i in range(num_layers):
            setattr(self, f"linear_{i}", LinearMod(
                cin if i == 0 else nf, cout if i == num_layers - 1 else nf))

    def forward(self, x, style):
        for i in range(self.num_layers):
            x = getattr(self, f"linear_{i}")(x, style)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return get_activation(self.activation)(x)


class CoordMLPMod(nn.Module):
    """Conditional CoordMLP with weight modulation (Fauna's conditional
    SDF): harmonic-embed the points, a biased `in_layer` and ReLU, then
    `MLPMod` modulated by `style_mlp(feat)`, a plain 2-layer `MLP` on the
    condition (B, condition_dim)."""

    def __init__(self, cin: int, cout: int, num_layers: int, nf: int = 256,
                 activation: Optional[str] = None,
                 min_max: Optional[Sequence] = None,
                 n_harmonic_functions: int = 10, embedder_scalar: float = 1.0,
                 embed_concat_pts: bool = True, symmetrize: bool = False,
                 condition_dim: int = 128):
        super().__init__()
        self.n_harmonic_functions = n_harmonic_functions
        self.embedder_scalar = embedder_scalar
        self.embed_concat_pts = embed_concat_pts
        self.symmetrize = symmetrize
        self.condition_dim = condition_dim
        self.min_max = None if min_max is None else \
            tuple(tuple(float(v) for v in r) for r in min_max)
        if n_harmonic_functions > 0:
            dim_in = cin * 2 * n_harmonic_functions + \
                (cin if embed_concat_pts else 0)
        else:
            dim_in = cin
        self.in_layer = Dense(dim_in, nf, bias=True, bias_fan_in=dim_in)
        self.style_mlp = MLP(condition_dim, nf, 2, nf, None)
        self.mlp = MLPMod(nf, cout, num_layers, nf, activation)

    embed = CoordMLP.embed

    def forward(self, x, feat):
        if feat is None or feat.shape[-1] != self.condition_dim:
            raise ValueError(f"CoordMLPMod needs a (B, {self.condition_dim})"
                             " condition")
        h = F.relu(self.in_layer(self.embed(x)))
        style = self.style_mlp(feat)
        out = self.mlp(h, style)
        return _apply_min_max(out.float(), self.min_max)
