"""Articulation network: per-bone Euler angles from bone features + pose
codes (port of `animals3d_tpu.networks.articulation`).

Input: bone feature ⊕ [code ⊕ harmonics(code)]; the attention variant runs
pre-norm blocks (8 heads, MLP ratio 2, no qkv bias) over the bone tokens.
Its layers compute in float32, as flax `nn.Dense` without a dtype does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from refmodel.networks.mlp import (MLP, Dense, get_activation,
                                              harmonic_embedding)


class LayerNorm5(nn.LayerNorm):
    """LayerNorm eps 1e-5 (flax-named: `scale` ↔ weight)."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-5)

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()


def _dense32(cin, cout, bias=True):
    return Dense(cin, cout, bias=bias, init="lecun", float32=True)


class AttnBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 2.0,
                 qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm5(dim)
        self.qkv = _dense32(dim, 3 * dim, bias=qkv_bias)
        self.proj = _dense32(dim, dim)
        self.norm2 = LayerNorm5(dim)
        self.fc1 = _dense32(dim, int(dim * mlp_ratio))
        self.fc2 = _dense32(int(dim * mlp_ratio), dim)

    def forward(self, x):
        h = self.norm1(x)
        B, N, C = h.shape
        hd = C // self.num_heads
        qkv = self.qkv(h).reshape(B, N, 3, self.num_heads, hd) \
            .permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, -1)
        a = (attn @ v).transpose(1, 2).reshape(B, N, C)
        x = x + self.proj(a)
        h = self.fc1(self.norm2(x))
        return x + self.fc2(F.gelu(h, approximate="none"))


class ArticulationNetwork(nn.Module):
    def __init__(self, net_type: str, feat_dim: int, posenc_dim: int,
                 num_layers: int, nf: int, n_harmonic_functions: int = 0,
                 embedder_scalar: float = 1.0,
                 activation: Optional[str] = None,
                 enable_articulation_idadd: bool = False):
        super().__init__()
        self.net_type = net_type
        self.n_harmonic_functions = n_harmonic_functions
        self.embedder_scalar = embedder_scalar
        self.activation = activation
        self.idadd = enable_articulation_idadd
        self.num_layers = num_layers
        cin = feat_dim + posenc_dim * (1 + 2 * n_harmonic_functions)
        if net_type == "mlp":
            self.network = MLP(cin, 3, num_layers, nf, activation)
        elif net_type == "attention":
            self.in_linear = _dense32(cin, nf)
            self.in_norm = LayerNorm5(nf)
            for i in range(num_layers):
                setattr(self, f"block_{i}", AttnBlock(nf))
            self.out_linear = _dense32(nf, 3)
        else:
            raise NotImplementedError(net_type)

    def forward(self, x, pos):
        # x: (N, K, feat_dim); pos: (N, K, posenc_dim)
        pos_in = pos
        if self.n_harmonic_functions > 0:
            pos = torch.cat([pos, harmonic_embedding(
                pos, self.n_harmonic_functions, self.embedder_scalar)], -1)
        x = torch.cat([x, pos], -1)
        if self.idadd:
            x = x + pos_in[..., -1:]
        if self.net_type == "mlp":
            return self.network(x)
        h = self.in_norm(F.gelu(self.in_linear(x), approximate="none"))
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h)
        return get_activation(self.activation)(self.out_linear(h))
