"""DINO ViT-S/8 image encoder returning block-11 attention keys
(port of `animals3d_tpu.networks.vit`).

8×8 patch embed, cls token, learned position embeddings resized to the
input grid by a constant bicubic matrix (torch's a=-0.75 kernel and DINO's
`+0.1` scale-factor quirk), 12 pre-norm blocks (dim 384, 6 heads, MLP
ratio 4, qkv bias), final LayerNorm. Attention is written out as matmul +
float32 softmax, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch.device import cached
from animals3d_tpu_torch.networks.mlp import Dense, lecun_normal_


def _cubic_weights(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """4 cubic-convolution taps at offsets -1..2 around floor(src)."""
    def k1(x):   # |x| <= 1
        return ((a + 2) * x - (a + 3)) * x * x + 1

    def k2(x):   # 1 < |x| < 2
        return ((a * x - 5 * a) * x + 8 * a) * x - 4 * a
    return np.stack([k2(t + 1), k1(t), k1(1 - t), k2(2 - t)], -1)


def torch_bicubic_matrix(in_size: int, out_size: int,
                         scale_factor: float) -> np.ndarray:
    """(out, in) matrix reproducing `F.interpolate(mode='bicubic',
    scale_factor=sf, align_corners=False)` with edge-clamped taps."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale_factor - 0.5
    x0 = np.floor(src).astype(np.int64)
    w = _cubic_weights(src - x0)
    mat = np.zeros((out_size, in_size), np.float64)
    for k in range(4):
        idx = np.clip(x0 - 1 + k, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), w[:, k])
    return mat.astype(np.float32)


class LayerNorm(nn.LayerNorm):
    """flax-named LayerNorm (`scale` ↔ weight) computing in float32."""

    def init_weights(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return super().forward(x.float())


class ViTSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, init="lecun")
        self.proj = Dense(dim, dim, init="lecun")

    def forward(self, x, return_qkv: bool = False):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q @ k.transpose(-1, -2)) * hd ** -0.5
        # softmax in float32 (torch autocast keeps softmax float32)
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, C)
        out = self.proj(out)
        if return_qkv:
            return out, (q.float(), k.float(), v.float())
        return out


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = ViTSelfAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.fc1 = Dense(dim, int(dim * mlp_ratio), init="lecun")
        self.fc2 = Dense(int(dim * mlp_ratio), dim, init="lecun")

    def forward(self, x, return_qkv: bool = False):
        h = self.norm1(x)
        if return_qkv:
            a, qkv = self.attn(h, return_qkv=True)
        else:
            a, qkv = self.attn(h), None
        x = x + a.float()
        h = self.fc1(self.norm2(x))
        h = self.fc2(F.gelu(h, approximate="none"))
        x = x + h.float()
        return (x, qkv) if return_qkv else x


class PatchEmbed(nn.Conv2d):
    """Patch-embedding conv (flax `nn.Conv` with no dtype: float32)."""

    def init_weights(self, gen):
        fan_in = self.in_channels * self.kernel_size[0] * self.kernel_size[1]
        lecun_normal_(self.weight, fan_in, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return super().forward(x.float())


class DinoViT(nn.Module):
    """forward(x) → (tokens (B, N+1, C) after the final norm,
    key11 (B, heads, N+1, head_dim) of block `key_block`)."""

    def __init__(self, patch_size: int = 8, dim: int = 384, depth: int = 12,
                 num_heads: int = 6, mlp_ratio: float = 4.0,
                 pos_grid: int = 28, key_block: int = 11):
        super().__init__()
        self.patch_size = patch_size
        self.dim = dim
        self.depth = depth
        self.pos_grid = pos_grid
        self.key_block = key_block
        self.patch_embed = PatchEmbed(3, dim, patch_size, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid * pos_grid + 1,
                                                  dim))
        for i in range(depth):
            setattr(self, f"block_{i}", ViTBlock(dim, num_heads, mlp_ratio))
        self.norm = LayerNorm(dim, eps=1e-6)

    def init_weights(self, gen):
        with torch.no_grad():
            self.cls_token.normal_(0.0, 0.02, generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)

    def _pos(self, gh: int, gw: int):
        pos = self.pos_embed
        if (gh, gw) == (self.pos_grid, self.pos_grid):
            return pos
        g = self.pos_grid
        patch_pos = pos[0, 1:].reshape(g, g, self.dim)
        # DINO quirk: the width grid drives the height scale factor
        wh = cached(("vit_bicubic", g, gh, gw), pos.device,
                    lambda: torch.as_tensor(
                        torch_bicubic_matrix(g, gh, (gw + 0.1) / g)))
        ww = cached(("vit_bicubic", g, gw, gh), pos.device,
                    lambda: torch.as_tensor(
                        torch_bicubic_matrix(g, gw, (gh + 0.1) / g)))
        patch_pos = torch.einsum("oi,ijd->ojd", wh, patch_pos)
        patch_pos = torch.einsum("pj,ojd->opd", ww, patch_pos)
        return torch.cat([pos[:, :1], patch_pos.reshape(1, gh * gw,
                                                        self.dim)], 1)

    def forward(self, x):          # x: (B, 3, H, W)
        B, _, H, W = x.shape
        gh, gw = H // self.patch_size, W // self.patch_size
        x = self.patch_embed(x).flatten(2).transpose(1, 2)   # (B, gh·gw, C)
        x = torch.cat([self.cls_token.expand(B, 1, self.dim), x], 1)
        x = x + self._pos(gh, gw)
        key11 = None
        for i in range(self.depth):
            blk = getattr(self, f"block_{i}")
            if i == self.key_block:
                x, (_q, k, _v) = blk(x, return_qkv=True)
                key11 = k
            else:
                x = blk(x)
        return self.norm(x), key11



IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] → ImageNet-normalized."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype,
                        device=images.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype,
                       device=images.device).reshape(1, 3, 1, 1)
    return (images - mean) / std
