"""Image sampling/resizing ops (port of `animals3d_tpu.ops.image`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_bilinear(feat: torch.Tensor,
                         coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with `F.grid_sample(align_corners=False,
    padding_mode='zeros')` semantics, written out as in the JAX package.

    feat: (B, C, H, W); coords: (B, ..., 2) in [-1, 1] (x, y order).
    Returns (B, ..., C).
    """
    B, C, H, W = feat.shape
    lead = coords.shape[1:-1]
    xy = coords.reshape(B, -1, 2).to(feat.dtype)
    x = (xy[..., 0] + 1.0) * (W / 2.0) - 0.5
    y = (xy[..., 1] + 1.0) * (H / 2.0) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0
    flat = feat.reshape(B, C, H * W)

    def gather(ix, iy):
        inb = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        ixc = ix.clamp(0, W - 1).long()
        iyc = iy.clamp(0, H - 1).long()
        idx = (iyc * W + ixc)[:, None, :].expand(B, C, ixc.shape[1])
        v = torch.gather(flat, 2, idx).transpose(1, 2)       # (B, N, C)
        return torch.where(inb[..., None], v, torch.zeros_like(v))

    out = (gather(x0, y0) * ((1 - tx) * (1 - ty))[..., None]
           + gather(x0 + 1, y0) * (tx * (1 - ty))[..., None]
           + gather(x0, y0 + 1) * ((1 - tx) * ty)[..., None]
           + gather(x0 + 1, y0 + 1) * (tx * ty)[..., None])
    return out.reshape(B, *lead, C)


def resize_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize (B, C, H, W) → (B, C, h, w) with half-pixel centres
    and antialiasing on downscale (`jax.image.resize` 'bilinear')."""
    down = size[0] < x.shape[2] or size[1] < x.shape[3]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=down)
