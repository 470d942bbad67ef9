"""2-D textures with mip chains and bilinear / trilinear sampling, and
latlong <-> cubemap conversion (port of `animals3d_tpu.render.texture`).

Used for OBJ/MTL materials, export and the environment light; the training
material is the texture MLP. Mips are 2×2 average pools; sampling is
bilinear with clamped edges and a level-of-detail blend.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def build_mips(tex, min_res: int = 1) -> list:
    """(H, W, C) → list of mips down to `min_res` (2×2 average pooling)."""
    mips = [tex]
    while min(mips[-1].shape[:2]) > min_res:
        t = mips[-1]
        h, w, c = t.shape
        t = t[: h - h % 2, : w - w % 2]
        mips.append(t.reshape(h // 2, 2, w // 2, 2, c).mean((1, 3)))
    return mips


def sample_bilinear(tex, uv):
    """tex (H, W, C), uv (..., 2) in [0, 1] → (..., C); clamped edges."""
    H, W, _C = tex.shape
    x = uv[..., 0] * W - 0.5
    y = uv[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    tx = x - x0
    ty = y - y0

    def at(ix, iy):
        ix = ix.long().clamp(0, W - 1)
        iy = iy.long().clamp(0, H - 1)
        return tex[iy, ix]

    return (at(x0, y0) * ((1 - tx) * (1 - ty))[..., None]
            + at(x0 + 1, y0) * (tx * (1 - ty))[..., None]
            + at(x0, y0 + 1) * ((1 - tx) * ty)[..., None]
            + at(x0 + 1, y0 + 1) * (tx * ty)[..., None])


def _resize_nearest(m, shape):
    """Nearest resize of (h, w, C) to `shape` (H, W, C) with half-pixel
    centres (the JAX package's `jax.image.resize(..., "nearest")`)."""
    H, W = shape[:2]
    h, w = m.shape[:2]
    dev = m.device
    iy = torch.floor((torch.arange(H, device=dev) + 0.5) * (h / H)).long()
    ix = torch.floor((torch.arange(W, device=dev) + 0.5) * (w / W)).long()
    return m[iy.clamp(max=h - 1)][:, ix.clamp(max=w - 1)]


def sample_texture(tex, uv, lod=None):
    """Mipmapped sampling: `lod` (scalar or per sample) blends adjacent
    mips; None samples the base level only."""
    if lod is None:
        return sample_bilinear(tex, uv)
    mips = build_mips(tex)
    n = len(mips)
    lod = torch.as_tensor(lod, dtype=torch.float32,
                          device=tex.device).clamp(0.0, n - 1.0)
    lo = torch.floor(lod).long()
    frac = lod - lo
    samples = torch.stack([sample_bilinear(
        m if m.shape == mips[0].shape else _resize_nearest(m, mips[0].shape),
        uv) for m in mips], 0)
    a = samples[lo.clamp(0, n - 1)]
    b = samples[(lo + 1).clamp(0, n - 1)]
    return a + (b - a) * frac


def checkerboard(res, checker_size: int = 8) -> np.ndarray:
    """(H, W, 3) float32 checkerboard of 0.25 / 0.75."""
    H, W = res
    ys = (np.arange(H) // checker_size)[:, None]
    xs = (np.arange(W) // checker_size)[None, :]
    c = ((ys + xs) % 2).astype(np.float32) * 0.5 + 0.25
    return np.repeat(c[:, :, None], 3, 2)


def latlong_to_cubemap(latlong, res: int):
    """(H, W, 3) equirectangular → (6, res, res, 3) cubemap, GL face order
    (+x, -x, +y, -y, +z, -z)."""
    dev = latlong.device
    g = (torch.arange(res, device=dev, dtype=latlong.dtype) + 0.5) \
        / res * 2 - 1
    a, b = torch.meshgrid(g, g, indexing="xy")
    one = torch.ones_like(a)
    dirs = [torch.stack([one, -b, -a], -1), torch.stack([-one, -b, a], -1),
            torch.stack([a, one, b], -1), torch.stack([a, -one, -b], -1),
            torch.stack([a, -b, one], -1), torch.stack([-a, -b, -one], -1)]
    faces = []
    for d in dirs:
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        theta = torch.arccos(d[..., 1].clamp(-1, 1))          # [0, pi]
        phi = torch.atan2(d[..., 0], -d[..., 2])              # [-pi, pi]
        uv = torch.stack([torch.remainder(phi / (2 * math.pi), 1.0),
                          theta / math.pi], -1)
        faces.append(sample_bilinear(latlong, uv))
    return torch.stack(faces)


def cubemap_to_latlong(cubemap, res):
    """(6, R, R, 3) → (H, W, 3) equirectangular; u = phi / 2π with
    phi = atan2(x, -z), the zero of `latlong_to_cubemap`."""
    from animals3d_tpu_torch.render.light import sample_cubemap
    H, W = res
    dev = cubemap.device
    theta = (torch.arange(H, device=dev, dtype=cubemap.dtype) + 0.5) \
        / H * math.pi
    phi = (torch.arange(W, device=dev, dtype=cubemap.dtype) + 0.5) \
        / W * 2 * math.pi
    t, p = torch.meshgrid(theta, phi, indexing="ij")
    d = torch.stack([torch.sin(t) * torch.sin(p), torch.cos(t),
                     -torch.sin(t) * torch.cos(p)], -1)
    return sample_cubemap(cubemap, d)
