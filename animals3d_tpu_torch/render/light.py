"""Light models (port of `animals3d_tpu.render.light`).

The training path uses `DirectionalLight`: an MLP predicts a light
direction in the upper hemisphere plus ambient and diffuse intensities;
the Visualizer relights with a fixed one (`fixed_direction_light`). The
pbr path's environment light is split-sum shading from a cubemap
(`environment_shade`): the deepest mip's cosine-convolved irradiance for
diffuse (one matmul over texels), a GGX-prefiltered mip chain for
specular (fixed-pattern importance sampling), and the Karis FG lookup
table, integrated on the host (`_fg_lut_np`).
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from animals3d_tpu_torch.device import constant
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
            mm = constant(self.intensity_min_max, out.device, out.dtype)
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


# ---------------------------------------------------------------------------
# Environment (split-sum) lighting — the pbr path
# ---------------------------------------------------------------------------

LIGHT_MIN_RES = 16
MIN_ROUGHNESS = 0.08
MAX_ROUGHNESS = 0.5


def cube_texel_dirs(res: int) -> np.ndarray:
    """(6, res, res, 3) unit direction of each texel, GL face order
    (+x, -x, +y, -y, +z, -z)."""
    fx = 2.0 * ((np.arange(res) + 0.5) / res) - 1.0
    gx, gy = np.meshgrid(fx, fx, indexing="xy")        # gy indexes rows
    one = np.ones_like(gx)
    faces = [
        np.stack([one, -gy, -gx], -1), np.stack([-one, -gy, gx], -1),
        np.stack([gx, one, gy], -1), np.stack([gx, -one, -gy], -1),
        np.stack([gx, -gy, one], -1), np.stack([-gx, -gy, -one], -1),
    ]
    d = np.stack(faces, 0).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def cube_texel_areas(res: int) -> np.ndarray:
    """(res, res) solid angle of each texel of a face."""
    if res == 1:
        return np.ones((1, 1), np.float32)
    h = res // 2
    x = np.abs(np.arange(res) - h)
    da = np.arctan((x + 1) / h) - np.arctan(x / h)
    return (da[None, :] * da[:, None]).astype(np.float32)


def cubemap_mip_chain(base, min_res: int = LIGHT_MIN_RES) -> list:
    """Mips of a (6, R, R, 3) cubemap by 2×2 average pooling of each face,
    down to `min_res`."""
    mips = [base]
    while mips[-1].shape[1] > min_res:
        m = mips[-1]
        mips.append(m.reshape(6, m.shape[1] // 2, 2, m.shape[2] // 2, 2, 3)
                    .mean((2, 4)))
    return mips


def diffuse_cubemap(cubemap):
    """Cosine-convolved irradiance cubemap as one matmul:
    out[p] = Σ_t L[t] · clamp(n_p·d_t, 0, 0.999) · ω_t / π."""
    res = cubemap.shape[1]
    dirs = cube_texel_dirs(res).reshape(-1, 3)
    area = np.broadcast_to(cube_texel_areas(res), (6, res, res)).reshape(-1)
    w = np.clip(dirs @ dirs.T, 0.0, 0.999) * (area[None, :] / np.pi)
    w = torch.as_tensor(w, dtype=cubemap.dtype, device=cubemap.device)
    return (w @ cubemap.reshape(-1, 3)).reshape(6, res, res, 3)


def _hammersley(n: int) -> np.ndarray:
    """(n, 2) Hammersley points in [0, 1)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    return np.stack([i / n, bits / 2**32], -1)


def specular_prefilter(cubemap, roughness: float, num_samples: int = 64):
    """GGX-prefiltered cubemap (n = v = r) by fixed-pattern importance
    sampling: per texel direction n, L_out = Σ_s L(l_s)·(n·l_s) /
    Σ_s (n·l_s), with l_s the reflections of GGX half-vector samples."""
    res = cubemap.shape[1]
    if roughness <= 1e-4:
        return cubemap
    dt, dev = cubemap.dtype, cubemap.device
    alpha = roughness * roughness
    uv = _hammersley(num_samples)
    phi = 2.0 * np.pi * uv[:, 0]
    ct = np.sqrt((1.0 - uv[:, 1]) / (1.0 + (alpha * alpha - 1.0) * uv[:, 1]))
    st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
    h_t = np.stack([st * np.cos(phi), st * np.sin(phi), ct], -1)
    h_t = torch.as_tensor(h_t.astype(np.float32), dtype=dt, device=dev)
    n = torch.as_tensor(cube_texel_dirs(res), dtype=dt,
                        device=dev).reshape(-1, 3)
    up = torch.where(n[:, 2:3].abs() < 0.9,
                     torch.tensor([[0.0, 0.0, 1.0]], dtype=dt, device=dev),
                     torch.tensor([[1.0, 0.0, 0.0]], dtype=dt, device=dev))
    tx = shading.safe_normalize(torch.linalg.cross(up, n))
    ty = torch.linalg.cross(n, tx)
    h = (h_t[None, :, 0:1] * tx[:, None] + h_t[None, :, 1:2] * ty[:, None]
         + h_t[None, :, 2:3] * n[:, None])              # (P, S, 3)
    l = 2.0 * (n[:, None] * h).sum(-1, keepdim=True) * h - n[:, None]
    w = torch.clamp((n[:, None] * l).sum(-1), min=0.0)  # (P, S)
    col = sample_cubemap(cubemap, l)
    out = (col * w[..., None]).sum(1) / torch.clamp(
        w.sum(1, keepdim=True), min=1e-8)
    return out.reshape(6, res, res, 3)


def build_env_mips(base_cubemap, num_samples: int = 64):
    """Average-pool chain, each level GGX-prefiltered at its mapped
    roughness (the last at 1); the deepest level cosine-convolved for
    diffuse. Returns (specular mips, diffuse)."""
    chain = cubemap_mip_chain(base_cubemap)
    diffuse = diffuse_cubemap(chain[-1])
    n = len(chain)
    spec = []
    for idx, m in enumerate(chain):
        if idx < n - 1:
            r = (idx / max(n - 2, 1)) * (MAX_ROUGHNESS - MIN_ROUGHNESS) \
                + MIN_ROUGHNESS
        else:
            r = 1.0
        spec.append(specular_prefilter(m, r, num_samples))
    return spec, diffuse


def get_mip(roughness, n_mips: int):
    """Roughness → fractional mip level (two linear segments)."""
    lo = (roughness.clamp(MIN_ROUGHNESS, MAX_ROUGHNESS) - MIN_ROUGHNESS) \
        / (MAX_ROUGHNESS - MIN_ROUGHNESS) * (n_mips - 2)
    hi = (roughness.clamp(MAX_ROUGHNESS, 1.0) - MAX_ROUGHNESS) \
        / (1.0 - MAX_ROUGHNESS) + n_mips - 2
    return torch.where(roughness < MAX_ROUGHNESS, lo, hi)


@functools.lru_cache(maxsize=2)
def _fg_lut_np(res: int = 64, num_samples: int = 256) -> np.ndarray:
    """Karis split-sum FG table over (n·v rows, roughness columns),
    integrated on the host: Smith-GGX visibility with k = α²/2, clipped
    to [0, 1]. (res, res, 2) float32."""
    uv = _hammersley(num_samples)
    ndv = np.linspace(1e-2, 1.0, res)[:, None]
    rough = np.linspace(1e-2, 1.0, res)[None, :]
    A = np.zeros((res, res))
    B = np.zeros((res, res))
    v = np.stack([np.sqrt(1 - ndv**2), np.zeros_like(ndv), ndv], -1)
    for u1, u2 in uv:
        a = rough * rough
        phi = 2.0 * np.pi * u1
        ct = np.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
        st = np.sqrt(np.maximum(1.0 - ct * ct, 0.0))
        h = np.stack([np.broadcast_to(st * np.cos(phi), ndv.shape[:1] + (res,)),
                      np.broadcast_to(st * np.sin(phi), ndv.shape[:1] + (res,)),
                      np.broadcast_to(ct, ndv.shape[:1] + (res,))], -1)
        vdh = np.sum(v * h, -1)
        l = 2.0 * vdh[..., None] * h - v
        ndl = l[..., 2]
        ndh = h[..., 2]
        mask = ndl > 0
        k = a * a / 2.0
        g = (ndl / (ndl * (1 - k) + k)) * (ndv / (ndv * (1 - k) + k))
        g_vis = np.where(mask, g * np.maximum(vdh, 0.0)
                         / np.maximum(ndh * ndv, 1e-8), 0.0)
        fc = (1.0 - np.clip(vdh, 0.0, 1.0)) ** 5
        A += (1.0 - fc) * g_vis
        B += fc * g_vis
    lut = np.stack([A, B], -1) / num_samples
    return np.clip(lut, 0.0, 1.0).astype(np.float32)


def sample_fg_lut(ndotv, roughness):
    """Bilinear FG table lookup at (..., 1) n·v and roughness → (..., 2)."""
    lut = torch.as_tensor(_fg_lut_np(), dtype=ndotv.dtype,
                          device=ndotv.device)
    res = lut.shape[0]

    def bil(coord):
        c = coord.clamp(0.0, 1.0) * (res - 1)
        i0 = torch.floor(c).long().clamp(0, res - 1)
        i1 = (i0 + 1).clamp(max=res - 1)
        return i0, i1, c - i0
    r0, r1, rf = bil(ndotv[..., 0])
    c0, c1, cf = bil(roughness[..., 0])
    rf, cf = rf[..., None], cf[..., None]
    return (lut[r0, c0] * (1 - rf) * (1 - cf) + lut[r1, c0] * rf * (1 - cf)
            + lut[r0, c1] * (1 - rf) * cf + lut[r1, c1] * rf * cf)


def _cube_face_st(directions):
    """Face id and in-face (s, t) in [0, 1] per GL cubemap conventions;
    ties at cube edges go to x, then y, then z."""
    d = shading.safe_normalize(directions)
    ax, ay, az = d[..., 0].abs(), d[..., 1].abs(), d[..., 2].abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    pos_x, pos_y, pos_z = d[..., 0] > 0, d[..., 1] > 0, d[..., 2] > 0
    face = torch.where(is_x, torch.where(pos_x, 0, 1),
                       torch.where(is_y, torch.where(pos_y, 2, 3),
                                   torch.where(pos_z, 4, 5)))
    major = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-9)
    s = torch.where(is_x, torch.where(pos_x, -d[..., 2], d[..., 2]),
                    torch.where(is_y, d[..., 0],
                                torch.where(pos_z, d[..., 0], -d[..., 0])))
    t = torch.where(is_y, torch.where(pos_y, d[..., 2], -d[..., 2]),
                    -d[..., 1])
    return face, (s / major + 1) * 0.5, (t / major + 1) * 0.5


def sample_cubemap(cubemap, directions):
    """Bilinear within-face (clamped) cubemap lookup:
    (6, R, R, 3) × (..., 3) → (..., 3)."""
    face, s, t = _cube_face_st(directions)
    res = cubemap.shape[1]
    u = s * res - 0.5
    v = t * res - 0.5
    u0 = torch.floor(u).long().clamp(0, res - 1)
    v0 = torch.floor(v).long().clamp(0, res - 1)
    u1 = (u0 + 1).clamp(max=res - 1)
    v1 = (v0 + 1).clamp(max=res - 1)
    uf = (u - u0).clamp(0.0, 1.0)[..., None]
    vf = (v - v0).clamp(0.0, 1.0)[..., None]
    c00 = cubemap[face, v0, u0]
    c01 = cubemap[face, v0, u1]
    c10 = cubemap[face, v1, u0]
    c11 = cubemap[face, v1, u1]
    return ((c00 * (1 - uf) + c01 * uf) * (1 - vf)
            + (c10 * (1 - uf) + c11 * uf) * vf)


def environment_shade(base_cubemap, pos, nrm, kd, ks, view_pos,
                      specular: bool = True, num_samples: int = 64):
    """Split-sum environment shading: diffuse irradiance × diffuse colour,
    plus (with `specular`) the prefiltered chain sampled at the roughness'
    fractional mip, linear between levels, times the FG reflectance; all
    × (1 − ks.x), the hemisphere visibility."""
    spec_mips, diffuse_env = build_env_mips(base_cubemap, num_samples)
    wo = shading.safe_normalize(view_pos - pos)
    roughness = ks[..., 1:2]
    metallic = ks[..., 2:3]
    if specular:
        spec_col = (1.0 - metallic) * 0.04 + kd * metallic
        diff_col = kd * (1.0 - metallic)
    else:
        diff_col = kd
    out = sample_cubemap(diffuse_env, nrm) * diff_col
    if specular:
        refl = shading.safe_normalize(shading.reflect(wo, nrm))
        n_mips = len(spec_mips)
        level = get_mip(roughness[..., 0], n_mips).clamp(0, n_mips - 1)
        lo = torch.floor(level).long().clamp(0, n_mips - 1)
        frac = (level - lo)[..., None]
        samples = torch.stack([sample_cubemap(m, refl) for m in spec_mips],
                              -1)                          # (..., 3, M)
        pick = lambda i: torch.gather(
            samples, -1, i[..., None, None].expand(*samples.shape[:-1], 1)
        )[..., 0]
        spec = pick(lo) * (1 - frac) \
            + pick((lo + 1).clamp(max=n_mips - 1)) * frac
        ndotv = torch.clamp(shading.dot(wo, nrm), min=1e-4)
        fg = sample_fg_lut(ndotv, roughness)
        reflectance = spec_col * fg[..., 0:1] + fg[..., 1:2]
        out = out + spec * reflectance
    return out * (1.0 - ks[..., 0:1])
