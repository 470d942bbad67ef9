"""Deferred-shading mesh renderer (port of `render_mesh` of
`animals3d_tpu.render.render`).

Rasterize with the plain version of the default tile kernel
(`ops.rasterize_cuda`), resolve barycentrics and interpolated attributes
with one row per pixel (`resolve_rows` "gather" or "kernel", see
`ops.rasterize.resolve`), shade with the texture MLP and a directional
light, composite over the background and antialias silhouettes. Textures
and DINO features are sampled at canonical (prior-mesh) positions, so
appearance is pose-invariant. The modes are those the benchmark's cells
render: `shaded` (RGBA: its alpha is the antialiased mask) and
`dino_pred`. The port's other modes, its environment light and its
other tile kernels are left out of this copy.

Supersampling (`spp` > 1) rasterizes at (H·spp, W·spp) and shades at the
base resolution on the nearest-subsampled rast (the JAX package's
`msaa=True`, its only form in use); the buffers are nearest-upsampled
back, and compositing, antialiasing and the final average pooling run at
full resolution: visibility is supersampled, shading is not.

Lighting: `light_params`, the (B, 5) directional light on the
camera-space normals; without it, `shaded` is kd.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from refmodel.geometry.mesh import Mesh, take_rows
from refmodel.ops import shading as sh
from refmodel.ops.antialias import antialias
from refmodel.ops.rasterize import Rast, resolve
from refmodel.ops.rasterize_cuda import rasterize_cuda
from refmodel.render.camera import xfm_points
from refmodel.render.light import directional_shade

_SUPPORTED_MODES = ("shaded", "dino_pred")


def avg_pool_nhwc(x, k: int):
    b, h, w, c = x.shape
    return x.reshape(b, h // k, k, w // k, k, c).mean((2, 4))


def _upsample(x, k: int):
    """Nearest upsampling of (B, H, W, C) by k on both axes."""
    return x.repeat_interleave(k, 1).repeat_interleave(k, 2)


def render_mesh(mesh: Mesh, mtx_in, w2c, campos, resolution,
                material_fn: Optional[Callable] = None,
                light_params=None, background=None,
                spp: int = 1,
                render_modes: Sequence[str] = ("shaded",),
                prior_mesh: Optional[Mesh] = None,
                dino_fn: Optional[Callable] = None,
                two_sided_shading: bool = True,
                resolve_rows: str = "gather") -> dict:
    """mtx_in (B, 4, 4) mvp; w2c (B, 4, 4); campos (B, 3); background
    (B, H, W, 3) or None. `resolve_rows` selects the resolve path.
    Returns mode → (B, C, H, W)."""
    for key in render_modes:
        if key not in _SUPPORTED_MODES:
            raise NotImplementedError(f"render mode {key!r}")
    H, W = resolution
    B = mtx_in.shape[0]
    if mesh.v_pos.shape[0] == 1 and B > 1:
        mesh = mesh.extend(B)
    faces = mesh.t_pos_idx
    v_clip = xfm_points(mesh.v_pos, mtx_in)                   # (B, V, 4)
    rast = rasterize_cuda(v_clip, faces, mesh.f_valid, (H * spp, W * spp),
                          v_pos0=mesh.v_pos[0])
    mask = rast.mask[..., None].to(v_clip.dtype)
    # MSAA: shade at the base resolution on the nearest-subsampled rast;
    # visibility, compositing and antialiasing stay at full resolution
    rast_full, mask_base = rast, mask
    if spp > 1:
        rast = Rast(uv=None, z=rast.z[:, ::spp, ::spp].contiguous(),
                    face_id=rast.face_id[:, ::spp, ::spp].contiguous())
        mask_base = mask[:, ::spp, ::spp]

    # ---- interpolated attribute buffers ----
    prior = prior_mesh if prior_mesh is not None else mesh
    v_tex = prior.v_pos.expand(B, *prior.v_pos.shape[1:])
    chans = [mesh.v_pos, mesh.v_nrm, v_tex]
    # face normals of the posed mesh ride in resolve's per-face row
    fp = take_rows(mesh.v_pos, faces, 1)                       # (B, F, 3, 3)
    u = fp[:, :, 1] - fp[:, :, 0]
    w_ = fp[:, :, 2] - fp[:, :, 0]
    nx = u[..., 1] * w_[..., 2] - u[..., 2] * w_[..., 1]
    ny = u[..., 2] * w_[..., 0] - u[..., 0] * w_[..., 2]
    nz = u[..., 0] * w_[..., 1] - u[..., 1] * w_[..., 0]
    inv = torch.rsqrt(nx * nx + ny * ny + nz * nz + 1e-20)
    inv = torch.where(mesh.f_valid[None], inv, torch.zeros_like(inv))
    fn = torch.stack([nx * inv, ny * inv, nz * inv], -1)
    _uv, fused, gb_geo_normal = resolve(torch.cat(chans, -1), rast, v_clip,
                                        faces, face_attr=fn,
                                        rows=resolve_rows)
    gb_pos = fused[..., 0:3]
    gb_normal = fused[..., 3:6]
    gb_tex_pos = fused[..., 6:9]
    gb_geo_normal = gb_geo_normal * mask_base

    # ---- shading ----
    if material_fn is not None:
        all_tex = material_fn(gb_tex_pos)
    else:
        all_tex = torch.tensor([1, 1, 1, 0, 1, 0, 1, 1, 1],
                               dtype=gb_pos.dtype,
                               device=gb_pos.device).expand(
                                   *gb_pos.shape[:-1], 9)
    kd = all_tex[..., :3]
    dino_pred = dino_fn(gb_tex_pos) if dino_fn is not None else None
    view_pos = campos[:, None, None, :]
    gb_shading_normal = sh.prepare_shading_normal(
        gb_pos, view_pos, gb_normal, gb_geo_normal,
        two_sided_shading=two_sided_shading)
    cam_normal = sh.safe_normalize(
        torch.einsum("bij,bhwj->bhwi", w2c[:, :3, :3], gb_shading_normal))
    if light_params is not None:
        shaded_col, _shading = directional_shade(light_params, kd,
                                                 cam_normal)
    else:
        shaded_col = kd
    buffers = {"shaded": shaded_col}
    if dino_pred is not None:
        buffers["dino_pred"] = dino_pred
    buffers = {k: v for k, v in buffers.items() if k in render_modes}
    if spp > 1:
        buffers = {k: _upsample(v, spp) for k, v in buffers.items()}
        if background is not None:
            background = _upsample(background, spp)

    # ---- composite over the background, then antialias in one pass ----
    accums = {}
    for key in render_modes:
        if key not in buffers:
            continue
        buf = buffers[key]
        if background is not None and key == "shaded":
            bg = torch.cat([background, torch.zeros_like(background[..., :1])],
                           -1)
        else:
            bg = buf.new_zeros((*buf.shape[:-1], buf.shape[-1] + 1))
        fg = torch.cat([buf, torch.ones_like(buf[..., :1])], -1)
        accums[key] = bg + (fg - bg) * mask
    aa_keys = list(accums)
    if aa_keys:
        packed = antialias(torch.cat([accums[k] for k in aa_keys], -1),
                           rast_full, v_clip, faces)
        off = 0
        for k in aa_keys:
            c = accums[k].shape[-1]
            accums[k] = packed[..., off:off + c]
            off += c

    out = {}
    for key in render_modes:
        if key not in accums:
            out[key] = None
            continue
        accum = accums[key]
        if spp > 1:
            accum = avg_pool_nhwc(accum, spp)
        if key == "dino_pred":
            accum = accum[..., :-1]
        out[key] = accum.permute(0, 3, 1, 2)
    return out
