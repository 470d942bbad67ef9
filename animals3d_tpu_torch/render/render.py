"""Deferred-shading mesh renderer (port of `render_mesh` of
`animals3d_tpu.render.render`, for the modes the MagicPony forward asks
for — `shaded` and `dino_pred` — at spp = 1).

Rasterize with a tile kernel (`ops.rasterize_cuda`, `raster_variant` 3, 4
or 6; its plain version on the CPU), resolve barycentrics and interpolated
attributes with one row per pixel (`resolve_rows` "gather" or "kernel",
see `ops.rasterize.resolve`), shade with the texture MLP and a directional light,
composite over the background and antialias silhouettes. Textures and
DINO features are sampled at canonical (prior-mesh) positions, so
appearance is pose-invariant. `shaded` keeps RGBA: its alpha is the
antialiased mask. Flow, tangent, depth, environment light and
supersampling are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from animals3d_tpu_torch.geometry.mesh import Mesh, take_rows
from animals3d_tpu_torch.ops import shading as sh
from animals3d_tpu_torch.ops.antialias import antialias
from animals3d_tpu_torch.ops.rasterize import resolve
from animals3d_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from animals3d_tpu_torch.render.camera import xfm_points
from animals3d_tpu_torch.render.light import directional_shade

_ANTIALIAS_MODES = ("shaded", "dino_pred")
_SUPPORTED_MODES = ("shaded", "dino_pred")


def render_mesh(mesh: Mesh, mtx_in, w2c, campos, resolution,
                material_fn: Optional[Callable] = None,
                light_params=None, background=None, spp: int = 1,
                render_modes: Sequence[str] = ("shaded",),
                prior_mesh: Optional[Mesh] = None,
                dino_fn: Optional[Callable] = None,
                two_sided_shading: bool = True, raster_variant: int = 3,
                resolve_rows: str = "gather") -> dict:
    """mtx_in (B, 4, 4) mvp; w2c (B, 4, 4); campos (B, 3); background
    (B, H, W, 3) or None. `raster_variant` and `resolve_rows` select the
    visibility kernel and the resolve path (the JAX package's
    `A3D_RASTER_V` and `A3D_MXU_FWD`); the defaults are its defaults.
    Returns mode → (B, C, H, W)."""
    if spp != 1:
        raise NotImplementedError("supersampling (spp > 1) is not ported")
    for key in render_modes:
        if key not in _SUPPORTED_MODES:
            raise NotImplementedError(f"render mode {key!r}")
    H, W = resolution
    B = mtx_in.shape[0]
    if mesh.v_pos.shape[0] == 1 and B > 1:
        mesh = mesh.extend(B)
    faces = mesh.t_pos_idx
    v_clip = xfm_points(mesh.v_pos, mtx_in)                   # (B, V, 4)
    rast = rasterize_cuda(v_clip, faces, mesh.f_valid, (H, W),
                          v_pos0=mesh.v_pos[0], variant=raster_variant)
    mask = rast.mask[..., None].to(v_clip.dtype)

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
    gb_geo_normal = gb_geo_normal * mask

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
        shaded_col, _ = directional_shade(light_params, kd, cam_normal)
    else:
        shaded_col = kd
    buffers = {"shaded": shaded_col}
    if dino_pred is not None:
        buffers["dino_pred"] = dino_pred

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
    aa_keys = [k for k in accums if k in _ANTIALIAS_MODES]
    if aa_keys:
        packed = antialias(torch.cat([accums[k] for k in aa_keys], -1), rast,
                           v_clip, faces)
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
        if key == "dino_pred":
            accum = accum[..., :-1]
        out[key] = accum.permute(0, 3, 1, 2)
    return out
