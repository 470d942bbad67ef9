"""Analytic silhouette antialiasing — the mask-gradient path
(port of the compacted `antialias` of `animals3d_tpu.ops.antialias`).

A horizontal or vertical pixel pair is a silhouette crossing iff the ids
differ and one side is background or the depth gap exceeds `z_tol`. The
inside pixel's triangle edge functions, evaluated at both pixel centres,
give where the edge crosses the segment (t in (0, 1)); t > 1/2 blends the
outside pixel toward the inside colour by t − 1/2, t ≤ 1/2 the inside
pixel toward the outside colour by 1/2 − t (nvdiffrast's rule). Pairs are
prefix-compacted into `pair_cap` slots per image (overflow pairs, in
raster order, are dropped) and their blended deltas scattered with
`index_add_`. Differentiable in `color` and `v_clip`.
"""
from __future__ import annotations

import torch

from animals3d_tpu_torch.geometry.mesh import take_rows
from animals3d_tpu_torch.ops.dmtet import first_geq
from animals3d_tpu_torch.ops.rasterize import Rast


def default_pair_cap(height: int, width: int) -> int:
    """~16 silhouette pairs per image row, rounded up to a multiple of 128."""
    cap = 16 * max(height, width)
    return -(-cap // 128) * 128


def _pair_valid(fid_p, fid_q, z_p, z_q, z_tol):
    differs = fid_p != fid_q
    any_bg = (fid_p == 0) | (fid_q == 0)
    both_bg = (fid_p == 0) & (fid_q == 0)
    depth_gap = (z_p - z_q).abs() > z_tol
    return differs & (any_bg | depth_gap) & ~both_bg


def _pair_blend(inside_is_first, e_in_p, e_in_q, valid):
    """(w_to_first, w_to_second): how much of the other pixel's colour flows
    into each pixel of the pair."""
    e_in = torch.where(inside_is_first[..., None], e_in_p, e_in_q)
    e_out = torch.where(inside_is_first[..., None], e_in_q, e_in_p)
    crossing = e_out < 0
    denom = e_in - e_out
    t_i = e_in / torch.where(denom.abs() > 1e-12, denom,
                             torch.full_like(denom, 1e-12))
    t_i = torch.where(crossing, t_i, torch.full_like(t_i, float("inf")))
    t = t_i.amin(-1)
    has_crossing = torch.isfinite(t) & valid
    t = torch.clamp(torch.where(has_crossing, t, torch.full_like(t, 0.5)),
                    0.0, 1.0)
    zero = torch.zeros_like(t)
    w_outside = torch.where(has_crossing, torch.clamp(t - 0.5, min=0.0), zero)
    w_inside = torch.where(has_crossing, torch.clamp(0.5 - t, min=0.0), zero)
    return (torch.where(inside_is_first, w_inside, w_outside),
            torch.where(inside_is_first, w_outside, w_inside))


def antialias(color, rast: Rast, v_clip, faces, z_tol: float = 2e-3,
              pair_cap: int | None = None):
    """Antialias `color` (B, H, W, C) at silhouettes."""
    B, H, W, C = color.shape
    K = pair_cap if pair_cap is not None else default_pair_cap(H, W)
    n_pix = H * W
    dev = color.device
    fid = rast.face_id.detach()
    z = torch.where(fid > 0, rast.z.detach(),
                    torch.full_like(rast.z, float("inf")))
    fid_f = fid.reshape(B, n_pix)
    z_f = z.reshape(B, n_pix)

    vh = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    vh[..., :-1] = _pair_valid(fid[..., :-1], fid[..., 1:], z[..., :-1],
                               z[..., 1:], z_tol)
    vv = torch.zeros((B, H, W), dtype=torch.bool, device=dev)
    vv[:, :-1] = _pair_valid(fid[:, :-1], fid[:, 1:], z[:, :-1], z[:, 1:],
                             z_tol)
    valid = torch.cat([vh.reshape(B, n_pix), vv.reshape(B, n_pix)], -1)

    csum = torch.cumsum(valid.to(torch.int64), -1)
    targets = torch.arange(1, K + 1, device=dev)
    pair_idx = first_geq(csum, targets.expand(B, K))
    slot_ok = targets[None, :] <= csum[:, -1:]
    pair_idx = torch.where(slot_ok, pair_idx, torch.zeros_like(pair_idx))
    is_vert = pair_idx >= n_pix
    p_lin = torch.where(is_vert, pair_idx - n_pix, pair_idx)
    q_lin = torch.clamp(p_lin + torch.where(is_vert, W, 1), max=n_pix - 1)

    fid_p, fid_q = fid_f.gather(1, p_lin), fid_f.gather(1, q_lin)
    z_p, z_q = z_f.gather(1, p_lin), z_f.gather(1, q_lin)
    inside_is_first = torch.where(fid_q == 0, True,
                                  torch.where(fid_p == 0, False, z_p < z_q))
    fid_in = torch.where(inside_is_first, fid_p, fid_q)
    tri = faces[torch.clamp(fid_in.long() - 1, min=0)]          # (B, K, 3)

    V = v_clip.shape[1]
    vv_ = take_rows(v_clip.reshape(B * V, 4),
                    torch.arange(B, device=dev)[:, None, None] * V + tri)
    w = vv_[..., 3]
    safe_w = torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    sx = (vv_[..., 0] / safe_w + 1.0) * (0.5 * W)
    sy = (vv_[..., 1] / safe_w + 1.0) * (0.5 * H)
    x0, x1, x2 = sx[..., 0], sx[..., 1], sx[..., 2]
    y0, y1, y2 = sy[..., 0], sy[..., 1], sy[..., 2]
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    sgn = torch.where(det >= 0, 1.0, -1.0)[..., None]
    ea = torch.stack([y1 - y2, y2 - y0, y0 - y1], -1) * sgn
    eb = torch.stack([x2 - x1, x0 - x2, x1 - x0], -1) * sgn
    ec = torch.stack([x1 * y2 - x2 * y1, x2 * y0 - x0 * y2,
                      x0 * y1 - x1 * y0], -1) * sgn

    x_p = (p_lin % W).float() + 0.5
    y_p = torch.div(p_lin, W, rounding_mode="floor").float() + 0.5
    x_q = (q_lin % W).float() + 0.5
    y_q = torch.div(q_lin, W, rounding_mode="floor").float() + 0.5
    e_p = ea * x_p[..., None] + eb * y_p[..., None] + ec
    e_q = ea * x_q[..., None] + eb * y_q[..., None] + ec
    w_first, w_second = _pair_blend(inside_is_first, e_p, e_q, slot_ok)

    color_f = color.reshape(B * n_pix, C)
    base = (torch.arange(B, device=dev) * n_pix)[:, None]
    gp = (base + p_lin).reshape(-1)
    gq = (base + q_lin).reshape(-1)
    delta = color_f[gq] - color_f[gp]                            # (B·K, C)
    out = color_f.index_add(0, gp, w_first.reshape(-1, 1) * delta)
    out = out.index_add(0, gq, -w_second.reshape(-1, 1) * delta)
    return out.reshape(B, H, W, C)
