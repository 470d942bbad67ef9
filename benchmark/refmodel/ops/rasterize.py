"""Triangle rasterization reference and per-pixel resolve
(port of `animals3d_tpu.ops.rasterize`: `Rast`, `_face_coeffs`, `rasterize`,
`compute_barycentrics` and two paths of `resolve`: the hybrid path, a row
gather forward with the scatter-add kernel of `ops.resolve_cuda` as its
backward, and the kernel path of `A3D_MXU_FWD=1`, whose forward is the
resolve-rows kernel of `ops.resolve_cuda`, in tile order; and
`interpolate`, with `interpolate_sorted_bwd` and `gather_rows`, whose
backward is a sort and a segmented sum instead of autograd's scatter-add:
the same gradient summed in another order, which no path calls).

Conventions (the reference's GL pipeline): `v_clip` is (B, V, 4) clip
space; NDC = xyz / w; smaller NDC z is nearer; pixel (i, j) has centre
(j + 0.5, i + 0.5) with screen x = (ndc_x + 1)/2·W, y = (ndc_y + 1)/2·H;
`face_id` = face index + 1, 0 = background; no backface culling; exact-z
ties go to the smallest face id. Visibility is not differentiable;
barycentrics and interpolated attributes are recomputed differentiably
for the winning face. The tile kernel used by the renderer is in
`ops.rasterize_cuda`; `rasterize` here is the plain chunk-scan reference.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from refmodel.geometry.mesh import take_rows
from refmodel.ops.resolve_cuda import (TILE_H, TILE_W,
                                                  from_tile_order,
                                                  resolve_bwd, resolve_fwd,
                                                  to_tile_order)
from refmodel.precision import compute_dtype


class Rast(NamedTuple):
    uv: Optional[torch.Tensor]  # (B, H, W, 2) perspective-correct barycentrics
    z: torch.Tensor             # (B, H, W) NDC depth of the hit, 0 on background
    face_id: torch.Tensor       # (B, H, W) int32, face index + 1, 0 = background
    # tile kernel's per-(image, tile, chunk) "took a pixel" flags (None
    # from the plain `rasterize`)
    flags: Optional[torch.Tensor] = None

    @property
    def mask(self) -> torch.Tensor:
        return self.face_id > 0


def affine(a, b, c, x, y):
    """(a·x + b·y) + c, each product and sum rounded to float32 on its own
    (no fused multiply-add) — the operation order of the CUDA kernel."""
    return a * x + b * y + c


def _face_coeffs(v_clip, faces, f_valid, height: int, width: int):
    """Per-face affine coefficients A (F, 3, 4) with [px, py, 1] @ A[f] =
    [e0, e1, e2, z]: sign-corrected barycentric numerators (inside ⇔ all
    ≥ 0, edge constants shifted by 1e-4·|det| so shared-edge pixels stay
    covered) and the affine NDC depth. Invalid faces get all-zero rows."""
    fv = v_clip[faces]                                # (F, 3, 4)
    fw = fv[..., 3]
    safe_w = torch.where(fw.abs() > 1e-9, fw, torch.full_like(fw, 1e-9))
    ndc = fv[..., :3] / safe_w[..., None]
    fx = (ndc[..., 0] + 1.0) * (0.5 * width)
    fy = (ndc[..., 1] + 1.0) * (0.5 * height)
    fz = ndc[..., 2]
    x0, x1, x2 = fx[:, 0], fx[:, 1], fx[:, 2]
    y0, y1, y2 = fy[:, 0], fy[:, 1], fy[:, 2]
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    a0, b0, c0 = y1 - y2, x2 - x1, x1 * y2 - x2 * y1
    a1, b1, c1 = y2 - y0, x0 - x2, x2 * y0 - x0 * y2
    a2, b2, c2 = y0 - y1, x1 - x0, x0 * y1 - x1 * y0
    sgn = torch.where(det >= 0, 1.0, -1.0)
    inv_det = sgn / torch.clamp(det.abs(), min=1e-12)
    ok = f_valid & (det.abs() > 1e-12) & (fw > 1e-6).all(-1)
    e = torch.stack([torch.stack([a0, b0, c0], -1),
                     torch.stack([a1, b1, c1], -1),
                     torch.stack([a2, b2, c2], -1)], -1) * sgn[:, None, None]
    zrow = torch.einsum("fki,fi->fk", e, fz) * inv_det.abs()[:, None]
    e = e.clone()
    e[:, 2, :] = e[:, 2, :] + 1e-4 * det.abs()[:, None]
    A = torch.cat([e, zrow[:, :, None]], -1)
    A = torch.where(ok[:, None, None], A, torch.zeros_like(A))
    return A, ok


def rasterize(v_clip, faces, f_valid, resolution, chunk: int = 256) -> Rast:
    """Plain reference: scan face chunks with a running (z, id) argmin."""
    height, width = resolution
    v_nd = v_clip.detach()
    Fn = faces.shape[0]
    pad = (-Fn) % chunk
    dev = v_clip.device
    faces_p = torch.cat([faces, torch.zeros((pad, 3), dtype=faces.dtype,
                                            device=dev)], 0)
    f_valid_p = torch.cat([f_valid, torch.zeros((pad,), dtype=torch.bool,
                                                device=dev)], 0)
    nch = (Fn + pad) // chunk
    ys = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    px, py = px.reshape(-1, 1, 1), py.reshape(-1, 1, 1)
    zs, ids = [], []
    for vc in v_nd:
        A, ok = _face_coeffs(vc, faces_p, f_valid_p, height, width)
        best_z = torch.full((height * width,), float("inf"), device=dev)
        best_id = torch.zeros((height * width,), dtype=torch.int32,
                              device=dev)
        for c in range(nch):
            A_c = A[c * chunk:(c + 1) * chunk]                  # (chunk, 3, 4)
            E = affine(A_c[:, 0], A_c[:, 1], A_c[:, 2], px, py)  # (P, chunk, 4)
            cov = (E[..., :3] >= 0).all(-1) & ok[c * chunk:(c + 1) * chunk]
            zc = torch.where(cov, E[..., 3], torch.full_like(E[..., 3],
                                                             float("inf")))
            local_z, local = zc.min(1)
            take = local_z < best_z
            best_z = torch.where(take, local_z, best_z)
            best_id = torch.where(take, (c * chunk + local + 1).int(), best_id)
        zs.append(best_z.reshape(height, width))
        ids.append(best_id.reshape(height, width))
    z, fid = torch.stack(zs), torch.stack(ids)
    z = torch.where(fid > 0, z, torch.zeros_like(z))
    uv = compute_barycentrics(v_clip, faces, fid, (height, width))
    return Rast(uv=uv, z=z, face_id=fid)


def compute_barycentrics(v_clip, faces, face_id, resolution):
    """Perspective-correct (u, v) of each pixel's winning face,
    differentiable w.r.t. v_clip (the face assignment is fixed)."""
    height, width = resolution
    B = v_clip.shape[0]
    dev = v_clip.device
    sel = torch.clamp(face_id.long() - 1, min=0)                # (B, H, W)
    tri = faces[sel]                                            # (B,H,W,3)
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    vv = v_clip[bidx, tri]                                      # (B,H,W,3,4)
    w = vv[..., 3]
    safe_w = torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))
    sx = (vv[..., 0] / safe_w + 1.0) * (0.5 * width)
    sy = (vv[..., 1] / safe_w + 1.0) * (0.5 * height)
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)[None, :]
    x0, x1, x2 = sx[..., 0], sx[..., 1], sx[..., 2]
    y0, y1, y2 = sy[..., 0], sy[..., 1], sy[..., 2]
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    safe_det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    l1 = ((xs - x0) * (y2 - y0) - (x2 - x0) * (ys - y0)) / safe_det
    l2 = ((x1 - x0) * (ys - y0) - (xs - x0) * (y1 - y0)) / safe_det
    l0 = 1.0 - l1 - l2
    iw = 1.0 / safe_w
    denom = l0 * iw[..., 0] + l1 * iw[..., 1] + l2 * iw[..., 2]
    safe_denom = torch.where(denom.abs() > 1e-12, denom,
                             torch.full_like(denom, 1e-12))
    uv = torch.stack([l1 * iw[..., 1] / safe_denom,
                      l2 * iw[..., 2] / safe_denom], -1)
    return torch.where((face_id > 0)[..., None], uv, torch.zeros_like(uv))


class _ResolveRows(torch.autograd.Function):
    """rows[b, p] = pf[b, max(face_id[b, p] − 1, 0)]: a plain gather
    forward; the backward is the scatter-add kernel of `ops.resolve_cuda`
    (its plain version on the CPU), which takes the cotangent in the
    compute type of the precision policy and accumulates in float32.
    Background pixels gather face 0's row and receive no gradient: callers
    mask them downstream."""

    @staticmethod
    def forward(ctx, pf, face_id):
        B, P = face_id.shape
        sel = torch.clamp(face_id.long() - 1, min=0)
        ctx.save_for_backward(face_id)
        ctx.num_faces = pf.shape[1]
        return torch.gather(pf, 1, sel[..., None].expand(B, P, pf.shape[-1]))

    @staticmethod
    def backward(ctx, g):
        face_id, = ctx.saved_tensors
        d_pf = resolve_bwd(g.to(compute_dtype()).contiguous(), face_id,
                           ctx.num_faces)
        return d_pf.to(g.dtype), None


class _ResolveRowsCM(torch.autograd.Function):
    """rows[b, :, q] = pf[b, face_id − 1] at tile-order pixel q, channel-
    major (B, R, T·TP) and zero on background (the counterpart of
    `_resolve_rows_cm`): the resolve-rows kernel of `ops.resolve_cuda` (its
    plain version on the CPU) forward; the backward lays the cotangent out
    in raster order and runs the scatter-add kernel in the compute type of
    the precision policy, as `_ResolveRows` does."""

    @staticmethod
    def forward(ctx, pf, face_id, resolution):
        ctx.save_for_backward(face_id)
        ctx.num_faces = pf.shape[1]
        ctx.resolution = resolution
        rows = resolve_fwd(pf.float().contiguous(), face_id, resolution)
        return rows.to(pf.dtype)

    @staticmethod
    def backward(ctx, g):
        face_id, = ctx.saved_tensors
        g_r = from_tile_order(g, ctx.resolution)
        d_pf = resolve_bwd(g_r.to(compute_dtype()).contiguous(), face_id,
                           ctx.num_faces)
        return d_pf.to(g.dtype), None, None


def resolve(attr, rast: Rast, v_clip, faces, face_attr=None,
            rows: str = "gather"):
    """Fused barycentrics + attribute interpolation with one row of a
    per-face table per pixel.

    Clip positions and attributes pack into a per-face table (B, F, 3·C)
    (+ optional per-face `face_attr` (B, F, K) channels); each pixel
    takes its winner's row once and interpolates perspective-correctly.
    `rows` picks how: "gather" (the JAX package's default hybrid path) is
    a row gather in raster order with the scatter-add kernel backward;
    "kernel" (its `A3D_MXU_FWD=1` path) is the resolve-rows kernel, which
    writes the rows channel-major in tile order, so the barycentric math
    runs in tile order and `assemble` lays the results back out. The two
    give the same values. attr: (B, V, A) or (V, A). Returns (uv (B,H,W,2),
    out (B,H,W,A)) plus (B,H,W,K) if face_attr is given; all 0 on
    background. Differentiable w.r.t. v_clip, attr and face_attr; the face
    assignment is fixed.
    """
    if rows not in ("gather", "kernel"):
        raise ValueError(f"rows {rows!r}: want 'gather' or 'kernel'")
    B, H, W = rast.face_id.shape
    if attr.ndim == 2:
        attr = attr[None].expand(B, *attr.shape)
    nA = attr.shape[-1]
    fid = rast.face_id
    C = 4 + nA
    V = v_clip.shape[1]
    Fn = faces.shape[0]
    pv = torch.cat([v_clip, attr.to(v_clip.dtype)], -1)          # (B, V, C)
    tab = pv.transpose(0, 1).reshape(V, B * C)
    pf = take_rows(tab, faces).reshape(Fn, 3, B, C).permute(2, 0, 1, 3) \
        .reshape(B, Fn, 3 * C)
    if face_attr is not None:
        pf = torch.cat([pf, face_attr.to(pf.dtype)], -1)
    dev = v_clip.device
    fid_r = fid.reshape(B, H * W).to(torch.int32).contiguous()
    xs = (torch.arange(H * W, device=dev) % W).float() + 0.5
    ys = (torch.arange(H * W, device=dev) // W).float() + 0.5
    keep = (fid > 0).reshape(B, 1, H * W)
    if rows == "kernel":
        if H % TILE_H or W % TILE_W:
            raise ValueError(f"resolution {(H, W)} must be a multiple of "
                             f"({TILE_H}, {TILE_W})")
        rT = _ResolveRowsCM.apply(pf, fid_r, (H, W))             # (B, R, P)
        # pixel centres and the foreground mask in the rows' tile order
        xs, ys = (to_tile_order(a.reshape(1, H * W, 1), (H, W))[0, 0]
                  for a in (xs, ys))
        keep = to_tile_order(keep.transpose(1, 2), (H, W))

        def layout(x, ch):                     # (B, ch, T·TP) → (B, H, W, ch)
            return from_tile_order(x, (H, W)).reshape(B, H, W, ch)
    else:
        rT = _ResolveRows.apply(pf, fid_r).transpose(1, 2)       # (B, R, HW)

        def layout(x, ch):                     # (B, ch, HW) → (B, H, W, ch)
            return x.transpose(1, 2).reshape(B, H, W, ch)

    def vch(vtx, c):
        return rT[:, vtx * C + c]

    def safe(w):
        return torch.where(w.abs() > 1e-9, w, torch.full_like(w, 1e-9))

    s0, s1, s2 = safe(vch(0, 3)), safe(vch(1, 3)), safe(vch(2, 3))
    x0 = (vch(0, 0) / s0 + 1.0) * (0.5 * W)
    x1 = (vch(1, 0) / s1 + 1.0) * (0.5 * W)
    x2 = (vch(2, 0) / s2 + 1.0) * (0.5 * W)
    y0 = (vch(0, 1) / s0 + 1.0) * (0.5 * H)
    y1 = (vch(1, 1) / s1 + 1.0) * (0.5 * H)
    y2 = (vch(2, 1) / s2 + 1.0) * (0.5 * H)
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    safe_det = torch.where(det.abs() > 1e-12, det, torch.full_like(det, 1e-12))
    l1 = ((xs - x0) * (y2 - y0) - (x2 - x0) * (ys - y0)) / safe_det
    l2 = ((x1 - x0) * (ys - y0) - (xs - x0) * (y1 - y0)) / safe_det
    l0 = 1.0 - l1 - l2
    denom = l0 / s0 + l1 / s1 + l2 / s2
    safe_denom = torch.where(denom.abs() > 1e-12, denom,
                             torch.full_like(denom, 1e-12))
    u = l1 / (s1 * safe_denom)
    v = l2 / (s2 * safe_denom)
    l0p = 1.0 - u - v
    out = torch.stack([vch(0, 4 + c) * l0p + vch(1, 4 + c) * u
                       + vch(2, 4 + c) * v for c in range(nA)], 1)

    def assemble(x, ch):
        return layout(torch.where(keep, x, torch.zeros_like(x)), ch)

    uv = assemble(torch.stack([u, v], 1), 2)
    out = assemble(out, nA)
    if face_attr is None:
        return uv, out
    return uv, out, assemble(rT[:, 3 * C:], face_attr.shape[-1])


def interpolate(attr, rast: Rast, faces):
    """Per-vertex attributes at the rasterized pixels: attr (B, V, A), or
    (V, A) shared → (B, H, W, A), 0 on the background. Differentiable in
    `attr` and, through `rast.uv`, in the vertex positions (autograd's
    backward)."""
    fid = rast.face_id.detach()
    B = fid.shape[0]
    if attr.dim() == 2:
        attr = attr[None].expand(B, *attr.shape)
    tri = faces[(fid.long() - 1).clamp(min=0)]                 # (B,H,W,3)
    av = attr[torch.arange(B, device=attr.device)[:, None, None, None], tri]
    u, v = rast.uv[..., 0:1], rast.uv[..., 1:2]
    out = av[..., 0, :] * (1.0 - u - v) + av[..., 1, :] * u \
        + av[..., 2, :] * v
    return torch.where((fid > 0)[..., None], out, torch.zeros_like(out))


def _segment_sum_sorted(keys, vals, num_segments: int):
    """Σ vals (M, A) over rows with equal keys (M,) → (num_segments, A):
    a stable sort, then a segmented Hillis–Steele inclusive scan (adds at
    distance 2^s only where the key there matches, so segments never
    mix), and each segment's total written from its last row."""
    M, A = vals.shape
    perm = torch.argsort(keys, stable=True)
    keys_s = keys[perm]
    acc = vals[perm]
    step = 1
    while step < M:
        same = keys_s[step:] == keys_s[:-step]
        add = torch.where(same[:, None], acc[:-step], torch.zeros_like(
            acc[:-step]))
        acc = torch.cat([acc[:step], acc[step:] + add], 0)
        step *= 2
    is_end = torch.cat([keys_s[:-1] != keys_s[1:],
                        torch.ones(1, dtype=torch.bool, device=keys.device)])
    out = vals.new_zeros((num_segments, A))
    out[keys_s[is_end]] = acc[is_end]
    return out


class _InterpolateSorted(torch.autograd.Function):
    """`interpolate`'s function; the attributes' gradient is a sorted
    segment sum over (pixel, corner) rows."""

    @staticmethod
    def forward(ctx, attr, uv, face_id, faces):
        ctx.save_for_backward(attr, uv, face_id, faces)
        return interpolate(attr, Rast(uv=uv, z=None, face_id=face_id), faces)

    @staticmethod
    def backward(ctx, g):
        attr, uv, face_id, faces = ctx.saved_tensors
        B, V, A = attr.shape
        tri = faces[(face_id.long() - 1).clamp(min=0)]          # (B,H,W,3)
        g = torch.where((face_id > 0)[..., None], g, torch.zeros_like(g))
        d_attr, d_uv = [], []
        for b in range(B):
            av = attr[b][tri[b]]                                # (H,W,3,A)
            u, v = uv[b, ..., 0:1], uv[b, ..., 1:2]
            du = (g[b] * (av[..., 1, :] - av[..., 0, :])).sum(-1)
            dv = (g[b] * (av[..., 2, :] - av[..., 0, :])).sum(-1)
            d_uv.append(torch.stack([du, dv], -1))
            w = torch.cat([1.0 - u - v, u, v], -1)              # (H,W,3)
            vals = (w[..., None] * g[b][..., None, :]).reshape(-1, A)
            d_attr.append(_segment_sum_sorted(tri[b].reshape(-1), vals, V))
        return torch.stack(d_attr), torch.stack(d_uv), None, None


def interpolate_sorted_bwd(attr, rast: Rast, faces):
    """`interpolate` with the sorted-segment-sum backward."""
    if attr.dim() == 2:
        attr = attr[None].expand(rast.face_id.shape[0], *attr.shape)
    return _InterpolateSorted.apply(attr, rast.uv, rast.face_id.detach(),
                                    faces)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1]
        return torch.stack([t[i] for t, i in zip(table, idx)])

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        C = g.shape[-1]
        return torch.stack([_segment_sum_sorted(i.reshape(-1),
                                                gb.reshape(-1, C), ctx.n)
                            for i, gb in zip(idx, g)]), None


def gather_rows(table, idx):
    """Batched row gather (B, N, C) × (B, ...) → (B, ..., C) whose backward
    is the sorted segment sum instead of a colliding scatter-add."""
    return _GatherRows.apply(table, idx)
