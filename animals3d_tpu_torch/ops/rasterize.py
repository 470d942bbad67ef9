"""Triangle rasterization reference and per-pixel resolve
(port of `animals3d_tpu.ops.rasterize`: `Rast`, `_face_coeffs`, `rasterize`,
`compute_barycentrics` and the hybrid path of `resolve`: a row gather
forward with the scatter-add kernel of `ops.resolve_cuda` as its backward).

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

from animals3d_tpu_torch.geometry.mesh import take_rows
from animals3d_tpu_torch.ops.resolve_cuda import resolve_bwd
from animals3d_tpu_torch.precision import compute_dtype


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


def resolve(attr, rast: Rast, v_clip, faces, face_attr=None):
    """Fused barycentrics + attribute interpolation with one per-pixel row
    gather (the JAX package's hybrid path: gather forward, kernel backward).

    Clip positions and attributes pack into a per-face table (B, F, 3·C)
    (+ optional per-face `face_attr` (B, F, K) channels); each pixel
    gathers its winner's row once and interpolates perspective-correctly.
    attr: (B, V, A) or (V, A). Returns (uv (B,H,W,2), out (B,H,W,A)) plus
    (B,H,W,K) if face_attr is given; all 0 on background. Differentiable
    w.r.t. v_clip, attr and face_attr; the face assignment is fixed.
    """
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
    rows = _ResolveRows.apply(
        pf, fid.reshape(B, H * W).to(torch.int32).contiguous())
    rT = rows.transpose(1, 2)                                    # (B, R, HW)
    dev = v_clip.device
    xs = (torch.arange(H * W, device=dev) % W).float() + 0.5
    ys = (torch.arange(H * W, device=dev) // W).float() + 0.5

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
    keep = (fid > 0).reshape(B, 1, H * W)

    def assemble(x, ch):                       # (B, ch, HW) → (B, H, W, ch)
        x = torch.where(keep, x, torch.zeros_like(x))
        return x.transpose(1, 2).reshape(B, H, W, ch)

    uv = assemble(torch.stack([u, v], 1), 2)
    out = assemble(out, nA)
    if face_attr is None:
        return uv, out
    return uv, out, assemble(rT[:, 3 * C:], face_attr.shape[-1])
