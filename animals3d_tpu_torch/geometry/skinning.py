"""Heuristic skeleton estimation + linear blend skinning
(port of `estimate_bones` and `skinning` of `animals3d_tpu.geometry.skinning`).

Every selection is a masked argmin/quantile over the valid vertices, and
the kinematic chain is a root-first ancestor matrix (K, D) of bone ids
(-1 = identity), so forward kinematics is a product of gathered per-bone
local transforms along the depth axis. Skeleton layout: body bones
0..n_body-1 (chain a, head side, root h-1; chain b, tail side, root
n_body-1), then 4 legs × n_leg bones, foot first.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def line_segment_distance(a, b, points):
    """Distance from `points` (..., V, 3) to segments [a, b] (..., 3)."""
    ab = b - a
    ap = points - a[..., None, :]
    t = (ap * ab[..., None, :]).sum(-1) / torch.clamp(
        (ab * ab).sum(-1)[..., None], min=1e-6)
    t = t.clamp(0.0, 1.0)
    proj = a[..., None, :] + t[..., None] * ab[..., None, :]
    d2 = ((points - proj) ** 2).sum(-1)
    return torch.sqrt(d2 + 1e-6)


def euler_angles_to_matrix(angles, convention: str = "XYZ"):
    """(..., 3) Euler angles → (..., 3, 3), PyTorch3D semantics."""
    def axis_rot(axis, t):
        c, s = torch.cos(t), torch.sin(t)
        one, zero = torch.ones_like(t), torch.zeros_like(t)
        if axis == "X":
            rows = (one, zero, zero, zero, c, -s, zero, s, c)
        elif axis == "Y":
            rows = (c, zero, s, zero, one, zero, -s, zero, c)
        else:
            rows = (c, -s, zero, s, c, zero, zero, zero, one)
        return torch.stack(rows, -1).reshape(*t.shape, 3, 3)

    mats = [axis_rot(ax, angles[..., i]) for i, ax in enumerate(convention)]
    return mats[0] @ mats[1] @ mats[2]


def matrix_to_axis_angle(R):
    """(..., 3, 3) rotation → (..., 3) axis-angle, PyTorch3D semantics
    (the Visualizer interpolates viewpoints with it); near angle 0 the
    scaled axis goes to 0 smoothly."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    angle = torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    sin = torch.sin(angle)[..., None]
    big = sin.abs() > 1e-6
    unit = torch.where(big, axis / torch.where(big, sin * 2.0,
                                               torch.ones_like(sin)),
                       axis * 0.5)
    return unit * torch.where(big[..., 0], angle,
                              torch.ones_like(angle))[..., None]


def axis_angle_to_matrix(v):
    """(..., 3) axis-angle → (..., 3, 3) by Rodrigues' formula."""
    angle = torch.linalg.norm(v, dim=-1, keepdim=True)
    axis = v / torch.clamp(angle, min=1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], -1) \
        .reshape(*x.shape, 3, 3)
    a = angle[..., None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(K.shape)
    return eye + torch.sin(a) * K + (1.0 - torch.cos(a)) * (K @ K)


class BoneStructure(NamedTuple):
    ancestors: torch.Tensor   # (K, D) int64, root-first path; -1 pad
    n_body_bones: int
    n_legs: int
    n_leg_bones: int
    body_bone_idx: torch.Tensor  # (4,) leg attachment body bones


def _estimate_bone_rotation(forward):
    """Rest-pose bone frame: columns right, up, forward (= bone dir)."""
    fwd = forward / torch.clamp(torch.linalg.norm(forward, dim=-1,
                                                  keepdim=True), min=1e-12)
    right0 = torch.tensor([1.0, 0.0, 0.0], dtype=forward.dtype,
                          device=forward.device).expand_as(fwd)
    up = torch.cross(fwd, right0, dim=-1)
    up = up / torch.clamp(torch.linalg.norm(up, dim=-1, keepdim=True),
                          min=1e-12)
    right = torch.cross(up, fwd, dim=-1)
    return torch.stack([right, up, fwd], -1)


def _masked_nanquantile(x, valid, q: float):
    """Linear-interpolated quantile of x over `valid` entries of the whole
    array (`jnp.nanquantile` of the masked array). Written as a sort, so it
    has no element-count limit (`torch.nanquantile` refuses > 2^24)."""
    s, _ = torch.sort(torch.where(valid, x, torch.full_like(x, np.inf))
                      .reshape(-1))
    n = valid.sum().to(x.dtype)
    pos = (n - 1) * q
    lo = torch.floor(pos)
    hw = pos - lo
    top = torch.clamp(n - 1, min=0)
    lo_v = s[torch.minimum(lo, top).clamp(min=0).long()]
    hi_v = s[torch.minimum(torch.ceil(pos), top).clamp(min=0).long()]
    return lo_v * (1 - hw) + hi_v * hw


def _take_vert(verts, idx):
    """verts (B, F, V, 3), idx (B, F) → (B, F, 3)."""
    return torch.gather(verts, 2, idx[..., None, None].expand(
        *idx.shape, 1, 3))[:, :, 0]


def _body_ancestors(n_body_bones: int) -> np.ndarray:
    half = n_body_bones // 2
    A = -np.ones((n_body_bones, half), np.int64)
    for j in range(n_body_bones):
        root = half - 1 if j < half else n_body_bones - 1
        path = list(range(root, j - 1, -1))
        A[j, :len(path)] = path
    return A


def _full_ancestors(n_body: int, n_legs: int, n_leg: int, body_idx,
                    attach: bool):
    """(K, D) ancestor matrix; leg rows depend on the attachment ids."""
    dev = body_idx.device
    half = n_body // 2
    body = torch.as_tensor(np.concatenate(
        [_body_ancestors(n_body), -np.ones((n_body, n_leg), np.int64)], 1),
        device=dev)
    t = torch.arange(half, device=dev)
    rows = [body]
    for li in range(n_legs):
        s = n_body + li * n_leg
        if attach:
            k = body_idx[li]
            root = torch.where(k < half, half - 1, n_body - 1)
            vals = root - t
            bp = torch.where(vals >= k, vals, torch.full_like(vals, -1))
        else:
            bp = torch.full((half,), -1, dtype=torch.int64, device=dev)
        for i in range(n_leg):
            suffix = -np.ones((n_leg,), np.int64)
            chain = list(range(s + n_leg - 1, s + i - 1, -1))
            suffix[:len(chain)] = chain
            rows.append(torch.cat([bp, torch.as_tensor(suffix, device=dev)])
                        [None])
    return torch.cat(rows, 0)


def estimate_bones(verts, v_valid, n_body_bones: int, n_legs: int = 4,
                   n_leg_bones: int = 0, body_bones_mode: str = "z_minmax_y+",
                   attach_legs_to_body: bool = True,
                   bone_y_threshold: Optional[float] = None,
                   legs_to_body_joint_indices=None):
    """Bones (B, F, K, 2, 3) and the BoneStructure from (B, F, V, 3)
    vertices; no gradient flows through them."""
    verts = verts.detach()
    B, F, V, _ = verts.shape
    valid = v_valid[None, None, :].expand(B, F, V)
    big = 1e6
    xs, ys, zs = verts[..., 0], verts[..., 1], verts[..., 2]
    denom = torch.clamp(valid.sum(-1), min=1)
    mid_point = (verts * valid[..., None]).sum(2) / denom[..., None]

    if body_bones_mode == "z_minmax":
        ok = valid
    elif body_bones_mode == "z_minmax_y+":
        ok = valid & (ys > (mid_point[..., None, 1] - 0.5))
    else:
        raise NotImplementedError(body_bones_mode)
    point_a = _take_vert(verts, torch.argmax(
        torch.where(ok, zs, torch.full_like(zs, -big)), 2))
    point_b = _take_vert(verts, torch.argmin(
        torch.where(ok, zs, torch.full_like(zs, big)), 2))

    # snap ends and mid to the x=0 symmetry plane
    point_a = torch.cat([torch.zeros_like(point_a[..., :1]),
                         point_a[..., 1:]], -1)
    point_b = torch.cat([torch.zeros_like(point_b[..., :1]),
                         point_b[..., 1:]], -1)
    mid_y = mid_point[..., 1:2] + (0.5 if n_leg_bones > 0 else 0.0)
    mid_point = torch.cat([torch.zeros_like(mid_point[..., :1]), mid_y,
                           mid_point[..., 2:]], -1)

    assert n_body_bones % 2 == 0
    half = n_body_bones // 2
    n_joints = n_body_bones + 1
    blend = torch.linspace(0.0, 1.0, -(-n_joints // 2), dtype=verts.dtype,
                           device=verts.device)[None, None, :, None]
    joints_a = point_a[:, :, None] * (1 - blend) + \
        mid_point[:, :, None] * blend
    joints_b = point_b[:, :, None] * blend + \
        mid_point[:, :, None] * (1 - blend)
    joints = torch.cat([joints_a[:, :, :-1], joints_b], 2)

    b2j = [(i + 1, i) for i in range(half)] + \
        [(i, i + 1) for i in range(n_body_bones - 1, half - 1, -1)]
    body_bones = torch.stack(
        [torch.stack([joints[:, :, a], joints[:, :, b]], 2) for a, b in b2j],
        2)

    if n_leg_bones == 0:
        structure = BoneStructure(
            torch.as_tensor(_body_ancestors(n_body_bones),
                            device=verts.device),
            n_body_bones, 0, 0,
            torch.zeros((4,), dtype=torch.int64, device=verts.device))
        return body_bones, structure

    assert n_legs == 4
    zero = torch.zeros((), dtype=verts.dtype, device=verts.device)
    if bone_y_threshold is None:
        x_margin = (_masked_nanquantile(xs, valid, 0.95)
                    - _masked_nanquantile(xs, valid, 0.05)) * 0.2
        x0 = z0 = z_margin = zero
        dzp, dzn = zs > 0, zs < 0
    else:
        y_thr = _masked_nanquantile(ys, valid, bone_y_threshold)
        leg_region = valid & (ys < y_thr)
        x0 = _masked_nanquantile(xs, leg_region, 0.5)
        z0 = _masked_nanquantile(zs, leg_region, 0.5)
        x_margin = (_masked_nanquantile(xs, leg_region, 0.95)
                    - _masked_nanquantile(xs, leg_region, 0.05)) * 0.2
        z_margin = (_masked_nanquantile(zs, leg_region, 0.95)
                    - _masked_nanquantile(zs, leg_region, 0.05)) * 0.2
        dzp, dzn = zs - z0 > z_margin, zs < z0
    quadrants = [
        valid & (xs - x0 > x_margin) & dzp,
        valid & (xs - x0 > x_margin) & dzn,
        valid & (xs - x0 < -x_margin) & dzn,
        valid & (xs - x0 < -x_margin) & dzp,
    ]
    fixed_idx = list(legs_to_body_joint_indices) \
        if legs_to_body_joint_indices is not None else [None] * 4

    leg_bones_all, body_idx_all = [], []
    for li, quad in enumerate(quadrants):
        # foot: lowest-y point in the quadrant (fallback: global lowest)
        has_pts = quad.any(-1, keepdim=True)
        mask = torch.where(has_pts, quad, valid)
        foot = _take_vert(verts, torch.argmin(
            torch.where(mask, ys, torch.full_like(ys, big)), 2))
        if fixed_idx[li] is not None:
            body_idx = torch.tensor(fixed_idx[li], device=verts.device)
        elif li == 2:
            body_idx = body_idx_all[1]
        elif li == 3:
            body_idx = body_idx_all[0]
        else:
            # attachment: body end joint closest in z to batch (0, 0)'s foot
            dz = (body_bones[0, 0, :, 1, 2] - foot[0, 0, 2]).abs()
            body_idx = torch.argmin(dz)
        body_idx_all.append(body_idx)
        body_joint = body_bones[:, :, body_idx, 1]
        blend_l = torch.linspace(0.0, 1.0, n_leg_bones + 1,
                                 dtype=verts.dtype, device=verts.device) \
            [None, None, :, None]
        leg_joints = foot[:, :, None] * (1 - blend_l) + \
            body_joint[:, :, None] * blend_l
        leg_bones_all.append(torch.stack(
            [torch.stack([leg_joints[:, :, i + 1], leg_joints[:, :, i]], 2)
             for i in range(n_leg_bones)], 2))

    bones = torch.cat([body_bones] + leg_bones_all, 2)
    body_idx_arr = torch.stack(body_idx_all)
    ancestors = _full_ancestors(n_body_bones, n_legs, n_leg_bones,
                                body_idx_arr, attach_legs_to_body)
    return bones, BoneStructure(ancestors, n_body_bones, n_legs, n_leg_bones,
                                body_idx_arr)


def compute_bone_transforms(bones, structure: BoneStructure, angles):
    """Per-bone world transforms (B, F, K, 4, 4) by composing local
    transforms along root-first ancestor paths."""
    B, F, K = angles.shape[:3]
    joint = bones[..., 0, :]
    R_rest = _estimate_bone_rotation(bones[..., 1, :] - bones[..., 0, :])
    R_pred = euler_angles_to_matrix(angles, "XYZ")
    # local transform L = rest @ rot @ rest^-1 with translation
    M3 = R_rest @ R_pred @ R_rest.transpose(-1, -2)
    tr = joint - torch.einsum("...ij,...j->...i", M3, joint)
    L = torch.zeros((B, F, K, 4, 4), dtype=bones.dtype, device=bones.device)
    L[..., :3, :3] = M3
    L[..., :3, 3] = tr
    L[..., 3, 3] = 1.0
    eye = torch.eye(4, dtype=bones.dtype, device=bones.device) \
        .expand(B, F, 1, 4, 4)
    L_ext = torch.cat([L, eye], 2)                  # slot K = identity
    anc = torch.where(structure.ancestors < 0,
                      torch.full_like(structure.ancestors, K),
                      structure.ancestors)
    M = torch.eye(4, dtype=bones.dtype, device=bones.device) \
        .expand(B, F, K, 4, 4)
    for d in range(anc.shape[1]):
        M = M @ L_ext[:, :, anc[:, d]]
    return M


def skinning(v_pos, bones, structure: BoneStructure, angles,
             output_posed_bones: bool = False, temperature: float = 1.0,
             v_valid=None):
    """Linear blend skinning. v_pos: (B, F, V, 3) or (1, 1, V, 3);
    angles: (B, F, K, 3). Returns (posed (B, F, V, 3), aux)."""
    B, F, K = angles.shape[:3]
    bones = bones.expand(B, F, *bones.shape[2:])
    v_pos = v_pos.expand(B, F, *v_pos.shape[2:])
    vd = v_pos.detach()
    d = torch.stack([line_segment_distance(bones[:, :, k, 0],
                                           bones[:, :, k, 1], vd)
                     for k in range(K)], 0)           # (K, B, F, V)
    w = torch.softmax(-d / temperature, dim=0)
    M = compute_bone_transforms(bones, structure, angles)
    M_blend = torch.einsum("kbfv,bfkij->bfvij", w, M)
    hom = torch.cat([v_pos, torch.ones_like(v_pos[..., :1])], -1)
    posed = torch.einsum("bfvij,bfvj->bfvi", M_blend, hom)[..., :3]
    if v_valid is not None:
        posed = torch.where(v_valid[None, None, :, None], posed, v_pos)
    aux = {"bones_pred": bones, "vertices_to_bones": w}
    if output_posed_bones:
        bones_hom = torch.cat([bones, torch.ones_like(bones[..., :1])], -1)
        aux["posed_bones"] = torch.einsum("bfkij,bfkej->bfkei", M,
                                          bones_hom)[..., :3]
    return posed, aux
