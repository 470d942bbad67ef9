"""Marching tetrahedra on the procedural Kuhn lattice, with static
capacities (port of the lattice path of `animals3d_tpu.ops.dmtet`).

Contract kept from the JAX package:
  * vertices, one per sign-crossing lattice edge, in lexicographic
    (vertex, direction) edge order — the reference's `torch.unique` order;
  * faces: all 1-triangle tets first, then the 2-triangle tets' pairs,
    ascending tet id; winding flipped so surfaces face outward;
  * `v_cap`/`f_cap` buffers with valid masks; `num_verts`/`num_faces` are
    the true counts (they may exceed the capacities on overflow).
Compaction inverts prefix sums: output slot j takes the first element
whose cumulative count reaches j + 1 (`first_geq`, a `searchsorted`).
Only the lattice path is ported; npz grids are not.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from animals3d_tpu_torch.geometry.tets import kuhn_corners

# Case index = sum(occupancy[corner] << corner). Six entries per case: up to
# two triangles of local edge ids, -1 padded. Standard marching-tets table.
TRI_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1],
], np.int64)

NUM_TRI_TABLE = np.array([0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0],
                         np.int64)


class ExtractedMesh(NamedTuple):
    """Capacity-bounded mesh buffers. Invalid entries are zero-filled."""
    verts: torch.Tensor       # (v_cap, 3) float
    v_valid: torch.Tensor     # (v_cap,) bool
    faces: torch.Tensor       # (f_cap, 3) int64 — indices into verts
    f_valid: torch.Tensor     # (f_cap,) bool
    face_gidx: torch.Tensor   # (f_cap,) int64 — static global face id
    num_verts: torch.Tensor   # () int64
    num_faces: torch.Tensor   # () int64


def first_geq(csum: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """For each target t, the first index i with csum[..., i] >= t (csum
    non-decreasing along its last dim; n when t exceeds csum[..., -1])."""
    return torch.searchsorted(csum, targets.to(csum.dtype).contiguous(),
                              side="left")


# the 7 Kuhn edge directions, ascending by linear delta
_LATTICE_DIRS = np.array([
    [0, 0, 1], [0, 1, 0], [0, 1, 1], [1, 0, 0], [1, 0, 1], [1, 1, 0],
    [1, 1, 1]], np.int64)


def _lattice_tables():
    """Per-tet corner offsets and local edge → (base corner, dir rank)."""
    corners = kuhn_corners()
    edge_map = []
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    for cs in corners:
        rows = []
        for a, b in pairs:
            lo = np.minimum(cs[a], cs[b])
            d = np.abs(cs[b] - cs[a])
            rank = int(np.where((_LATTICE_DIRS == d).all(1))[0][0])
            rows.append([*lo, rank])
        edge_map.append(rows)
    return np.asarray(corners), np.asarray(edge_map, np.int64)


_LATTICE_CORNERS, _LATTICE_EDGE_MAP = _lattice_tables()


def lattice_edge_crossings(occ3: torch.Tensor) -> torch.Tensor:
    """(n,n,n) occupancy → (n³·7,) crossing flags in edge-id order
    (edge id = vertex_id * 7 + dir_rank); out-of-bounds edges are False."""
    n = occ3.shape[0]
    out = torch.zeros((n, n, n, 7), dtype=torch.bool, device=occ3.device)
    for r, (dx, dy, dz) in enumerate(_LATTICE_DIRS):
        a = occ3[:n - dx, :n - dy, :n - dz]
        b = occ3[dx:, dy:, dz:]
        out[:n - dx, :n - dy, :n - dz, r] = a != b
    return out.reshape(-1)


def lattice_tet_cases(occ3: torch.Tensor) -> torch.Tensor:
    """(n,n,n) occupancy → (m³·6,) marching-tets case ids in tet order
    (cell-major, Kuhn perm minor)."""
    n = occ3.shape[0]
    m = n - 1
    occ_i = occ3.to(torch.int64)

    def corner(c):
        return occ_i[c[0]:c[0] + m, c[1]:c[1] + m, c[2]:c[2] + m]

    cases = []
    for p in range(6):
        cs = _LATTICE_CORNERS[p]
        cases.append(corner(cs[0]) + 2 * corner(cs[1]) + 4 * corner(cs[2])
                     + 8 * corner(cs[3]))
    return torch.stack(cases, -1).reshape(-1)


def marching_tets_lattice(pos: torch.Tensor, sdf: torch.Tensor, res: int,
                          v_cap: int, f_cap: int) -> ExtractedMesh:
    """pos: (n³, 3) lattice vertex positions; sdf: (n³,); n = res + 1."""
    dev = pos.device
    n = res + 1
    occ3 = (sdf > 0).reshape(n, n, n)
    deltas = torch.tensor([1, n, n + 1, n * n, n * n + 1, n * n + n,
                           n * n + n + 1], dtype=torch.int64, device=dev)

    # ---- vertices ----
    cross = lattice_edge_crossings(occ3)
    csum_cross = torch.cumsum(cross.to(torch.int64), 0)
    num_verts = csum_cross[-1]
    src = first_geq(csum_cross, torch.arange(1, v_cap + 1, device=dev))
    v_valid = src < cross.shape[0]
    src = src.clamp(0, cross.shape[0] - 1)
    ce0 = src // 7
    ce1 = (ce0 + deltas[src % 7]).clamp(0, sdf.shape[0] - 1)
    # index_select: its backward scatters with atomics (see `take_rows`)
    s0, s1 = sdf.index_select(0, ce0), sdf.index_select(0, ce1)
    denom = s0 - s1
    denom = torch.where(denom.abs() > 1e-10, denom,
                        torch.full_like(denom, 1e-10))
    w1 = s0 / denom
    verts = pos[ce0] * (1.0 - w1)[:, None] + pos[ce1] * w1[:, None]
    verts = torch.where(v_valid[:, None], verts, torch.zeros_like(verts))

    # ---- faces ----
    case = lattice_tet_cases(occ3)
    T = case.shape[0]
    m = n - 1
    ntri = torch.as_tensor(NUM_TRI_TABLE, device=dev)[case]
    csum1 = torch.cumsum((ntri == 1).to(torch.int64), 0)
    csum2 = torch.cumsum((ntri == 2).to(torch.int64), 0)
    n1 = csum1[-1]
    num_faces = n1 + 2 * csum2[-1]

    j = torch.arange(f_cap, device=dev)
    k = torch.clamp(j - n1, min=0)
    tet_a = first_geq(csum1, j + 1)
    tet_b = first_geq(csum2, k // 2 + 1)
    in_a = j < n1
    tet = torch.where(in_a, tet_a, tet_b)
    f_valid = torch.where(in_a, tet_a < T, (tet_b < T) & (j < num_faces))
    tet = tet.clamp(0, T - 1)
    tri_sel = torch.where(in_a, torch.zeros_like(k), k % 2)

    cell = tet // 6
    perm = tet % 6
    ci = cell // (m * m)
    cj = (cell // m) % m
    ck = cell % m

    tri_rows = torch.as_tensor(TRI_TABLE, device=dev)[case[tet]]
    tri_local = torch.gather(tri_rows.reshape(f_cap, 2, 3), 1,
                             tri_sel[:, None, None].expand(f_cap, 1, 3))[:, 0]
    tri_ok = (tri_local >= 0).all(-1)
    tri_local = tri_local.clamp(min=0)

    # local edge → (base corner, dir rank) → global edge id → vertex slot
    emap = torch.as_tensor(_LATTICE_EDGE_MAP, device=dev)       # (6, 6, 4)
    entries = emap[perm[:, None], tri_local]                     # (f_cap,3,4)
    vx = ci[:, None] + entries[..., 0]
    vy = cj[:, None] + entries[..., 1]
    vz = ck[:, None] + entries[..., 2]
    edge_id = ((vx * n + vy) * n + vz) * 7 + entries[..., 3]
    faces = csum_cross[edge_id] - 1
    f_valid = f_valid & tri_ok & (faces < v_cap).all(-1) \
        & (faces >= 0).all(-1)
    # canonical positively-oriented tets emit inward-winding triangles with
    # the standard table; flip so surfaces wind outward
    faces = faces.flip(-1)
    faces = torch.where(f_valid[:, None], faces, torch.zeros_like(faces))
    face_gidx = torch.where(f_valid, tet * 2 + tri_sel,
                            torch.zeros_like(tet))
    return ExtractedMesh(verts=verts, v_valid=v_valid, faces=faces,
                         f_valid=f_valid, face_gidx=face_gidx,
                         num_verts=num_verts, num_faces=num_faces)


def marching_tets(pos, sdf, grid, v_cap: int, f_cap: int) -> ExtractedMesh:
    """Dispatch: lattice grids go to `marching_tets_lattice`."""
    if not getattr(grid, "is_lattice", False):
        raise NotImplementedError(
            "only procedural lattice grids are ported (npz grids are not)")
    return marching_tets_lattice(pos, sdf, grid.res, v_cap, f_cap)


def sdf_bce_reg_loss_lattice(sdf: torch.Tensor, res: int) -> torch.Tensor:
    """BCE consistency across the sign-crossing lattice edges, averaged
    over them. Per crossing edge, bce(a, [b > 0]) + bce(b, [a > 0]) equals
    softplus(±a) + softplus(±b) with the sign picked by the neighbour's
    occupancy, so two crossing-degree fields per vertex are accumulated
    with shifted compares and softplus is evaluated once per vertex."""
    n = res + 1
    s3 = sdf.reshape(n, n, n)
    occ = s3 > 0
    sgn = torch.sign(s3)
    deg_pos = torch.zeros_like(s3)    # crossing edges whose neighbour > 0
    deg_neg = torch.zeros_like(s3)    # crossing edges whose neighbour <= 0
    count = torch.zeros((), dtype=s3.dtype, device=s3.device)
    for dx, dy, dz in _LATTICE_DIRS.tolist():
        a_sl = (slice(0, n - dx), slice(0, n - dy), slice(0, n - dz))
        b_sl = (slice(dx, None), slice(dy, None), slice(dz, None))
        crossing = sgn[a_sl] != sgn[b_sl]
        a_occ, b_occ = occ[a_sl], occ[b_sl]
        end_pad = (0, dz, 0, dy, 0, dx)       # F.pad: last dim first
        beg_pad = (dz, 0, dy, 0, dx, 0)
        f = lambda m, pad: F.pad(m.to(s3.dtype), pad)
        deg_pos = deg_pos + f(crossing & b_occ, end_pad) \
            + f(crossing & a_occ, beg_pad)
        deg_neg = deg_neg + f(crossing & ~b_occ, end_pad) \
            + f(crossing & ~a_occ, beg_pad)
        count = count + crossing.sum()
    total = (F.softplus(-s3) * deg_pos + F.softplus(s3) * deg_neg).sum()
    return total / torch.clamp(count, min=1)


def sdf_bce_for_grid(sdf: torch.Tensor, grid) -> torch.Tensor:
    """Dispatch: lattice grids go to `sdf_bce_reg_loss_lattice`."""
    if not getattr(grid, "is_lattice", False):
        raise NotImplementedError(
            "only procedural lattice grids are ported (npz grids are not)")
    return sdf_bce_reg_loss_lattice(sdf, grid.res)
