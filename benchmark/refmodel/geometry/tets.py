"""Tetrahedral grids for DMTet (port of `animals3d_tpu.geometry.tets`).

`load_tet_grid(res)` reads `data/tets/{res}_tets.npz` (the reference's
Quartet grids: `vertices` in (-0.5, 0.5)^3 and `indices`) when the file
exists, and otherwise makes the procedural Kuhn lattice (6 tets per cube).

The lattice marching-tets path (`ops.dmtet.marching_tets_lattice`) derives
every edge and tet from index shifts, so only a lattice's vertex positions
reach the device. A general (npz) grid takes the edge-table path, which
needs the grid's unique edges, sorted lexicographically (the order
`torch.unique` gives the crossing subset in the reference, which fixes the
vertex order), and each tet's six edge ids in base-edge order
[01, 02, 03, 12, 13, 23] (`_unique_edges`; `DeviceTetGrid` builds them on
the device).
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

_BASE_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                       np.int64)

# The six Kuhn tetrahedra of a unit cube, as corner bit-triples (x, y, z).
# All share the main diagonal 000-111; every axis permutation gives one tet.
_KUHN_PERMS = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]


def kuhn_corners() -> np.ndarray:
    """(6, 4, 3) corner offsets per tet, orientation-canonicalized: odd
    permutations swap corners 1 and 2 so every tet is positively oriented
    and extracted surfaces wind consistently outward."""
    unit = np.eye(3, dtype=np.int32)
    out = []
    for perm in _KUHN_PERMS:
        c = [np.zeros(3, np.int32), unit[perm[0]],
             unit[perm[0]] + unit[perm[1]], np.ones(3, np.int32)]
        if np.linalg.det(np.eye(3)[list(perm)]) < 0:
            c[1], c[2] = c[2], c[1]
        out.append(np.stack(c))
    return np.stack(out)


@dataclasses.dataclass
class TetGrid:
    """Static grid data (numpy, host-resident). A lattice keeps only its
    vertex positions (its kernels derive every edge and tet from index
    shifts); a general grid keeps its tets too (`DeviceTetGrid` builds
    its edge tables on the device)."""
    verts: np.ndarray          # (N, 3) float32, in [-0.5, 0.5]^3 (unscaled)
    res: int
    is_lattice: bool = True
    tets: Optional[np.ndarray] = None      # (T, 4) int32, general grids


def lattice_verts(res: int) -> np.ndarray:
    """The (res + 1)^3 lattice vertices of [-0.5, 0.5]^3, x-major."""
    axes = np.linspace(-0.5, 0.5, res + 1, dtype=np.float32)
    grid = np.stack(np.meshgrid(axes, axes, axes, indexing="ij"), -1)
    return grid.reshape(-1, 3)


def kuhn_lattice(res: int) -> tuple[np.ndarray, np.ndarray]:
    """Subdivide [-0.5, 0.5]^3 into res^3 cubes x 6 Kuhn tets each."""
    n = res + 1

    def vid(i, j, k):
        return (i * n + j) * n + k

    i, j, k = np.meshgrid(np.arange(res), np.arange(res), np.arange(res),
                          indexing="ij")
    base = np.stack([i.ravel(), j.ravel(), k.ravel()], -1).astype(np.int64)
    tet_list = [np.stack([vid(*(base + c).T) for c in corners], -1)
                for corners in kuhn_corners()]
    # (6, C, 4) -> (C, 6, 4): tets ordered by cell, then local index
    tets = np.stack(tet_list, 0).transpose(1, 0, 2).reshape(-1, 4) \
        .astype(np.int32)
    return lattice_verts(res), np.ascontiguousarray(tets)


def _unique_edges(tets: torch.Tensor, num_verts: int):
    """All unique edges of `tets` (T, 4) and each tet's edge ids, on the
    tets' device: the sorted endpoint pairs keyed as v0 * N + v1 (int64),
    deduplicated by a sorted `torch.unique`. Returns ((E, 2), (T, 6)),
    int64."""
    e = tets.long()[:, torch.as_tensor(_BASE_EDGES, device=tets.device)]
    e = torch.sort(e, dim=-1).values.reshape(-1, 2)
    key = e[:, 0] * num_verts + e[:, 1]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    edges = torch.stack([uniq // num_verts, uniq % num_verts], -1)
    return edges, inv.reshape(-1, 6)


def load_tet_grid(res: int, data_dir: str = "data/tets") -> TetGrid:
    """`{data_dir}/{res}_tets.npz` when it exists (a general grid, with
    the file's own winding), else the procedural Kuhn lattice. The
    directory is read relative to the working directory."""
    return _load_tet_grid(res, os.path.abspath(data_dir))


@functools.lru_cache(maxsize=4)
def _load_tet_grid(res: int, data_dir: str) -> TetGrid:
    npz_path = os.path.join(data_dir, f"{res}_tets.npz")
    if os.path.exists(npz_path):
        data = np.load(npz_path)
        return TetGrid(verts=np.asarray(data["vertices"], np.float32),
                       res=res, is_lattice=False,
                       tets=np.asarray(data["indices"], np.int32))
    return TetGrid(verts=lattice_verts(res), res=res)


def default_capacity(res: int, scale: float = 6.0) -> tuple[int, int]:
    """Capacity bounds for extracted meshes (surface scales with res^2),
    rounded up to multiples of 256: v_cap = scale·res², f_cap = 2·v_cap.
    `ExtractedMesh.num_verts/num_faces` report true counts for overflow
    monitoring."""
    v_cap = max(4096, int(scale * res * res))
    f_cap = 2 * v_cap
    rnd = lambda x: int(-(-x // 256) * 256)
    return rnd(v_cap), rnd(f_cap)


class DeviceTetGrid:
    """A grid on the device: a lattice's vertex positions (its kernels
    derive everything else from index shifts), or a general grid's
    positions, `tets`, `edges` and `tet_edge_ids` (int64), the edge tables
    built there by `_unique_edges`."""

    def __init__(self, grid: TetGrid, device):
        self.verts = torch.as_tensor(grid.verts, device=device)
        self.res = grid.res
        self.is_lattice = grid.is_lattice
        self.tets = self.edges = self.tet_edge_ids = None
        if not grid.is_lattice:
            self.tets = torch.as_tensor(grid.tets, device=device).long()
            self.edges, self.tet_edge_ids = _unique_edges(
                self.tets, grid.verts.shape[0])
