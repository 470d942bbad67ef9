"""Procedural Kuhn tet lattice (host-side numpy), as in `animals3d_tpu`.

The lattice marching-tets path (`ops.dmtet.marching_tets_lattice`) derives
every edge and tet from index shifts, so only the vertex positions reach
the device. Quartet `.npz` grids are not part of this port.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

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
    """Static lattice data (numpy, host-resident). The lattice kernels
    derive every edge and tet from index shifts, so only the vertex
    positions are kept."""
    verts: np.ndarray          # (N, 3) float32, in [-0.5, 0.5]^3 (unscaled)
    res: int
    is_lattice: bool = True


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


@functools.lru_cache(maxsize=4)
def load_tet_grid(res: int) -> TetGrid:
    """The procedural Kuhn lattice of resolution `res`."""
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
    """Device-resident lattice vertex positions (the lattice kernels derive
    everything else from index shifts)."""

    def __init__(self, grid: TetGrid, device):
        self.verts = torch.as_tensor(grid.verts, device=device)
        self.res = grid.res
        self.is_lattice = grid.is_lattice
