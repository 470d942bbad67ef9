"""Batched triangle mesh with capacity-bounded validity masks
(port of `animals3d_tpu.geometry.mesh`).

Vertices are batched (B, V, 3) with shared connectivity (F, 3); V and F
are static capacities with `v_valid`/`f_valid` masks from marching tets.
Invalid faces are (0, 0, 0)-degenerate and contribute nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def safe_normalize(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp((x * x).sum(-1, keepdim=True), min=eps))


@dataclasses.dataclass(frozen=True)
class Mesh:
    v_pos: torch.Tensor                 # (B, V, 3)
    t_pos_idx: torch.Tensor             # (F, 3) int64, shared across batch
    v_valid: torch.Tensor               # (V,) bool
    f_valid: torch.Tensor               # (F,) bool
    num_verts: torch.Tensor             # () int
    num_faces: torch.Tensor             # () int
    v_nrm: Optional[torch.Tensor] = None        # (B, V, 3)
    v_tex: Optional[torch.Tensor] = None        # (B, V, 3) canonical pos
    face_gidx: Optional[torch.Tensor] = None    # (F,) static global face id

    @property
    def batch_size(self) -> int:
        return self.v_pos.shape[0]

    def deform(self, deformation: torch.Tensor) -> "Mesh":
        """Apply a per-vertex offset (B, V, 3), masked to valid vertices."""
        offs = torch.where(self.v_valid[None, :, None], deformation,
                           torch.zeros_like(deformation))
        return dataclasses.replace(self, v_pos=self.v_pos + offs)

    def extend(self, n: int) -> "Mesh":
        """Repeat batch entries n times (B → B*n), like mesh.extend."""
        app = lambda a: (a.repeat_interleave(n, 0)
                         if a is not None and a.ndim == 3 else a)
        return dataclasses.replace(
            self, v_pos=app(self.v_pos), v_nrm=app(self.v_nrm),
            v_tex=app(self.v_tex))


def face_normals(v_pos, t_pos_idx, f_valid, normalize: bool = True):
    """(B, F, 3) face normals; zero for invalid faces."""
    v0 = v_pos[:, t_pos_idx[:, 0]]
    v1 = v_pos[:, t_pos_idx[:, 1]]
    v2 = v_pos[:, t_pos_idx[:, 2]]
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)
    if normalize:
        fn = safe_normalize(fn)
    return torch.where(f_valid[None, :, None], fn, torch.zeros_like(fn))


def auto_normals(v_pos, t_pos_idx, v_valid, f_valid):
    """Area-weighted smooth vertex normals: splat unnormalized face normals
    to vertices (`index_add_`), then normalize with a [0, 0, 1] fallback
    for degenerate/invalid vertices."""
    B, V, _ = v_pos.shape
    Fn = t_pos_idx.shape[0]
    tab = v_pos.transpose(0, 1).reshape(V, B * 3)
    c0 = tab[t_pos_idx[:, 0]].reshape(Fn, B, 3)
    c1 = tab[t_pos_idx[:, 1]].reshape(Fn, B, 3)
    c2 = tab[t_pos_idx[:, 2]].reshape(Fn, B, 3)
    fn = torch.cross(c1 - c0, c2 - c0, dim=-1)
    fn = torch.where(f_valid[:, None, None], fn, torch.zeros_like(fn)) \
        .reshape(Fn, B * 3)
    acc = torch.zeros((V, B * 3), dtype=v_pos.dtype, device=v_pos.device)
    for k in range(3):
        acc = acc.index_add(0, t_pos_idx[:, k], fn)
    v_nrm = acc.reshape(V, B, 3).transpose(0, 1)
    dot = (v_nrm * v_nrm).sum(-1, keepdim=True)
    fallback = torch.tensor([0.0, 0.0, 1.0], dtype=v_pos.dtype,
                            device=v_pos.device)
    v_nrm = torch.where(dot > 1e-20, v_nrm, fallback)
    return safe_normalize(v_nrm)


def make_mesh(v_pos, t_pos_idx, v_valid, f_valid, num_verts, num_faces,
              v_tex=None, face_gidx=None) -> Mesh:
    """Build a Mesh and compute smooth vertex normals."""
    v_nrm = auto_normals(v_pos, t_pos_idx, v_valid, f_valid)
    return Mesh(v_pos=v_pos, t_pos_idx=t_pos_idx, v_valid=v_valid,
                f_valid=f_valid, num_verts=num_verts, num_faces=num_faces,
                v_nrm=v_nrm, v_tex=v_tex if v_tex is not None else v_pos,
                face_gidx=face_gidx)
