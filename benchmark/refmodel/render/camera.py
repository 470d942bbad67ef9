"""Camera math: GL-style projection (with the reference's baked-in y flip)
and point and vector transforms (port of `animals3d_tpu.render.camera`)."""
from __future__ import annotations

import numpy as np
import torch


def perspective(fovy: float = 0.7854, aspect: float = 1.0, n: float = 0.1,
                f: float = 1000.0) -> np.ndarray:
    y = np.tan(fovy / 2)
    return np.array([
        [1 / (y * aspect), 0, 0, 0],
        [0, -1 / y, 0, 0],
        [0, 0, -(f + n) / (f - n), -(2 * f * n) / (f - n)],
        [0, 0, -1, 0],
    ], np.float32)


def xfm_points(points: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """Transform (B, V, 3) points by (B, 4, 4) matrices → (B, V, 4)."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], -1)
    return torch.einsum("bij,bvj->bvi", mtx, hom)


def xfm_vectors(vectors: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """Transform (B, V, 3) direction vectors (w = 0) by (B, 4, 4)
    matrices → (B, V, 3)."""
    return torch.einsum("bij,bvj->bvi", mtx[:, :3, :3], vectors)
