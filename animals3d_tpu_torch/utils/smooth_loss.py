"""Temporal smoothness losses over the frame dimension (port of
`animals3d_tpu.utils.smooth_loss`).

`smooth_loss(x, smooth_type, loss_type, frame_dim=1)` where x is
(B, F, ...): the mean squared ("l2"/"mse") or absolute ("l1") difference
between each frame and its successor ("dislocation"), the middle frame
("mid_frame"), the frame mean ("avg") or the detached frame median
("median", the mean of the two middle values at an even frame count, as
`jnp.median` takes it; `torch.median` would take the lower one).
"""
from __future__ import annotations

import torch


def _reduce(diff, loss_type):
    if loss_type in ("l2", "mse"):
        return (diff * diff).mean()
    if loss_type == "l1":
        # |x| with jnp.abs's gradient at 0 (+1; torch's is 0)
        return torch.where(diff >= 0, diff, -diff).mean()
    raise NotImplementedError(loss_type)


def _median(x):
    """The median over dim 0, keeping it: the middle value, or the mean of
    the two middle values at an even length."""
    s = torch.sort(x, dim=0).values
    F = s.shape[0]
    if F % 2:
        return s[F // 2][None]
    return ((s[F // 2 - 1] + s[F // 2]) * 0.5)[None]


def smooth_loss(x, smooth_type: str = "dislocation", loss_type: str = "l2",
                frame_dim: int = 1):
    if smooth_type is None:
        return 0.0
    x = torch.movedim(x, frame_dim, 0)
    F = x.shape[0]
    if smooth_type == "mid_frame":
        return _reduce(x - x[(F - 1) // 2][None], loss_type)
    if smooth_type == "dislocation":
        return _reduce(x[:-1] - x[1:], loss_type)
    if smooth_type == "avg":
        return _reduce(x - x.mean(0, keepdim=True), loss_type)
    if smooth_type == "median":
        return _reduce(x - _median(x).detach(), loss_type)
    raise NotImplementedError(smooth_type)
