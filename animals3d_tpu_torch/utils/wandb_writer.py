"""W&B logger adapter exposing the tensorboard writer surface (port of
`animals3d_tpu.utils.wandb_writer`).

Reference: `model/utils/wandb_writer.py:12-51` — an adapter with
`add_scalar/add_image/add_video/add_histogram` so the Trainer can treat
tensorboard and wandb interchangeably (`Trainer.py:183-199`). Every call
is a no-op where wandb is not installed or its run does not start.
"""
from __future__ import annotations

import numpy as np


class WandbWriter:
    def __init__(self, project="animals3d_tpu", name=None, config=None,
                 **kwargs):
        try:
            import wandb
            self._wandb = wandb
            self._run = wandb.init(project=project, name=name, config=config,
                                   **kwargs)
        except Exception:
            self._wandb = None
            self._run = None

    def add_scalar(self, tag, value, step=None):
        if self._wandb:
            self._wandb.log({tag: float(value)}, step=step)

    def add_image(self, tag, img, step=None):
        if self._wandb:
            arr = np.asarray(img)
            if arr.ndim == 3 and arr.shape[0] in (1, 3, 4):
                arr = arr.transpose(1, 2, 0)
            self._wandb.log({tag: self._wandb.Image(arr)}, step=step)

    def add_video(self, tag, frames, step=None, fps=10):
        if self._wandb:
            arr = (np.clip(np.asarray(frames), 0, 1) * 255).astype(np.uint8)
            self._wandb.log({tag: self._wandb.Video(arr, fps=fps)}, step=step)

    def add_histogram(self, tag, values, step=None):
        if self._wandb:
            self._wandb.log(
                {tag: self._wandb.Histogram(np.asarray(values).ravel())},
                step=step)

    def flush(self):
        pass

    def close(self):
        if self._run:
            self._run.finish()
