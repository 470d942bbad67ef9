"""Synthetic training batches made with numpy from a seed."""
from __future__ import annotations

import numpy as np
import torch


def fake_batch(model, B: int, seed: int = 0) -> dict:
    """A batch of the training forward's contract for `model`, on its
    device: uniform random images, distance transforms and DINO features,
    and a centred square mask."""
    H = model.in_image_size
    Fr = model.num_frames
    D = model.dino_feature_dim
    r = np.random.default_rng(seed)
    mask = np.zeros((B, Fr, 1, H, H), np.float32)
    mask[:, :, :, H // 4: 3 * H // 4, H // 4: 3 * H // 4] = 1.0
    images = r.uniform(0, 1, (B, Fr, 3, H, H)).astype(np.float32)
    mask_dt = r.uniform(0, 5, (B, Fr, 2, H, H)).astype(np.float32)
    dino = r.uniform(0, 1, (B, Fr, D, H // 4, H // 4)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=model.device)
    return {
        "images": t(images),
        "masks": t(mask),
        "mask_dt": t(mask_dt),
        "mask_valid": torch.ones((B, Fr, H, H), device=model.device),
        "flows": None,
        "bboxs": torch.zeros((B, Fr, 8), device=model.device),
        "bg_images": None,
        "dino_features": t(dino),
        "dino_clusters": None,
        "seq_idx": torch.zeros((B,), dtype=torch.int32, device=model.device),
        "frame_idx": torch.zeros((B, Fr), dtype=torch.int32,
                                 device=model.device),
    }
