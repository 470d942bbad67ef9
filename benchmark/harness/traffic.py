"""The traffic: a pool of distinct training batches (or image batches
for reconstruction) made on the device from the seed, in a few large
draws.

Frozen copy of `fake_batch` of `animals3d_tpu_torch/data/synth.py`: uniform
random images in [0, 1], distance transforms in [0, 5], DINO features in
[0, 1] at a quarter of the image size, and a centred square mask, with no
flows. The copy draws with `torch.rand` on the device instead of numpy on
the host, all batches of the pool at once; the sizes and distributions
are the original's. A workload's file gives the pool's size and batch.
"""
from __future__ import annotations

import torch


def pool(n: int, batch: int, image_size: int, frames: int, dino_dim: int,
         seed: int, device, mask_box=(0.25, 0.75)) -> list:
    """`n` training batches of `batch` sequences of `frames` frames at
    `image_size`², every image of the pool distinct."""
    H, B, Fr = image_size, batch, frames
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def draw(*shape, scale=1.0):
        return torch.rand((n, *shape), generator=gen, device=device) * scale

    images = draw(B, Fr, 3, H, H)
    mask_dt = draw(B, Fr, 2, H, H, scale=5.0)
    dino = draw(B, Fr, dino_dim, H // 4, H // 4)
    lo, hi = int(H * mask_box[0]), int(H * mask_box[1])
    mask = torch.zeros((B, Fr, 1, H, H), device=device)
    mask[:, :, :, lo:hi, lo:hi] = 1.0
    out = []
    for i in range(n):
        out.append({
            "images": images[i],
            "masks": mask,
            "mask_dt": mask_dt[i],
            "mask_valid": torch.ones((B, Fr, H, H), device=device),
            "flows": None,
            "bboxs": torch.zeros((B, Fr, 8), device=device),
            "bg_images": None,
            "dino_features": dino[i],
            "dino_clusters": None,
            "seq_idx": torch.zeros((B,), dtype=torch.int32, device=device),
            "frame_idx": torch.zeros((B, Fr), dtype=torch.int32,
                                     device=device),
        })
    return out


def image_pool(n: int, batch: int, image_size: int, frames: int, seed: int,
               device) -> list:
    """`n` distinct image batches (batch, frames, 3, H, H) in [0, 1], the
    images of `pool` alone."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    images = torch.rand((n, batch, frames, 3, image_size, image_size),
                        generator=gen, device=device)
    return list(images.unbind(0))
