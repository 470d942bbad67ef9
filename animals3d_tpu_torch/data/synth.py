"""Synthetic data: training batches made with numpy from a seed, and tiny
image folders in the reference's on-disk format (port of
`animals3d_tpu.data.synth`).

`write_synth_dataset` writes `<stem>rgb.jpg` + `mask.png` + `box.txt` +
`feat<D>.png` with procedurally generated blob silhouettes, so the data
pipeline and the training loop run without the real downloads; with
`sequences`, one folder per sequence of `frames` frames, each with a
16-bit RGB `flow.png` (written by `util.png_write`), and a
`background_frame.jpg` per sequence. The same seed gives the same images
and samples as the JAX package's writer.

Usage: `python -m animals3d_tpu_torch.data.synth <out_dir> [--n 8]
[--size 256] [--dino-dim 16] [--seed 0] [--sequences 0] [--frames 10]`.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def fake_batch(model, B: int, seed: int = 0) -> dict:
    """A batch of the training forward's contract for `model` (B sequences
    of the model's `num_frames` frames), on its device: uniform random
    images, distance transforms and DINO features, and a centred square
    mask; no flows."""
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


def _write_sample(stem: str, size: int, dino_dim: int, rng):
    from PIL import Image
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    cx, cy = rng.uniform(0.35, 0.65, 2)
    rx, ry = rng.uniform(0.15, 0.3, 2)
    mask = (((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) < 1.0
    color = rng.uniform(0.3, 0.9, 3)
    img = np.ones((size, size, 3), np.float32) * 0.1
    img[mask] = color + rng.normal(0, 0.05, (int(mask.sum()), 3))
    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)) \
        .save(stem + "rgb.jpg")
    Image.fromarray((mask * 255).astype(np.uint8)).save(stem + "mask.png")
    np.savetxt(stem + "box.txt",
               np.array([[0, 100, 100, 512, 512, 1920, 1080, 10.0]]), fmt="%s")
    # packed DINO features: tiles of 3 channels horizontally
    n_tiles = -(-dino_dim // 3)
    feat = rng.uniform(0, 255, (size // 4, n_tiles * (size // 4), 3)) \
        .astype(np.uint8)
    Image.fromarray(feat).save(stem + f"feat{dino_dim}.png")


def _write_background(dir_path: str, rng):
    """Shared full-frame background (crop boxes reach 100+512 px)."""
    from PIL import Image
    full = rng.uniform(0.05, 0.25, (640, 640, 3)).astype(np.float32)
    full += np.linspace(0, 0.3, 640)[None, :, None]
    Image.fromarray((np.clip(full, 0, 1) * 255).astype(np.uint8)) \
        .save(os.path.join(dir_path, "background_frame.jpg"))


def _write_flow(stem: str, size: int, rng):
    """A 16-bit RGB flow png of near-zero motion, u/v in the file's R and
    G samples: the pixels the JAX package's writer gives cv2 (in BGR
    order) for the same draws."""
    from animals3d_tpu_torch.data.util import png_write
    flow = (rng.uniform(0.48, 0.52, (size, size, 3)) * 65535) \
        .astype(np.uint16)
    png_write(stem + "flow.png", np.ascontiguousarray(flow[..., ::-1]))


def write_synth_dataset(out_dir: str, n: int = 8, size: int = 256,
                        dino_dim: int = 16, seed: int = 0,
                        sequences: int = 0, frames: int = 10):
    """An image folder of `n` samples at `size`², or with `sequences` that
    many sequence folders of `frames` frames with flows."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    if sequences:
        for s in range(sequences):
            d = os.path.join(out_dir, f"seq{s:03d}")
            os.makedirs(d, exist_ok=True)
            for f in range(frames):
                stem = os.path.join(d, f"{f:06d}_")
                _write_sample(stem, size, dino_dim, rng)
                _write_flow(stem, size, rng)
            _write_background(d, rng)
        return out_dir
    for i in range(n):
        _write_sample(os.path.join(out_dir, f"{i:06d}_"), size, dino_dim, rng)
    _write_background(out_dir, rng)
    return out_dir


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--dino-dim", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sequences", type=int, default=0)
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    write_synth_dataset(args.out_dir, args.n, args.size, args.dino_dim,
                        seed=args.seed, sequences=args.sequences,
                        frames=args.frames)
    print(f"wrote synthetic dataset to {args.out_dir}")
