"""Single-image dataset (port of `animals3d_tpu.data.image_dataset`).

Reference: `ImageDataset` (`reference model/dataset/ImageDataset.py:12-90`).
Folder glob of `*rgb.jpg` with siblings `mask.png` / `box.txt` /
`feat<D>.png`. Each sample is a dict of numpy arrays with F=1; the
`Trainer` moves batches to the model's device.
"""
from __future__ import annotations

import os
import random
from glob import glob

import numpy as np

from animals3d_tpu_torch.data import util


class ImageDataset:
    def __init__(self, root, in_image_size=256, out_image_size=256,
                 shuffle=False, load_background=False, random_xflip=False,
                 load_dino_feature=False, load_dino_cluster=False,
                 dino_feature_dim=64):
        self.samples = sorted(
            glob(os.path.join(root, "**/*rgb.jpg"), recursive=True))
        self.samples = [p[:-len("rgb.jpg")] for p in self.samples]
        if shuffle:
            random.shuffle(self.samples)
        self.in_image_size = in_image_size
        self.out_image_size = out_image_size
        self.load_dino_feature = load_dino_feature
        self.load_dino_cluster = load_dino_cluster
        self.dino_feature_dim = dino_feature_dim
        self.load_background = load_background
        self.random_xflip = random_xflip
        self.data_type = "image"
        self.num_frames = 1

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        stem = self.samples[index % len(self.samples)]
        sample = self.load_stem(stem, index)
        if self.random_xflip and np.random.rand() < 0.5:
            sample = xflip_sample(sample)
        return sample

    def load_stem(self, stem, index=0):
        size = self.out_image_size
        image = util.load_image(stem + "rgb.jpg", size)                # (3,H,W)
        mask = util.load_image(stem + "mask.png", size, mode="L",
                               resample="nearest")                     # (1,H,W)
        mask_dt = util.compute_distance_transform(mask)
        box = util.box_loader(stem + "box.txt")
        mask_valid = util.get_valid_mask(box, size)

        dino = None
        if self.load_dino_feature:
            dino = util.dino_loader(stem + f"feat{self.dino_feature_dim}.png",
                                    self.dino_feature_dim)
        clusters = None
        if self.load_dino_cluster and os.path.isfile(stem + "clusters.png"):
            # RGB cluster visualization, logging only
            # (`ImageDataset.py:31-32`, `AnimalModel.py:535`)
            clusters = util.load_image(stem + "clusters.png", size)

        bg = None
        if self.load_background:
            # shared full-frame background cropped to this sample's box
            # (`ImageDataset.py:65-69`)
            bg_path = os.path.join(os.path.dirname(stem),
                                   "background_frame.jpg")
            bg = util.crop_image(bg_path, box[None, 1:5], size)[0]

        return {
            "images": image[None],            # (F=1, 3, H, W)
            "masks": mask[None],
            "mask_dt": mask_dt[None],
            "mask_valid": mask_valid[None],
            "flows": None,
            "bboxs": box[None],
            "bg_images": None if bg is None else bg[None],
            "dino_features": None if dino is None else dino[None],
            "dino_clusters": None if clusters is None else clusters[None],
            "seq_idx": np.int32(index),
            "frame_idx": np.zeros((1,), np.int32),
        }


def xflip_sample(sample):
    out = dict(sample)
    for k in ("images", "masks", "mask_dt", "mask_valid", "flows",
              "bg_images", "dino_features", "dino_clusters"):
        if out.get(k) is not None:
            out[k] = np.ascontiguousarray(out[k][..., ::-1])
    if out.get("flows") is not None:
        f = out["flows"].copy()
        f[:, 0] *= -1
        out["flows"] = f
    out["bboxs"] = util.horizontal_flip_box(sample["bboxs"])
    return out
