"""N-frame video sequence dataset (port of
`animals3d_tpu.data.sequence_dataset`).

Reference: `NFrameSequenceDataset` (`reference model/dataset/
SequenceDataset.py:68-171`): per-video folders of frames
(`<stem>rgb.*`, `mask.png`, `box.txt`, `feat<D>.png`, `flow.png`); dense
(every start frame) or random N-frame windows; 16-bit flow PNGs in
[-1, 1] (`util.flow_loader`); a per-sequence `background_frame.jpg`
cropped to each frame's box; short clips front-padded with their first
frame, with zero flow.
"""
from __future__ import annotations

import os
import random
from glob import glob

import numpy as np

from animals3d_tpu_torch.data import util


class NFrameSequenceDataset:
    def __init__(self, root, num_frames=2, skip_beginning=4, skip_end=4,
                 min_seq_len=10, in_image_size=256, out_image_size=256,
                 random_sample=False, dense_sample=True, shuffle=False,
                 load_flow=False, load_background=False, random_xflip=False,
                 load_dino_feature=False, dino_feature_dim=64):
        seq_dirs = sorted([d for d in glob(os.path.join(root, "*"))
                           if os.path.isdir(d)])
        self.sequences = []
        for d in seq_dirs:
            frames = sorted(glob(os.path.join(d, "*rgb.*")))
            frames = [p[:p.rfind("rgb.")] for p in frames]
            if skip_beginning or skip_end:
                frames = frames[skip_beginning:
                                len(frames) - skip_end if skip_end else None]
            if len(frames) >= min_seq_len:
                self.sequences.append(frames)

        self.num_frames = num_frames
        self.random_sample = random_sample
        if random_sample:
            self.samples = list(range(len(self.sequences)))
        else:
            stride = 1 if dense_sample else num_frames
            self.samples = [(i, k) for i, s in enumerate(self.sequences)
                            for k in range(0, len(s), stride)]
        if shuffle:
            random.shuffle(self.samples)

        self.in_image_size = in_image_size
        self.out_image_size = out_image_size
        self.load_flow = load_flow and num_frames > 1
        self.load_background = load_background
        self.load_dino_feature = load_dino_feature
        self.dino_feature_dim = dino_feature_dim
        self.random_xflip = random_xflip
        self.data_type = "sequence"

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        if self.random_sample:
            seq_idx = self.samples[index % len(self.samples)]
            seq = self.sequences[seq_idx]
            start = 0 if len(seq) < self.num_frames else \
                np.random.randint(len(seq) - self.num_frames + 1)
        else:
            seq_idx, start = self.samples[index % len(self.samples)]
            seq = self.sequences[seq_idx]
            if len(seq) <= start + 1:
                start = max(0, start - 1)
        stems = seq[start:start + self.num_frames]
        size = self.out_image_size
        n = len(stems)

        def find(stem, suffix):
            cands = glob(stem + suffix)
            return cands[0] if cands else stem + suffix

        images = np.stack([util.load_image(find(s, "rgb.*"), size)
                           for s in stems])
        masks = np.stack([util.load_image(s + "mask.png", size, mode="L",
                                          resample="nearest")
                          for s in stems])
        mask_dt = np.stack([util.compute_distance_transform(m) for m in masks])
        boxes = np.stack([util.box_loader(s + "box.txt") for s in stems])
        mask_valid = np.stack([util.get_valid_mask(b, size) for b in boxes])

        flows = None
        if self.load_flow and n > 1:
            flows = np.stack([_load_flow_resized(s + "flow.png", size)
                              for s in stems[:-1]])
        dino = None
        if self.load_dino_feature:
            dino = np.stack([
                util.dino_loader(s + f"feat{self.dino_feature_dim}.png",
                                 self.dino_feature_dim) for s in stems])
        bg = None
        if self.load_background:
            bg_path = os.path.join(os.path.dirname(stems[0]),
                                   "background_frame.jpg")
            bg = util.crop_image(bg_path, boxes[:, 1:5], size)

        sample = {
            "images": images, "masks": masks, "mask_dt": mask_dt,
            "mask_valid": mask_valid, "flows": flows, "bboxs": boxes,
            "bg_images": bg, "dino_features": dino, "dino_clusters": None,
            "seq_idx": np.int32(seq_idx),
            "frame_idx": np.arange(start, start + n, dtype=np.int32),
        }
        if self.random_xflip and np.random.rand() < 0.5:
            from animals3d_tpu_torch.data.image_dataset import xflip_sample
            sample = xflip_sample(sample)

        if n < self.num_frames:
            pad = self.num_frames - n

            def pad_front(x, zero_first=False):
                if x is None:
                    return None
                out = np.concatenate([x[:1]] * pad + [x], 0)
                if zero_first:
                    out[:pad] = 0
                return out
            for k in ("images", "masks", "mask_dt", "mask_valid", "bboxs",
                      "bg_images", "dino_features"):
                if sample[k] is not None:
                    sample[k] = pad_front(sample[k])
            if sample["flows"] is not None:
                sample["flows"] = pad_front(sample["flows"], zero_first=True)
            sample["frame_idx"] = pad_front(sample["frame_idx"])
        return sample


def _load_flow_resized(path, size):
    """(2, size, size) float32: the flow PNG, each channel resized
    bilinearly by PIL where its size differs."""
    flow = util.flow_loader(path)                 # (2, H, W)
    if flow.shape[1] != size:
        from PIL import Image
        flow = np.stack([np.asarray(Image.fromarray(c).resize(
            (size, size), Image.BILINEAR)) for c in flow])
    return flow.astype(np.float32)
