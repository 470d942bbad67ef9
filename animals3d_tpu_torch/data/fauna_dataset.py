"""Fauna multi-category dataset with single-category batches (port of
`animals3d_tpu.data.fauna_dataset`).

Reference: `FaunaDataset` (`3DAnimals/model/dataset/FaunaDataset.py:41-330`):
  * merges `large_scale/<category>` (video frames) and `few_shot_*/<category>`
    (images) trees; any directory level whose leaves contain `*rgb.jpg`
    samples becomes a category;
  * every category is padded (cyclic repeat) to the same length
    (`_pad_paths`, `:217-246`) or split into `dataset_split_num`-sized
    pseudo-categories (`:248-293`);
  * index arithmetic guarantees each batch is single-category (`:157-161`);
  * the category label is appended as a 9th bbox column (`:174`);
  * `all_category_names` is exposed and samples reshuffle per epoch
    (`_shuffle_all`, `:210-215`).
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np

from animals3d_tpu_torch.data.image_dataset import (ImageDataset,
                                                    xflip_sample)


class FaunaDataset:
    def __init__(self, root, batch_size=6, num_frames=1, in_image_size=256,
                 out_image_size=256, load_background=False, random_xflip=False,
                 load_dino_feature=False, load_dino_cluster=False,
                 dino_feature_dim=64,
                 dataset_split_num=-1, shuffle=True, **_):
        self.batch_size = batch_size
        self.in_image_size = in_image_size
        self.out_image_size = out_image_size
        self.random_xflip = random_xflip
        self.load_dino_feature = load_dino_feature
        self.dino_feature_dim = dino_feature_dim
        self.data_type = "fauna"
        self.num_frames = num_frames
        self.shuffle = shuffle

        self.categories = self._parse_categories(root)
        self.all_category_names = sorted(self.categories.keys())
        if dataset_split_num > 0:
            split = {}
            for name in self.all_category_names:
                stems = self.categories[name]
                for i in range(0, len(stems), dataset_split_num):
                    split[f"{name}_{i // dataset_split_num}"] = \
                        stems[i:i + dataset_split_num]
            self.categories = split
            self.all_category_names = sorted(split.keys())

        self._pad_len = max((len(v) for v in self.categories.values()),
                            default=0)
        self._pad_len = -(-self._pad_len // batch_size) * batch_size
        self._epoch = -1
        self.set_epoch(0)

        self._image_ds = ImageDataset.__new__(ImageDataset)
        self._image_ds.in_image_size = in_image_size
        self._image_ds.out_image_size = out_image_size
        self._image_ds.load_dino_feature = load_dino_feature
        self._image_ds.load_dino_cluster = load_dino_cluster
        self._image_ds.dino_feature_dim = dino_feature_dim
        self._image_ds.load_background = load_background
        self._image_ds.random_xflip = False
        self._image_ds.samples = []

    @staticmethod
    def _collect_stems(path):
        stems = sorted(glob(os.path.join(path, "**/*rgb.jpg"), recursive=True))
        return [p[:-len("rgb.jpg")] for p in stems]

    @staticmethod
    def _more_back_views(back_stems, stems):
        """Oversample back-view images to ~4/5 of the category size.

        Reference `FaunaDataset._more_back_views`
        (`3DAnimals/model/dataset/FaunaDataset.py:313-323`): the back
        views are cyclically repeated to `(len(seq)//5)*4` entries and
        prepended, so categories with a `<root>_back` sibling tree see
        roughly 4 back views for every 5 regular images.
        """
        if not back_stems:
            return []
        factor = 5
        length = (len(stems) // factor) * (factor - 1)
        mul_f = length // len(back_stems)
        pad_f = length % len(back_stems)
        return mul_f * back_stems + back_stems[:pad_f]

    @classmethod
    def _parse_categories(cls, root):
        categories = {}
        roots = []
        for sub in sorted(glob(os.path.join(root, "*"))):
            if os.path.isdir(sub):
                base = os.path.basename(sub)
                if base.startswith("large_scale") or base.startswith("few_shot"):
                    roots.append(sub)
        if not roots:
            roots = [root]
        for r in roots:
            # `few_shot_*_back` trees are oversampling sources for the
            # sibling root, not categories themselves
            # (`FaunaDataset.py:62-66,103-110`).
            if os.path.basename(r).endswith("_back"):
                continue
            for cat_dir in sorted(glob(os.path.join(r, "*"))):
                if not os.path.isdir(cat_dir):
                    continue
                stems = cls._collect_stems(cat_dir)
                if not stems:
                    continue
                name = os.path.basename(cat_dir)
                back_dir = os.path.join(r + "_back", name)
                if os.path.isdir(back_dir):
                    back = cls._collect_stems(back_dir)
                    stems = cls._more_back_views(back, stems) + stems
                categories.setdefault(name, []).extend(stems)
        return categories

    def set_epoch(self, epoch):
        """Cyclic-pad every category to the common length and (re)shuffle
        within categories (`_shuffle_all`)."""
        if epoch == self._epoch:
            return
        self._epoch = epoch
        rng = np.random.default_rng(epoch)
        self._padded = {}
        for name in self.all_category_names:
            stems = list(self.categories[name])
            if self.shuffle:
                rng.shuffle(stems)
            reps = -(-self._pad_len // len(stems))
            self._padded[name] = (stems * reps)[:self._pad_len]

    def __len__(self):
        return self._pad_len * len(self.all_category_names)

    def __getitem__(self, index):
        n_cat = len(self.all_category_names)
        block = index // self.batch_size
        within = index % self.batch_size
        cat_idx = block % n_cat
        cat_block = block // n_cat
        name = self.all_category_names[cat_idx]
        stems = self._padded[name]
        stem = stems[(cat_block * self.batch_size + within) % len(stems)]

        sample = self._image_ds.load_stem(stem)   # thread-safe: stateless
        # append category label as a 9th bbox column (`FaunaDataset.py:174`)
        label = np.full((*sample["bboxs"].shape[:-1], 1), cat_idx, np.float32)
        sample["bboxs"] = np.concatenate([sample["bboxs"], label], -1)
        sample["seq_idx"] = np.int32(cat_idx)
        if self.random_xflip and np.random.rand() < 0.5:
            sample = xflip_sample(sample)
        return sample
