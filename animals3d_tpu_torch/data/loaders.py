"""Data loader facade: dataset construction, batching and threaded
prefetch (port of `animals3d_tpu.data.loaders`).

Reference: `get_data_loaders` (`reference model/dataloaders.py:34-131`).
A thread pool decodes samples (PIL and the native library release the GIL)
and a prefetch queue keeps batches ahead of the device. The index stream
is the JAX package's: each epoch shuffles with numpy
`default_rng(seed + epoch)`, the train stream drops the last partial batch
and never ends, so one folder gives the same batches in the same order in
both packages. A dataset with `set_epoch` (Fauna's) is told each epoch
before its indices are drawn, as the JAX loader does. Batches are numpy;
the `Trainer` moves them to the model's device. One host; sharding the
stream over hosts is not ported.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    data_type: str = "image"               # image | sequence | fauna
    batch_size: int = 64
    num_workers: int = 4
    in_image_size: int = 256
    out_image_size: int = 256
    train_data_dir: Optional[str] = None
    val_data_dir: Optional[str] = None
    test_data_dir: Optional[str] = None
    random_shuffle_samples_train: bool = False
    random_xflip_train: bool = False
    load_flow: bool = False
    load_background: bool = False
    load_dino_feature: bool = False
    load_dino_cluster: bool = False
    dino_feature_dim: int = 64
    background_mode: str = "none"
    num_frames: int = 1
    # sequence extras
    skip_beginning: int = 4
    skip_end: int = 4
    min_seq_len: int = 10
    random_sample_train_frames: bool = False
    # Fauna's pseudo-category split (`Trainer.remake_dataloader_iter`)
    dataset_split_num: int = -1


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts; None fields stay None (their presence is
    config-static, unlike the reference's NaN trick, `util.py:114-115`)."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = None if vals[0] is None else np.stack(vals)
    return out


class Loader:
    """Iterable over collated batches with background decode + prefetch."""

    def __init__(self, dataset, batch_size, shuffle=False, num_workers=4,
                 drop_last=True, prefetch=3, seed=0, infinite=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.infinite = infinite
        self._epoch = 0
        if len(dataset) == 0:
            raise ValueError(
                f"empty dataset {type(dataset).__name__}: check data_dir")

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            -(-n // self.batch_size)

    def _index_stream(self):
        n = len(self.dataset)
        while True:
            # the per-epoch dataset-side reshuffle (Fauna `_shuffle_all`,
            # reference `Trainer.py:224-225`)
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(self._epoch)
            order = np.arange(n)
            if self.shuffle:
                rng = np.random.default_rng(self.seed + self._epoch)
                rng.shuffle(order)
            yield from order.tolist()
            self._epoch += 1
            if not self.infinite:
                return

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        closed = threading.Event()    # the consumer went away

        def put(item):
            while not closed.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # any exception must reach the consumer: a producer that dies
            # silently leaves the training loop blocked on q.get() forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    batch_idx = []
                    for idx in self._index_stream():
                        batch_idx.append(idx)
                        if len(batch_idx) == self.batch_size:
                            samples = list(pool.map(self.dataset.__getitem__,
                                                    batch_idx))
                            if not put(collate(samples)):
                                return
                            batch_idx = []
                    if batch_idx and not self.drop_last:
                        samples = list(pool.map(self.dataset.__getitem__,
                                                batch_idx))
                        put(collate(samples))
            except Exception as e:                     # noqa: BLE001
                put(e)
            finally:
                put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            closed.set()


def _build_dataset(cfg: DataLoaderConfig, data_dir: str, is_train: bool):
    common = dict(in_image_size=cfg.in_image_size,
                  out_image_size=cfg.out_image_size,
                  load_background=cfg.background_mode == "background",
                  random_xflip=cfg.random_xflip_train and is_train,
                  load_dino_feature=cfg.load_dino_feature,
                  dino_feature_dim=cfg.dino_feature_dim)
    if cfg.data_type == "image":
        from animals3d_tpu_torch.data.image_dataset import ImageDataset
        return ImageDataset(data_dir, load_dino_cluster=cfg.load_dino_cluster,
                            **common)
    if cfg.data_type == "sequence":
        from animals3d_tpu_torch.data.sequence_dataset import \
            NFrameSequenceDataset
        return NFrameSequenceDataset(
            data_dir, num_frames=cfg.num_frames,
            skip_beginning=cfg.skip_beginning, skip_end=cfg.skip_end,
            min_seq_len=cfg.min_seq_len, load_flow=cfg.load_flow,
            random_sample=cfg.random_sample_train_frames and is_train,
            **common)
    if cfg.data_type == "fauna":
        from animals3d_tpu_torch.data.fauna_dataset import FaunaDataset
        return FaunaDataset(data_dir, batch_size=cfg.batch_size,
                            num_frames=cfg.num_frames,
                            load_dino_cluster=cfg.load_dino_cluster,
                            dataset_split_num=cfg.dataset_split_num, **common)
    raise NotImplementedError(f"data_type {cfg.data_type!r}")


def get_data_loaders(cfg: DataLoaderConfig):
    """→ (train, val, test) Loaders (None where no dir is configured)."""
    loaders = []
    for data_dir, is_train in ((cfg.train_data_dir, True),
                               (cfg.val_data_dir, False),
                               (cfg.test_data_dir, False)):
        if data_dir is None:
            loaders.append(None)
            continue
        ds = _build_dataset(cfg, data_dir, is_train)
        if len(ds) == 0 and not is_train:
            # run configs name val_data_dir paths that may not exist here;
            # an empty val/test set is skipped, an empty train set raises
            print(f"warning: empty dataset at {data_dir}: loader skipped")
            loaders.append(None)
            continue
        loaders.append(Loader(
            ds, cfg.batch_size,
            shuffle=is_train and cfg.random_shuffle_samples_train,
            num_workers=cfg.num_workers, drop_last=is_train,
            infinite=is_train))
    return tuple(loaders)
