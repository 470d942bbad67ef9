"""Training meters and metric history (port of `animals3d_tpu.utils.meters`).

Reference: `reference model/utils/meters.py` (TotalAverage,
MovingAverage, MetricsTrace `:48-82`, StandardMetrics speed meter `:98-129`).
"""
from __future__ import annotations

import json
import time


class TotalAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.mass = 0.0

    def update(self, value, mass=1.0):
        self.sum += float(value) * mass
        self.mass += mass

    def get(self):
        return self.sum / self.mass if self.mass else 0.0


class MovingAverage:
    def __init__(self, inertia=0.9):
        self.inertia = inertia
        self.reset()

    def reset(self):
        self.avg = None

    def update(self, value, mass=1.0):
        value = float(value)
        self.avg = value if self.avg is None else \
            self.inertia * self.avg + (1 - self.inertia) * value

    def get(self):
        return self.avg if self.avg is not None else 0.0


class StandardMetrics:
    """Per-iteration metric dict + an images/sec speed meter: the images
    counted by `add_images` since the previous update over the time since
    then, so that a loop that logs every n iterations reads its rate."""

    def __init__(self):
        self.meters = {}
        self.speed = MovingAverage(inertia=0.9)
        self._last_time = None
        self._images = 0

    def add_images(self, n: int):
        self._images += n

    def update(self, metrics: dict, batch_size: int = 1):
        now = time.time()
        if self._last_time is not None:
            dt = max(now - self._last_time, 1e-9)
            self.speed.update(self._images / dt)
        self._last_time = now
        self._images = 0
        for k, v in metrics.items():
            self.meters.setdefault(k, TotalAverage()).update(v, batch_size)

    def get_data_dict(self):
        d = {k: m.get() for k, m in self.meters.items()}
        d["speed"] = self.speed.get()
        return d

    def __str__(self):
        parts = [f"{k}={v:.4f}" for k, v in self.get_data_dict().items()]
        return " ".join(parts)


class MetricsTrace:
    """Per-epoch metric history persisted as JSON (`meters.py:48-82`)."""

    def __init__(self):
        self.data = {}

    def push(self, epoch, split, metrics_dict):
        self.data.setdefault(split, []).append(
            {"epoch": epoch, **metrics_dict})

    def save(self, path):
        with open(path, "w") as f:
            json.dump(self.data, f, indent=2)

    def load(self, path):
        with open(path) as f:
            self.data = json.load(f)
