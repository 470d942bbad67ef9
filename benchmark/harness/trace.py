"""The traced window: stage ranges around the model's bound methods,
`torch.profiler` over a few iterations, and the reduction of its trace to
what the per-layer readers read.

Device busy time is the union of the device's operation intervals
(kernels, copies, sets): a frozen copy of `chip_smoke.py`'s
`device_busy_ms` and of `report` in `scripts/torch_recon_profile.py`.
A kernel's time counts toward a stage range when the host call that
launched it lies inside the range, on the same thread; no synchronize is
added anywhere.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

# the model's bound methods that a stage range wraps, by range name
STAGES = {"netbase_fwd": "forward_base", "netinstance_fwd": "instance_forward",
          "render_fwd": "render"}
PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@contextlib.contextmanager
def stage_ranges(model):
    """Wrap the stage methods of this model instance in ranges named
    `bench.<stage>` for the block's duration."""
    from torch.profiler import record_function
    for label, attr in STAGES.items():
        inner = getattr(model, attr)

        def wrapped(*args, _inner=inner, _name=PREFIX + label, **kwargs):
            with record_function(_name):
                return _inner(*args, **kwargs)
        setattr(model, attr, wrapped)
    try:
        yield
    finally:
        for attr in STAGES.values():
            model.__dict__.pop(attr, None)


def rng(name: str):
    """A range of the benchmark's own, `bench.<name>`."""
    from torch.profiler import record_function
    return record_function(PREFIX + name)


def profile(fn) -> dict:
    """Run `fn()` under `torch.profiler` (host and device), synchronize,
    and reduce the trace (`reduce`); adds the host clock's `window_s`."""
    from torch.profiler import ProfilerActivity, profile as _profile
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out = reduce(events)
    out["window_s"] = window
    return out


def union(spans) -> tuple:
    """(busy seconds, merged intervals) of (start, end) pairs in µs."""
    busy, merged = 0.0, []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                busy += e - merged[-1][1]
                merged[-1][1] = e
            continue
        merged.append([s, e])
        busy += e - s
    return busy / 1e6, merged


def reduce(events: list) -> dict:
    """From a chrome trace's events: `busy_s`, the device operations by
    name {name: [count, seconds]}, each `bench.*` range's device seconds
    {range: seconds} and its call count, the top device operations and
    the longest idle gaps, each labelled by the innermost host operation
    running at the gap's middle on the thread that launched work."""
    dev, launches, host = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat in ("cpu_op", "user_annotation"):
            host.append(e)
    busy_s, merged = union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev)
    ops = {}
    for e in dev:
        c = ops.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += float(e["dur"]) / 1e6
    ranges = [e for e in host if e["name"].startswith(PREFIX)]
    stage_s, calls = {}, {}
    for r in ranges:
        key = r["name"][len(PREFIX):]
        calls[key] = calls.get(key, 0) + 1
        stage_s.setdefault(key, 0.0)
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r["tid"], []).append(
            (float(r["ts"]), float(r["ts"]) + float(r["dur"]),
             r["name"][len(PREFIX):]))
    launch_tids = {}
    for e in dev:
        la = launches.get((e.get("args") or {}).get("correlation"))
        if la is None:
            continue
        t = float(la["ts"])
        launch_tids[la["tid"]] = launch_tids.get(la["tid"], 0) + 1
        for s, end, key in by_tid.get(la["tid"], ()):
            if s <= t <= end:
                stage_s[key] += float(e["dur"]) / 1e6
    main_tid = max(launch_tids, key=launch_tids.get) if launch_tids else None
    gaps = []
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    host_main = sorted(((float(h["ts"]), float(h["ts"]) + float(h["dur"]),
                         h["name"]) for h in host if h["tid"] == main_tid))
    idle = []
    for dur, s, e in gaps[:TOP]:
        mid = (s + e) / 2
        cover = [h for h in host_main if h[0] <= mid <= h[1]]
        label = min(cover, key=lambda h: h[1] - h[0])[2] if cover \
            else "host outside any operation"
        idle.append([label, dur / 1e6])
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {"busy_s": busy_s, "ops": ops, "stage_s": stage_s,
            "stage_calls": calls,
            "breakdown": {"device_ops": [[n[:160], c[1]] for n, c in top],
                          "idle_gaps": idle}}


def kernel_time(ctx: dict, *patterns) -> tuple:
    """(launch count of the first pattern, total seconds of all) of the
    device operations whose name contains any of `patterns`."""
    count, secs = 0, 0.0
    for name, (n, s) in ctx["ops"].items():
        if any(p in name for p in patterns):
            secs += s
            if patterns[0] in name:
                count += n
    return count, secs
