"""Arithmetic the per-layer readers share. A reader gets one context:
`entry` ("train" or "recon"), `trace` (the traced window's reduction,
`harness.trace.reduce`, with `steps` and `window_s`), `window` (the timed
window's steps, seconds and peak bytes), `flops` (the model FLOPs of one
iteration, counted over the reference at the cell's shapes) and `bounds`
(each kernel's least time per launch, ms). A reader that finds nothing
to read returns None, and the metric is left out of the line."""
from __future__ import annotations

from harness.peaks import BF16_PEAK_FLOPS
from harness.trace import kernel_time


def idle_pct(ctx):
    """The share of the traced window in which no device operation ran:
    one less the union of the trace's device intervals over the window's
    length, both of the one traced window (`busy_s` and `window_s` of the
    line's `device`). It counts the profiler's own host overhead, which
    stretches a host-bound iteration; the trace's `idle_gaps` show it."""
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def peak_gib(ctx):
    w = ctx.get("window")
    return None if not w else w["peak_bytes"] / 2 ** 30


def mfu_pct(ctx):
    """The iteration's model FLOPs per second of the timed window over the
    dense bf16 peak."""
    w, flops = ctx.get("window"), ctx.get("flops")
    if not w or not flops:
        return None
    return 100.0 * flops * w["steps"] / w["seconds"] / BF16_PEAK_FLOPS


def stage_ms(ctx, stage):
    """Device ms per iteration under the range `bench.<stage>`."""
    t = ctx.get("trace")
    if not t or not t["stage_calls"].get(stage):
        return None
    return t["stage_s"][stage] / t["steps"] * 1e3


def roofline_pct(ctx, bound_key, *patterns):
    """The kernel's least time per launch (`bounds[bound_key]`) over its
    device time per launch, the launches counted by `patterns[0]` and the
    time summed over every pattern's operations."""
    t, b = ctx.get("trace"), (ctx.get("bounds") or {}).get(bound_key)
    if not t or not b:
        return None
    count, secs = kernel_time(t, *patterns)
    if not count or secs <= 0:
        return None
    return 100.0 * b / (secs / count * 1e3)
