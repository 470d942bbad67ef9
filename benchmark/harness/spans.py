"""Per-iteration readings of the program's own spans and counters
(`animals3d_tpu_torch.tracing`). The traced window is a `torch.profiler`
session, which turns the program's tracer on for that window alone, so
the tracer's snapshot, taken once after the window (`ctx["program_trace"]`),
holds the window's spans: per name, calls, host ms (`time.time_ns` inside
the span) and stream ms (its CUDA-event interval); and its counters. A
reading is divided by the iterations, the calls of the window's root span
(`a3d.train_step` or `a3d.reconstruct`). A program without the tracer, or
a snapshot without what a reading needs, gives None."""
from __future__ import annotations

ROOT = {"train": "a3d.train_step", "recon": "a3d.reconstruct"}


def snapshot(ctx):
    """The program's snapshot, taken at the first reading and kept in
    `ctx`; None where the program has no tracer."""
    if "program_trace" not in ctx:
        try:
            from animals3d_tpu_torch import tracing
        except ImportError:
            ctx["program_trace"] = None
        else:
            ctx["program_trace"] = tracing.snapshot()
    return ctx["program_trace"]


def _iterations(ctx, entry):
    if ctx.get("entry") != entry:
        return None, None
    snap = snapshot(ctx)
    if not snap:
        return None, None
    n = snap["spans"].get(ROOT[entry], {}).get("calls")
    return (snap, n) if n else (None, None)


def per_iteration(ctx, entry, names, field="host_ms"):
    """The sum over `names` of each span's `field` (host_ms or stream_ms),
    per iteration of `entry` ("train" or "recon"); None where the first
    name has no such reading."""
    snap, n = _iterations(ctx, entry)
    if snap is None:
        return None
    spans = snap["spans"]
    if spans.get(names[0], {}).get(field) is None:
        return None
    return sum(spans[s][field] or 0.0 for s in names if s in spans) / n


def ratio_pct(ctx, entry, num, den, complement=False):
    """100 · counter `num` / counter `den` (or 100 · (den - num) / den with
    `complement`) over the window of `entry`, 0 where `den` counted
    nothing (no silhouette pair found, none dropped); None without the
    counters."""
    snap, _n = _iterations(ctx, entry)
    if snap is None:
        return None
    c = snap["counters"]
    if den not in c or num not in c:
        return None
    if not c[den]:
        return 0.0
    part = c[den] - c[num] if complement else c[num]
    return 100.0 * part / c[den]
