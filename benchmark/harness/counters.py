"""Shares of the program's own counters (`animals3d_tpu_torch.tracing`)
over the traced window, beside `spans.ratio_pct`."""
from __future__ import annotations

from harness import spans


def share_pct(ctx, entry, part, names):
    """100 · counter `part` / the sum of the counters `names` over the
    window of `entry` ("train" or "recon"); None where the program counts
    none of them (a program without them) or they sum to 0."""
    if ctx.get("entry") != entry:
        return None
    snap = spans.snapshot(ctx)
    if not snap:
        return None
    c = snap["counters"]
    if not any(n in c for n in names):
        return None
    total = sum(c.get(n, 0) for n in names)
    return 100.0 * c.get(part, 0) / total if total else None
