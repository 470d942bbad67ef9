"""The readings that decide `correct`, and the check of each against its
limit (the cell's `limits`, in its workload file).

Training: a step's losses' gap relative to the reference's; per leaf,
the gap between the program's norm and the reference's, not the norm of
their difference, over the larger of the reference's norm of that leaf
and of the median leaf, summarized over the leaves. Leaves whose reference
gradient is under a thousandth of the median leaf's (nought to rounding,
as a key's bias under softmax) are left out of the parameters' change,
which Adam moves by round-off alone.

A trained module's readings are its own median leaf's gaps, so that a
fault confined to one module (netSDF's gradient through K6/K7, say) shows
even where that module holds few of the leaves and leaves the median leaf
of all of them unmoved."""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref))


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap (of the leaves of `ref`, those in `keep`): the gap
    between the two norms over the larger of the reference's norm of the
    leaf and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    out = {}
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def summary(gaps: dict) -> dict:
    """The median leaf's gap, the 90th percentile's, the worst and its
    leaf."""
    vals = sorted(gaps.values())
    worst = max(gaps, key=gaps.get)
    return {"median": statistics.median(vals),
            "p90": vals[min(len(vals) - 1, int(0.9 * len(vals)))],
            "worst": gaps[worst], "worst_leaf": worst}


SDF = "netBase.netSDF"


def module_of(name: str) -> str:
    """The trained module of a leaf: the net nested in a top-level net
    (`netBase.netSDF`, `netInstance.netPose`), or the top-level net for
    its own leaves (`netBase` for Fauna's bank, `netDisc`)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1].startswith("net"):
        return ".".join(parts[:2])
    return parts[0]


def by_module(gaps: dict) -> dict:
    """Each module's `summary` of its leaves' gaps, with its leaf count."""
    groups = {}
    for n, g in gaps.items():
        groups.setdefault(module_of(n), {})[n] = g
    return {m: dict(summary(g), n=len(g)) for m, g in sorted(groups.items())}


def moving(ref_grad: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= NOUGHT * med}


def check(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): each reading at or under its
    limit; a reading that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
