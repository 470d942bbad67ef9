"""Shape probes of the reference: where `SINK` is set (a callable), the
plain lattice sweep, the rasterizer and the resolve backward hand it
their shapes and, for the rasterizer, its prep and live visits, from
which the benchmark counts each kernel's operations and bytes."""
from __future__ import annotations

SINK = None


def active() -> bool:
    return SINK is not None


def record(kind: str, **fields) -> None:
    if SINK is not None:
        SINK(kind, fields)
