"""The Ponymation iteration's model FLOPs per second over the dense bf16
peak, as `mfu.train` reads a training iteration's, so that shares compare
across cells (`harness.readers.mfu_pct`)."""
from harness import readers
from harness.entries import pony_train


def read(ctx):
    if ctx["entry"] != pony_train.ENTRY:
        return None
    return readers.mfu_pct(ctx)
