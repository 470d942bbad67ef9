"""The share of the traced window in which no device operation ran
(`harness.readers.idle_pct`), in a Ponymation training cell."""
from harness import readers
from harness.entries import pony_train


def read(ctx):
    if ctx["entry"] != pony_train.ENTRY:
        return None
    return readers.idle_pct(ctx)
