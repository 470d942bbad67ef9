"""The share of the traced window in which no device operation ran
(`harness.readers.idle_pct`)."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.idle_pct(ctx)
