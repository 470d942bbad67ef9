"""The reconstruction's model FLOPs per second over the dense bf16 peak."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.mfu_pct(ctx)
