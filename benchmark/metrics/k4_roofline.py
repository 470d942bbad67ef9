"""K4, the resolve backward's scatter-add (`csrc/resolve_bwd.cu`): its bound
over its device time per launch."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.roofline_pct(ctx, "k4", "resolve_bwd_kernel")
