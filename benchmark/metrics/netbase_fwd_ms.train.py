"""Device ms per iteration launched inside `model.forward_base`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.stage_ms(ctx, "netbase_fwd")
