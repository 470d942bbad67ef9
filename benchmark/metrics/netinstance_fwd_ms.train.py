"""Device ms per iteration launched inside `model.instance_forward`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.stage_ms(ctx, "netinstance_fwd")
