"""Device ms per batch launched inside `model.instance_forward`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.stage_ms(ctx, "netinstance_fwd")
