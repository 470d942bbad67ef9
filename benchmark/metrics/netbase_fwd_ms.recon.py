"""Device ms per batch launched inside `model.forward_base`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.stage_ms(ctx, "netbase_fwd")
