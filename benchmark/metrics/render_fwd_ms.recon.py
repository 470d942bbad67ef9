"""Device ms per batch launched inside `model.render`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.stage_ms(ctx, "render_fwd")
