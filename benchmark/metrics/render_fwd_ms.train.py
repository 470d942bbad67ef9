"""Device ms per iteration launched inside `model.render`."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.stage_ms(ctx, "render_fwd")
