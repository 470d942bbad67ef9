"""Device ms per iteration launched inside the discriminator's step."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.stage_ms(ctx, "disc_step")
