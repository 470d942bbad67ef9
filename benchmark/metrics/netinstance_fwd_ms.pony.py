"""Device ms per iteration launched inside `model.instance_forward` (the
range `bench.netinstance_fwd`), in a Ponymation training cell."""
from harness import readers
from harness.entries import pony_train


def read(ctx):
    if ctx["entry"] != pony_train.ENTRY:
        return None
    return readers.stage_ms(ctx, "netinstance_fwd")
