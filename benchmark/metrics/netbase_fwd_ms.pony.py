"""Device ms per iteration launched inside `model.forward_base` (the range
`bench.netbase_fwd`: the frozen netSDF's float32 sweep and marching
tets), in a Ponymation training cell."""
from harness import readers
from harness.entries import pony_train


def read(ctx):
    if ctx["entry"] != pony_train.ENTRY:
        return None
    return readers.stage_ms(ctx, "netbase_fwd")
