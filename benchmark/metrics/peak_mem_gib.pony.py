"""`torch.cuda.max_memory_allocated` over the timed window, GiB, in a
Ponymation training cell."""
from harness import readers
from harness.entries import pony_train


def read(ctx):
    if ctx["entry"] != pony_train.ENTRY:
        return None
    return readers.peak_gib(ctx)
