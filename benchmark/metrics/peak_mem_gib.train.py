"""`torch.cuda.max_memory_allocated` over the timed window, GiB."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.peak_gib(ctx)
