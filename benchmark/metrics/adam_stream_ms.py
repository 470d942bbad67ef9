"""Stream ms an iteration of the program's span `a3d.adam`: the interval
between its CUDA events on the stream, its device work and any device
idle inside it."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train", ["a3d.adam"], "stream_ms")
