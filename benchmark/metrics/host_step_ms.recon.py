"""Host ms a batch inside the program's span `a3d.reconstruct`."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "recon", ["a3d.reconstruct"])
