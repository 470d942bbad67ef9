"""Host ms an iteration inside the program's span `a3d.backward` (the
generator's `loss.backward()` in `train_step`)."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train", ["a3d.backward"])
