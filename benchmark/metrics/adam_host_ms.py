"""Host ms an iteration inside the program's span `a3d.adam` (the
generator's Adam steps and `zero_grad` in `train_step`)."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train", ["a3d.adam"])
