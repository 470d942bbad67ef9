"""Host ms an iteration inside the program's span `a3d.netinstance`
(netInstance's forward, at its call site in `AnimalModel.forward`)."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train", ["a3d.netinstance"])
