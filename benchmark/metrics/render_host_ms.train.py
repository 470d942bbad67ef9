"""Host ms an iteration inside the program's span `a3d.render`
(`AnimalModel.render`, every render of the step)."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train", ["a3d.render"])
