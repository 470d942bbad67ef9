"""Host ms an iteration inside the program's spans `a3d.train_step` and
`a3d.disc_step` (`harness.spans`)."""
from harness import spans


def read(ctx):
    return spans.per_iteration(ctx, "train",
                               ["a3d.train_step", "a3d.disc_step"])
