"""Stream ms an iteration of the program's span `a3d.skinning`: the
skinning of every frame's mesh with the VAE's angles; the interval between
its CUDA events on the stream, its device work and any device idle inside
it, in a Ponymation training cell."""
from harness.entries import pony_train


def read(ctx):
    return pony_train.span_ms(ctx, "a3d.skinning")
