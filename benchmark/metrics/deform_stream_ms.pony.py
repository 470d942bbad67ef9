"""Stream ms an iteration of the program's span `a3d.deform`: netDeform
over every frame's vertex slots, in blocks of whole frames
(`_deform_offsets`); the interval between its CUDA events on the stream,
its device work and any device idle inside it, in a Ponymation training
cell."""
from harness.entries import pony_train


def read(ctx):
    return pony_train.span_ms(ctx, "a3d.deform")
