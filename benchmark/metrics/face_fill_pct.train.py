"""The extracted meshes' faces over their face slots, % (the program's
counters `mesh.faces` and `mesh.face_slots`): the useful share of the
slots that every face consumer processes."""
from harness import spans


def read(ctx):
    return spans.ratio_pct(ctx, "train", "mesh.faces", "mesh.face_slots")
