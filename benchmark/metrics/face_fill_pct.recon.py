"""The extracted meshes' faces over their face slots, % (the program's
counters `mesh.faces` and `mesh.face_slots`), in reconstruction."""
from harness import spans


def read(ctx):
    return spans.ratio_pct(ctx, "recon", "mesh.faces", "mesh.face_slots")
