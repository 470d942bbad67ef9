"""K1, the tile visibility walk (`csrc/raster_vis.cu`): its bound over its
device time per launch."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "recon":
        return None
    return readers.roofline_pct(ctx, "k1", "tile_walk_kernel")
