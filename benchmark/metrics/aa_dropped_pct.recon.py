"""The share of silhouette pairs the antialias pass found and dropped
beyond its cap, %, in reconstruction."""
from harness import spans


def read(ctx):
    return spans.ratio_pct(ctx, "recon", "aa.pairs_kept", "aa.pairs_found",
                           complement=True)
