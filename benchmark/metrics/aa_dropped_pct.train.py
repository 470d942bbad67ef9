"""The share of silhouette pairs the antialias pass found and dropped
beyond its cap, % (the program's counters `aa.pairs_found`,
`aa.pairs_kept`)."""
from harness import spans


def read(ctx):
    return spans.ratio_pct(ctx, "train", "aa.pairs_kept", "aa.pairs_found",
                           complement=True)
