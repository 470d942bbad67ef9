"""The share of netBase's eval prior requests in the traced window that
returned the prior held from an earlier call, % (the program's counters
`netbase.prior_hits` and `netbase.prior_misses`), in reconstruction."""
from harness import counters

CALLS = ("netbase.prior_hits", "netbase.prior_misses")


def read(ctx):
    return counters.share_pct(ctx, "recon", CALLS[0], CALLS)
