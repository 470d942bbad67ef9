"""The share of netInstance's calls in the traced window that replayed a
CUDA graph, % (the program's counters `netinstance.graph_replays`,
`netinstance.graph_captures` and `netinstance.eager_calls`)."""
from harness import counters

CALLS = ("netinstance.graph_replays", "netinstance.graph_captures",
         "netinstance.eager_calls")


def read(ctx):
    return counters.share_pct(ctx, "train", CALLS[0], CALLS)
