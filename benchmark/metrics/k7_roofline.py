"""K7, the fused lattice sweep's backward (chain, weight-gradient and reduce
kernels of `csrc/fused_mlp.cu`, one reduce a call): its bound over its
device time per call."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.roofline_pct(ctx, "k7", "fused_mlp_bwd_reduce_kernel",
                                "fused_mlp_chain_kernel",
                                "fused_mlp_wgrad_kernel")
