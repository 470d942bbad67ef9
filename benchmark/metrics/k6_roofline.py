"""K6, the fused lattice sweep's forward (`csrc/fused_mlp.cu`): its bound over
its device time per launch."""
from harness import readers


def read(ctx):
    if ctx["entry"] != "train":
        return None
    return readers.roofline_pct(ctx, "k6", "fused_mlp_fwd_wgmma_kernel")
