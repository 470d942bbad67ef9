"""The yardstick's arithmetic against hand counts at small sizes: K6/K7
operations, the FLOPs the whole-step share counts over the reference's
sweep, K4 and K1 bytes."""
import pytest
import torch

from harness import bounds, peaks
from harness.entries.common import flop_counter
from harness.entries.train import model_flops


def test_sweep_operations_by_hand():
    # N = 3 rows, embedding width 2, L = 2 layers of 256: in-layer 3·2·256
    # products, one hidden 3·256·256, the last 3·256; two FLOPs each
    fwd = 2 * (3 * 2 * 256 + 3 * 256 * 256 + 3 * 256)
    assert bounds.sweep_fwd_ops(3, 2, 2) == fwd == 397824
    # backward: the forward again, then per layer its weight gradient and,
    # but for the input, the cotangent's way back
    bwd = fwd + 2 * (3 * 256 + 3 * 256 * 256 + 3 * 2 * 256) \
        + 2 * (3 * 256 + 3 * 256 * 256)
    assert bounds.sweep_bwd_ops(3, 2, 2) == bwd


def test_sweep_operations_match_a_flop_counter():
    """A plain MLP of the trunk's shape under torch's FLOP counter: the
    forward counts K6's operations, the weights' backward K7's less the
    recomputed forward."""
    from torch.utils.flop_counter import FlopCounterMode
    N, d, L = 40, 51, 5
    g = torch.Generator().manual_seed(0)
    e = torch.randn(N, d, generator=g)
    win = torch.randn(d, 256, generator=g, requires_grad=True)
    ws = [torch.randn(256, 256, generator=g, requires_grad=True)
          for _ in range(L - 1)]
    wl = torch.randn(256, 1, generator=g, requires_grad=True)
    with FlopCounterMode(display=False) as fwd_count:
        a = torch.relu(e @ win)
        for w in ws:
            a = torch.relu(a @ w)
        out = (a @ wl).sum()
    with FlopCounterMode(display=False) as bwd_count:
        out.backward()
    # the in-layer's bias and the hidden layers' 256 → 256 products
    fwd = bounds.sweep_fwd_ops(N, d, L)
    assert fwd_count.get_total_flops() == fwd
    assert bwd_count.get_total_flops() + fwd == bounds.sweep_bwd_ops(N, d, L)


def test_model_flops_of_the_reference_sweep():
    """The counted FLOPs of the reference's sweep forward and backward, less
    the recomputation and the zero padding: the model's work."""
    from refmodel import probe
    from refmodel.networks.mlp import CoordMLP
    from refmodel.ops import fused_mlp
    net = CoordMLP(3, 1, 4, nf=256, n_harmonic_functions=8)
    gen = torch.Generator().manual_seed(1)
    for m in net.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    pts = torch.rand(37, 3)
    e = net.embed(pts)
    records = []
    probe.SINK = lambda kind, f: records.append((kind, f))
    try:
        with flop_counter() as count:
            fused_mlp.mlp_sweep(net, e, num_layers=4).sum().backward()
    finally:
        probe.SINK = None
    N, d, L = 37, e.shape[1], 4
    fwd = bounds.sweep_fwd_ops(N, d, L)
    want = fwd + bounds.sweep_bwd_ops(N, d, L) - fwd
    assert model_flops(count.get_total_flops(), records) == want


def test_resolve_bwd_bytes_by_hand():
    """2 images of 4 pixels, 3 channels: ids 2·4 int32, the cotangent of
    the 6 foreground pixels in bf16, the 5 (image, face) rows they won in
    float32."""
    nbytes = 2 * 4 * 4 + 6 * 3 * 2 + 5 * 3 * 4
    assert nbytes == 128
    assert bounds.resolve_bwd_ms(2, 4, 3, 6, 5) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S * 1e3)


def test_resolve_bwd_probe_counts_rows():
    """The reference's probe counts the foreground pixels and the distinct
    (image, face) rows they won."""
    from refmodel import probe
    from refmodel.ops import resolve_cuda
    fid = torch.tensor([[1, 1, 0, 2], [0, 3, 3, 3]], dtype=torch.int32)
    g = torch.ones(2, 4, 3)
    got = []
    probe.SINK = lambda kind, f: got.append(f)
    try:
        out = resolve_cuda.resolve_bwd(g, fid, 5)
    finally:
        probe.SINK = None
    assert got[0]["fg"] == 6 and got[0]["rows"] == 3
    assert out[0, 0].tolist() == [2.0] * 3 and out[1, 2].tolist() == [3.0] * 3


def test_visibility_work_by_hand():
    """One triangle on a 32 × 16 screen (one tile), chunks of 64 faces in
    8 sub-blocks of 8: one live sub-block's 12 float32 rows and 8 ids, one
    list entry (chunk id and mask), the tile's count and the chunk's z-min,
    z and face ids of 512 pixels and one flag; the pixel centres inside the
    triangle's bbox x 4.2..10.7, y 2.2..9.9: 7 columns by 8 rows."""
    from refmodel.ops import rasterize_cuda as rc
    W, H = 32, 16

    def clip(px, py):
        return [px / W * 2 - 1, py / H * 2 - 1, 0.5, 1.0]
    v = torch.tensor([[clip(4.2, 2.2), clip(10.7, 2.2), clip(4.2, 9.9)]])
    faces = torch.tensor([[0, 1, 2]])
    prep = rc.prepare(v, v[0, :, :3], faces, torch.tensor([True]), (H, W),
                      64, 8)
    st = {}
    out = rc.visibility_reference(prep["table"], prep["orig"],
                                  prep["order"], prep["counts"],
                                  prep["masks"], prep["zlo"], (H, W),
                                  prep["nsub"], stats=st)
    nbytes, pairs = bounds.visibility_work(v, faces, prep, (H, W),
                                           st["visits"], out)
    assert pairs == 7 * 8
    assert nbytes == 8 * 12 * 4 + 8 * 4 + 2 * 4 + 4 + 4 \
        + 512 * 4 + 512 * 4 + 1


def test_flop_counter_under_autograd_grad():
    """The harness's counter agrees with torch's on a product and its
    backward, and counts through `torch.autograd.grad` with a graph (the
    discriminator's R1 penalty)."""
    from torch.utils.flop_counter import FlopCounterMode
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 4, requires_grad=True)
    with FlopCounterMode(display=False) as ref:
        (x @ w).sum().backward()
    with flop_counter() as mine:
        (x @ w).sum().backward()
    assert mine.get_total_flops() == ref.get_total_flops() > 0
    with flop_counter() as mine:
        y = torch.tanh(x @ w).sum()
        (g,) = torch.autograd.grad(y, x, create_graph=True)
        (g ** 2).sum().backward()
    assert mine.get_total_flops() > 0
