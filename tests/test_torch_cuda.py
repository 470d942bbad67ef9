"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips."""
import sys

import numpy as np
import pytest
import torch

from animals3d_tpu_torch.ops import dmtet
from animals3d_tpu_torch.ops import rasterize_cuda as rc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random(rng):
    B, Fn = 3, 2000
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = (ctr + rng.uniform(-0.1, 0.1, (B, Fn, 3, 3))).reshape(B, 3 * Fn, 3)
    w = rng.uniform(2, 4, (B, 3 * Fn, 1))
    v_clip = np.concatenate([v * w, w], -1).astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    return (v_clip, rng.normal(size=(3 * Fn, 3)).astype(np.float32), faces,
            rng.uniform(size=Fn) > 0.05, (64, 96), 128)


def _depth_stack(rng):
    quads, faces = [], []
    depths = [1.0, 1.0] + [1.0 + 0.2 * i for i in range(1, 8)]
    for qi, z in enumerate(depths):
        i0 = 4 * qi
        s = 1.0 if qi != 3 else 0.3
        quads += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        faces += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    v = np.asarray(quads, np.float32)
    v_clip = np.concatenate([v * 2.0, np.full((len(v), 1), 2.0)], -1)[None]
    return (v_clip.astype(np.float32), v, np.asarray(faces),
            np.ones(len(faces), bool), (32, 32), 2)


def _sphere(rng):
    """Capacity-padded lattice marching-tets sphere."""
    res = 16
    n = res + 1
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    sdf = (0.3 - np.linalg.norm(pos, axis=-1)).astype(np.float32)
    out = dmtet.marching_tets_lattice(torch.from_numpy(pos),
                                      torch.from_numpy(sdf), res, 4096, 8192)
    verts = out.verts.numpy()
    v_clip = np.concatenate([verts * 2.0, np.full((len(verts), 1), 2.0)], -1)
    return (v_clip[None].astype(np.float32), verts, out.faces.numpy(),
            out.f_valid.numpy(), (64, 64), 256)


def _sliver(rng):
    """Faces a hundredth to a thousandth of a pixel across far from the
    screen origin, where the float32 edge constant is rounded by more than
    the face is wide: the accepted pixels leave the faces' vertex bboxes
    (`tests/test_torch_raster_variants.py` `_sliver_scene`)."""
    Fn = 3000
    ctr = rng.uniform(0.5, 0.98, (1, Fn, 1, 2))
    size = 10.0 ** rng.uniform(-5, -3, (1, Fn, 1, 1))
    xy = ctr + rng.uniform(-1, 1, (1, Fn, 3, 2)) * size
    z = rng.uniform(0.2, 0.8, (1, Fn, 3, 1))
    v = np.concatenate([xy, z], -1).reshape(1, 3 * Fn, 3)
    v_clip = np.concatenate([v, np.ones((1, 3 * Fn, 1))], -1) \
        .astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    return v_clip, v_clip[0, :, :3], faces, np.ones(Fn, bool), (64, 64), 1024


def _big_and_small(rng):
    """The load balance: 3,000 faces a fraction of a pixel across and, in
    the middle of the face order, one face that covers the whole screen
    behind most of them, so that one face of a sub-block holds every pixel
    of the tile."""
    B, Fn = 2, 3000
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = ctr + rng.uniform(-0.004, 0.004, (B, Fn, 3, 3))
    v[..., 2] = rng.uniform(-0.5, 0.5, (B, Fn, 3))
    v[:, Fn // 2] = [[-4.0, -4.0, 0.3], [4.0, -4.0, 0.3], [0.0, 4.0, 0.3]]
    v = v.reshape(B, 3 * Fn, 3)
    w = np.full((B, 3 * Fn, 1), 2.0)
    v_clip = np.concatenate([v * w, w], -1).astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    return (v_clip, v[0].astype(np.float32), faces, np.ones(Fn, bool),
            (64, 96), 256)


def _depth_stack_copies(rng):
    """The depth stack with each face repeated 16 times in a row: chunks of
    32 faces hold one quad each, so variant 4 (sub-blocks of a multiple of
    32 faces) runs it with nsub 1, and the copies tie exactly in z."""
    v_clip, v, faces, f_valid, res, _chunk = _depth_stack(rng)
    faces = np.repeat(faces.reshape(-1, 2, 3), 16, 0).reshape(-1, 3)
    faces = faces.reshape(9, 16, 2, 3).transpose(0, 2, 1, 3).reshape(-1, 3)
    return v_clip, v, faces, np.ones(len(faces), bool), res, 32


def _prep(card, make, seed, **kw):
    v_clip, v_pos0, faces, f_valid, res, chunk = make(
        np.random.default_rng(seed))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=card)
    return rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                      t(f_valid, torch.bool), res, kw.pop("chunk", chunk),
                      **kw), res


def _bits(masks):
    """Set bits of each int32 sub-block mask."""
    return sum((masks >> g) & 1 for g in range(16))


# (scene, chunk, nsub): sub-blocks of 16, 32 and 1,024 faces, of 12, 6 and
# 5 (not a multiple of 32; 6 and 5 are not a multiple of 4 either, so
# their rows are staged with plain loads), one sub-block per chunk at chunk
# 32 and at chunk 2, sixteen sub-blocks (more live sub-blocks in a chunk
# than one batch takes), the load balance and the slivers
K1_CASES = [(_random, 128, 8), (_random, 96, 8), (_random, 96, 16),
            (_random, 20, 4), (_random, 256, 16), (_depth_stack, 2, 8),
            (_depth_stack_copies, 32, 1), (_sphere, 256, 8),
            (_sphere, 1024, 1), (_big_and_small, 256, 8),
            (_sliver, 1024, 8)]


@pytest.mark.parametrize("make,chunk,nsub", K1_CASES,
                         ids=[f"{m.__name__[1:]}-{c}-{n}"
                              for m, c, n in K1_CASES])
def test_visibility_kernel_equals_plain_version(card, make, chunk, nsub):
    """K1: face_id, z and the chunk flags identical bit for bit to
    `visibility_reference`; one launch counted per call."""
    prep, res = _prep(card, make, 3, chunk=chunk, nsub=nsub)
    lists = (prep["table"], prep["orig"], prep["order"], prep["counts"],
             prep["masks"], prep["zlo"])
    launches = rc.visibility.launches
    got = rc.visibility(*lists, prep["fbox"], res, prep["nsub"])
    torch.cuda.synchronize()
    assert rc.visibility.launches == launches + 1
    want = rc.visibility_reference(*lists, res, prep["nsub"])
    assert int((want[1] > 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if nsub == 16:
        assert _most_live_sub_blocks(prep) > 8
    if make is _big_and_small:
        assert int((want[1] == 1501).sum()) > 100


def _most_live_sub_blocks(prep):
    """The most sub-blocks of one listed chunk that overlap its tile."""
    listed = torch.arange(prep["order"].shape[-1], device=prep["order"].device) \
        < prep["counts"][..., None]
    bits = _bits(prep["masks"].gather(-1, prep["order"].long()))
    return int(bits[listed].max())


@pytest.mark.parametrize("make,chunk,nsub", [
    (_random, 256, 16), (_sphere, 256, 8), (_big_and_small, 256, 8),
    (_depth_stack, 2, 8)])
def test_visibility_kernel_with_a_ring_of_one_slot(card, monkeypatch, make,
                                                    chunk, nsub):
    """K1 with the least shared memory, a ring of one slot: every live
    sub-block of a chunk after its first waits for the slot to be
    released, and the drained loads of skipped chunks too; the outputs are
    the plain version's bit for bit."""
    monkeypatch.setattr(rc, "K1_SMEM", 0)
    prep, res = _prep(card, make, 5, chunk=chunk, nsub=nsub)
    lists = (prep["table"], prep["orig"], prep["order"], prep["counts"],
             prep["masks"], prep["zlo"])
    got = rc.visibility(*lists, prep["fbox"], res, prep["nsub"])
    want = rc.visibility_reference(*lists, res, prep["nsub"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert make is _depth_stack or _most_live_sub_blocks(prep) > 1


@pytest.mark.parametrize("make,chunk,nsub", [
    (_random, 128, 8), (_depth_stack, 2, 8), (_sphere, 256, 8),
    (_big_and_small, 256, 8), (_sliver, 1024, 8)])
def test_cull_kernel_equals_cull_boxes(card, make, chunk, nsub):
    """The cull kernel's boxes equal `cull_boxes`' (float64 PyTorch on the
    card) bit for bit; `prepare` calls it for variants 3 and 4, one launch
    each."""
    launches = rc.cull.launches
    prep, res = _prep(card, make, 3, chunk=chunk, nsub=nsub)
    assert rc.cull.launches == launches + 1
    want = rc.cull_boxes(prep["table"], res)
    assert torch.equal(prep["fbox"], want)
    assert torch.equal(rc.cull(prep["table"], res), want)
    empty = (want[..., 0] > want[..., 1]) | (want[..., 2] > want[..., 3])
    assert 0 < int(empty.sum()) < empty.numel() or make is _depth_stack


def test_visibility_kernel_rejects_bad_inputs(card):
    """A table or cull boxes off the card, of the wrong type, shape or
    layout, and a sub-block too large for shared memory, raise before any
    launch."""
    prep, res = _prep(card, _random, 4)
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    fbox = prep["fbox"]
    launches = rc.visibility.launches
    with pytest.raises(ValueError):
        rc.visibility(prep["table"].cpu(), prep["orig"], *lists, fbox, res,
                      prep["nsub"])
    with pytest.raises(ValueError):
        rc.visibility(prep["table"][:, :, :, ::2].contiguous(), prep["orig"],
                      *lists, fbox, res, prep["nsub"])
    for bad in (fbox.cpu(), fbox.int(), fbox[:, :-1].contiguous(),
                fbox.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError):
            rc.visibility(prep["table"], prep["orig"], *lists, bad, res,
                          prep["nsub"])
    big, res = _prep(card, _sphere, 4, chunk=4096, nsub=1)
    with pytest.raises(ValueError):
        rc.visibility(big["table"], big["orig"], big["order"],
                      big["counts"], big["masks"], big["zlo"], big["fbox"],
                      res, big["nsub"])
    assert rc.visibility.launches == launches


# ---------------------------------------------------------------------------
# fused netSDF sweep (K6/K7) and resolve backward (K4)
# ---------------------------------------------------------------------------

def _mlp_inputs(rng, n, dp, nl, dtype, card):
    from animals3d_tpu_torch.ops import fused_mlp as fm
    t = lambda a, dt: torch.as_tensor(a, device=card).to(dt).contiguous()
    e = t(rng.uniform(-1, 1, (n, dp)).astype(np.float32), dtype)
    win = t(rng.normal(0, dp ** -0.5, (dp, fm.NF)).astype(np.float32), dtype)
    b = t(rng.normal(0, 0.1, (fm.NF,)).astype(np.float32), torch.float32)
    ws = t(rng.normal(0, (2 / fm.NF) ** 0.5, (nl, fm.NF, fm.NF))
           .astype(np.float32), dtype)
    wlast = t(rng.normal(0, fm.NF ** -0.5, (fm.NF,)).astype(np.float32),
              dtype)
    g = t(rng.normal(size=(n,)).astype(np.float32), torch.float32)
    return e, win, b, ws, wlast, g


@pytest.mark.parametrize("n,dp,nl", [(1001, 64, 4), (77, 64, 1),
                                     (20000, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernels_equal_plain_version(card, n, dp, nl, dtype):
    """Forward and every weight gradient against the plain version. float32:
    rtol 2e-5 of the output's magnitude forward, 1e-4 of each gradient's
    norm backward (summation order). bf16: the output is a bf16 value, so
    the two may differ by 2 bf16 ulps (2^-8 relative) of the output's
    magnitude where a 256-long float32 sum rounds to the other side; a
    gradient by 2e-3 of its norm (the limits of `chip_smoke.py`, which
    reads 0.62 ulps and 3.6e-4 at full width)."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    e, win, b, ws, wlast, g = _mlp_inputs(np.random.default_rng(n), n, dp, nl,
                                          dtype, card)
    before = fm.fused_mlp_fwd.launches, fm.fused_mlp_bwd.launches
    out = fm.fused_mlp_fwd(e, win, b, ws, wlast)
    grads = fm.fused_mlp_bwd(e, g, win, b, ws, wlast)
    torch.cuda.synchronize()
    assert (fm.fused_mlp_fwd.launches, fm.fused_mlp_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    want = fm.fused_mlp_fwd_reference(e, win, b, ws, wlast)
    wgrads = fm.fused_mlp_bwd_reference(e, g, win, b, ws, wlast)
    f32 = dtype == torch.float32
    scale = float(want.abs().max())
    assert scale > 0
    assert float((out - want).abs().max()) <= (2e-5 if f32 else 2 * 2 ** -8) \
        * scale
    for name, a, w in zip(("dwin", "db", "dws", "dwlast"), grads, wgrads):
        assert torch.isfinite(a).all(), name
        err = float((a - w).norm() / w.norm())
        assert err <= (1e-4 if f32 else 2e-3), (name, err)
    again = fm.fused_mlp_bwd(e, g, win, b, ws, wlast)
    for a, c in zip(grads, again):
        assert torch.equal(a, c)       # fixed grid, fixed reduction order


@pytest.mark.parametrize("n,nl,chunk_rows", [
    (1000, 4, 256),       # four chunks, the last ragged, its last tile too
    (3 * 384 + 77, 2, 384),
    (50, 4, None),        # fewer rows than one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_bwd_chunks_equal_plain_version(card, monkeypatch, n, nl,
                                                  chunk_rows, dtype):
    """The backward over several chunks of the bf16 plan (`CHUNK_ROWS` set
    small, so that N spans at least three chunks and ends in a ragged chunk
    and a ragged tile) and over fewer rows than one tile: every gradient
    within the limits of `test_fused_mlp_kernels_equal_plain_version` (2e-3
    of its norm in bf16, 1e-4 in float32, which has no chunks), identical
    across two calls, one launch counted per call."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if chunk_rows is not None:
        monkeypatch.setattr(fm, "CHUNK_ROWS", chunk_rows)
        assert len(fm.bwd_plan(n, nl + 1, 64, chunk_rows).chunks) >= 3
    e, win, b, ws, wlast, g = _mlp_inputs(np.random.default_rng(n + nl), n,
                                          64, nl, dtype, card)
    before = fm.fused_mlp_bwd.launches
    grads = fm.fused_mlp_bwd(e, g, win, b, ws, wlast)
    again = fm.fused_mlp_bwd(e, g, win, b, ws, wlast)
    torch.cuda.synchronize()
    assert fm.fused_mlp_bwd.launches == before + 2
    wgrads = fm.fused_mlp_bwd_reference(e, g, win, b, ws, wlast)
    f32 = dtype == torch.float32
    for name, a, w, c in zip(("dwin", "db", "dws", "dwlast"), grads, wgrads,
                             again):
        assert torch.isfinite(a).all(), name
        err = float((a - w).norm() / w.norm())
        assert err <= (1e-4 if f32 else 2e-3), (name, err)
        assert torch.equal(a, c), name


@pytest.mark.parametrize("n,nl", [(50, 4), (77, 1), (3 * 128 + 1, 4),
                                  (132 * 128 + 1, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_fwd_ragged_tiles_bf16(card, n, nl, dtype):
    """The forward (bf16, and the float32 build over the same 128-row
    tiles, `fwd_f32_plan`) with fewer rows than one tile, and with
    N = k·128 + 1, so that the last tile holds a single row (at k = 132,
    more tiles than blocks: the first block's second tile): every output
    within the limits of `test_fused_mlp_kernels_equal_plain_version` (2
    bf16 ulps, float32 2e-5, of the output's magnitude) of the plain
    version, the last row on its own too and not left at zero; one launch
    counted per call; a second call gives the same bits."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    assert fm.fwd_f32_plan(n, nl + 1, 64).tile_rows == 128
    e, win, b, ws, wlast, _g = _mlp_inputs(np.random.default_rng(n + nl), n,
                                           64, nl, dtype, card)
    before = fm.fused_mlp_fwd.launches
    out = fm.fused_mlp_fwd(e, win, b, ws, wlast)
    again = fm.fused_mlp_fwd(e, win, b, ws, wlast)
    torch.cuda.synchronize()
    assert fm.fused_mlp_fwd.launches == before + 2
    want = fm.fused_mlp_fwd_reference(e, win, b, ws, wlast)
    tol = (2e-5 if dtype == torch.float32 else 2 * 2 ** -8) \
        * float(want.abs().max())
    assert torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= tol
    assert float((out[-1] - want[-1]).abs()) <= tol and float(out[-1]) != 0
    assert torch.equal(out, again)


def test_fused_mlp_fwd_f32_at_stage2_shape(card):
    """The float32 forward at Ponymation stage 2's sweep: 129³ = 2,146,689
    rows (the grid-128 lattice), DP 64, L 5, against the plain version
    (TF32 off): every output within 2e-5 of the output's magnitude, the
    last row not left at zero; a second call gives the same bits."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    n = 129 ** 3
    e, win, b, ws, wlast, _g = _mlp_inputs(np.random.default_rng(22), n, 64,
                                           4, torch.float32, card)
    out = fm.fused_mlp_fwd(e, win, b, ws, wlast)
    again = fm.fused_mlp_fwd(e, win, b, ws, wlast)
    want = fm.fused_mlp_fwd_reference(e, win, b, ws, wlast)
    torch.cuda.synchronize()
    tol = 2e-5 * float(want.abs().max())
    assert torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= tol
    assert float(out[-1]) != 0
    assert torch.equal(out, again)


def test_fused_mlp_prebuilt_weight_stream_bf16(card):
    """`fused_mlp_fwd` and `fused_mlp_bwd` with a prebuilt `weight_stream`
    give the same bits as without one; a stream of the wrong shape
    raises."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    e, win, b, ws, wlast, g = _mlp_inputs(np.random.default_rng(7), 3001, 64,
                                          4, torch.bfloat16, card)
    wstream = fm.weight_stream(win, ws)
    assert torch.equal(fm.fused_mlp_fwd(e, win, b, ws, wlast, wstream),
                       fm.fused_mlp_fwd(e, win, b, ws, wlast))
    for a, c in zip(fm.fused_mlp_bwd(e, g, win, b, ws, wlast, wstream),
                    fm.fused_mlp_bwd(e, g, win, b, ws, wlast)):
        assert torch.equal(a, c)
    with pytest.raises(ValueError):
        fm.fused_mlp_fwd(e, win, b, ws, wlast, wstream[1:])


def test_mlp_sweep_bf16_on_card(card, monkeypatch):
    """`mlp_sweep` through autograd on the card in bf16 against the plain
    versions on the operands the Function builds: output within 2 bf16
    ulps of its magnitude, every parameter's gradient within 2e-3 of its
    norm (the limits of `test_fused_mlp_kernels_equal_plain_version`);
    `weight_stream` is built once for the forward and the backward."""
    from animals3d_tpu_torch.networks.mlp import CoordMLP
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.precision import set_mixed_precision
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    built = []
    real = fm.weight_stream

    def counting(win, ws):
        built.append(1)
        return real(win, ws)
    monkeypatch.setattr(fm, "weight_stream", counting)
    net = CoordMLP(3, 1, 5, nf=256, n_harmonic_functions=8,
                   embedder_scalar=0.8)
    gen = torch.Generator().manual_seed(0)
    for m in net.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    net.to(card)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(
        -3, 3, (3001, 3)).astype(np.float32), device=card)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=3001)
                        .astype(np.float32), device=card)
    set_mixed_precision("bf16")
    try:
        e = net.embed(pts)
        got = fm.mlp_sweep(net, e, num_layers=5)
        (got * w).sum().backward()
        torch.cuda.synchronize()
        assert len(built) == 1
        cd = torch.bfloat16
        d = e.shape[1]
        ep = torch.zeros((e.shape[0], fm.KPAD), dtype=cd, device=card)
        ep[:, :d] = e
        win = torch.zeros((fm.KPAD, fm.NF), dtype=cd, device=card)
        win[:d] = net.in_layer.weight.detach().T
        ws = torch.stack([getattr(net.mlp, f"layer_{i}").weight.detach().T
                          for i in range(4)]).to(cd).contiguous()
        wlast = net.mlp.layer_4.weight.detach()[0].to(cd).contiguous()
        b = net.in_layer.bias.detach().float().contiguous()
        want = fm.fused_mlp_fwd_reference(ep, win, b, ws, wlast)
        dwin, db, dws, dwlast = fm.fused_mlp_bwd_reference(ep, w, win, b, ws,
                                                           wlast)
    finally:
        set_mixed_precision(None)
    assert float((got.detach() - want).abs().max()) <= 2 * 2 ** -8 * float(
        want.abs().max())
    wgrads = {"in_layer.weight": dwin[:d].T, "in_layer.bias": db,
              "mlp.layer_4.weight": dwlast[None]}
    for i in range(4):
        wgrads[f"mlp.layer_{i}.weight"] = dws[i].T
    for k, p in net.named_parameters():
        err = float((p.grad - wgrads[k]).norm() / wgrads[k].norm())
        assert err <= 2e-3, (k, err)


def test_mlp_sweep_function_on_card(card):
    """`mlp_sweep` through autograd on the card against the plain CoordMLP
    (float32): output rtol 2e-5, every parameter's grad 1e-4 of its norm;
    an input that requires grad raises."""
    from animals3d_tpu_torch.networks.mlp import CoordMLP
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    net = CoordMLP(3, 1, 5, nf=256, n_harmonic_functions=8,
                   embedder_scalar=0.8).to(card)
    gen = torch.Generator().manual_seed(0)
    net.to("cpu")
    for m in net.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    net.to(card)
    pts = torch.as_tensor(np.random.default_rng(0).uniform(
        -3, 3, (3001, 3)).astype(np.float32), device=card)
    w = torch.as_tensor(np.random.default_rng(1).normal(size=3001)
                        .astype(np.float32), device=card)
    ref = net(pts)[:, 0]
    (ref * w).sum().backward()
    want = {k: p.grad.clone() for k, p in net.named_parameters()}
    net.zero_grad()
    got = fm.mlp_sweep(net, net.embed(pts), num_layers=5)
    (got * w).sum().backward()
    assert float((got - ref).abs().max()) <= 2e-5 * float(ref.abs().max())
    for k, p in net.named_parameters():
        err = float((p.grad - want[k]).norm() / want[k].norm())
        assert err <= 1e-4, (k, err)
    with pytest.raises(ValueError):
        fm.mlp_sweep(net, net.embed(pts.requires_grad_()), num_layers=5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resolve_bwd_kernel_equals_plain_version(card, dtype):
    """Scatter-add by winner id: rtol 1e-5 (the order of the float32
    atomics); faces with at most one pixel are exact; a cotangent on the
    background contributes nothing."""
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    rng = np.random.default_rng(5)
    B, P, R, Fn = 3, 4096, 42, 500
    fid = rng.integers(0, Fn + 1, (B, P)).astype(np.int32)
    fid[:, :P // 3] = 0
    g = torch.as_tensor(rng.normal(size=(B, P, R)).astype(np.float32),
                        device=card).to(dtype)
    fid = torch.as_tensor(fid, device=card)
    n = rv.resolve_bwd.launches
    got = rv.resolve_bwd(g, fid, Fn)
    torch.cuda.synchronize()
    assert rv.resolve_bwd.launches == n + 1
    want = rv.resolve_bwd_reference(g, fid, Fn)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g0 = g.clone()
    g0[fid == 0] = 0
    assert torch.equal(rv.resolve_bwd(g0, fid, Fn).sum(1) != 0,
                       got.sum(1) != 0)
    # one pixel per face: exact
    fid1 = torch.zeros((1, P), dtype=torch.int32, device=card)
    fid1[0, :Fn] = torch.randperm(Fn, device=card).int() + 1
    assert torch.equal(rv.resolve_bwd(g[:1].contiguous(), fid1, Fn),
                       rv.resolve_bwd_reference(g[:1].contiguous(), fid1, Fn))


def test_small_train_step_on_card(card):
    """One float32 `train_step` of a small model (netSDF 256 wide, so the
    fused sweep runs) on the card: every kernel launches once, the loss
    is finite, every trainable parameter moves and the ViT does not."""
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfglib.load_config("train_magicpony_horse", overrides=[
        "dataset.in_image_size=64", "dataset.out_image_size=64",
        "model.cfg_predictor_base.cfg_shape.grid_res=16",
        "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
        "model.cfg_predictor_base.cfg_shape.num_layers=2",
        "model.cfg_predictor_base.cfg_shape.hidden_size=256",
        "model.cfg_predictor_instance.cfg_encoder.cout=32",
        "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
        "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
        "model.cfg_predictor_instance.cfg_light.hidden_size=32"])
    model = build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                        device="cuda")
    model.init_params(0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels = (rc.cull, rc.visibility, fm.fused_mlp_fwd, fm.fused_mlp_bwd,
               rv.resolve_bwd)
    counts = [k.launches for k in kernels]
    gen = torch.Generator(device="cuda").manual_seed(0)
    met = train_step(model, make_optimizer(model), fake_batch(model, 2),
                     50000, gen)
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [c + 1 for c in counts]
    assert np.isfinite(float(met["loss"]))
    for name, p in model.named_parameters():
        same = torch.equal(p, before[name])
        if ".ViT." in name:
            assert same and not p.requires_grad, name
        elif not name.startswith("netInstance.netDeform."):
            assert not same and bool(torch.isfinite(p).all()), name


def test_reconstruct_holds_the_eval_prior_on_card(card):
    """Two bf16 `reconstruct` calls of MagicPony at grid 64, TF32 off,
    netInstance eager in both (anomaly mode keeps its graphs off) and
    deterministic algorithms on (`index_add_`'s atomics would otherwise
    sum the vertex normals in any order): the first computes the prior
    (one miss), the second returns the held one (one hit); the held
    prior equals a fresh model's with the same weights, and the two
    calls' RGBA equal each other and the fresh model's, all bit for bit.
    Three more calls, in which netInstance runs eagerly, captures its
    graph and replays it, leave every tensor of the held prior at its
    version and its bits."""
    import dataclasses

    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch import tracing
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    set_mixed_precision("bf16")
    cfg = cfglib.load_config("train_magicpony_horse", overrides=[
        "dataset.in_image_size=64", "dataset.out_image_size=64",
        "model.cfg_predictor_base.cfg_shape.grid_res=64",
        "model.cfg_predictor_base.cfg_shape.grid_res_coarse=64"])
    make = lambda: build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                               device="cuda")
    model, fresh = make(), make()
    model.init_params(0)
    fresh.load_state_dict(model.state_dict())
    images = fake_batch(model, 2)["images"]
    it = 140000

    def counts():
        c = tracing.snapshot()["counters"]
        return tuple(c.get(n, 0) for n in (
            "netbase.prior_hits", "netbase.prior_misses",
            "netinstance.graph_captures", "netinstance.graph_replays"))

    def tensors(mesh, sdf):
        out = {f.name: getattr(mesh, f.name)
               for f in dataclasses.fields(mesh)
               if getattr(mesh, f.name) is not None}
        out["sdf"] = sdf
        return out
    tracing.enable()
    try:
        rgba, seen = [], []
        with torch.autograd.set_detect_anomaly(True):
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                for _ in range(2):
                    rgba.append(model.reconstruct(model, images, it)[0])
                    seen.append(counts())
                want = fresh.reconstruct(fresh, images, it)[0]
            finally:
                torch.use_deterministic_algorithms(False)
        assert seen == [(0, 1, 0, 0), (1, 1, 0, 0)]
        held = tensors(*model.netBase._held_prior[3])
        for k, t in tensors(*fresh.netBase._held_prior[3]).items():
            assert torch.equal(held[k], t), k
        assert torch.equal(rgba[0], rgba[1]) and torch.equal(rgba[1], want)
        assert float(want[:, 3].sum()) > 0
        versions = {k: t._version for k, t in held.items()}
        bits = {k: t.clone() for k, t in held.items()}
        for _ in range(3):
            model.reconstruct(model, images, it)
        torch.cuda.synchronize()
        assert counts() == (4, 2, 1, 1)
        assert model.netBase._held_prior[3][1] is held["sdf"]
        for k, t in held.items():
            assert t._version == versions[k], k
            assert torch.equal(t, bits[k]), k
    finally:
        tracing.disable()
        set_mixed_precision(None)


# ---------------------------------------------------------------------------
# visibility variants 4 and 6 (K2, K3) and the resolve-rows forward (K5)
# ---------------------------------------------------------------------------

def _holes(rng):
    """Invalid and empty faces: random small triangles with the first 512
    faces invalid (whole Morton blocks, so whole units hold no valid
    face), 200 degenerate faces (zero area) and 200 with a vertex behind
    the camera (w < 0)."""
    B, Fn = 2, 2400
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = ctr + rng.uniform(-0.1, 0.1, (B, Fn, 3, 3))
    v[:, 600:800] = v[:, 600:800, :1]
    w = rng.uniform(2, 4, (B, Fn, 3, 1))
    w[:, 800:1000, 0] = -1.0
    v_clip = np.concatenate([v * w, w], -1).reshape(B, 3 * Fn, 4) \
        .astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    f_valid = np.ones(Fn, bool)
    f_valid[:512] = False
    return (v_clip, v.reshape(B, 3 * Fn, 3)[0].astype(np.float32), faces,
            f_valid, (64, 96), 128)


def _k2_k1_plain(prep, res, table=None):
    """K2, K1 and their plain version on a variant-4 prep (on `table` in
    place of the prep's where given: the same values elsewhere in
    memory)."""
    table = prep["table"] if table is None else table
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    got = rc.visibility_v4(table, prep["bbase"], *lists, prep["fbox"], res,
                           prep["nsub"])
    torch.cuda.synchronize()
    k1 = rc.visibility(table, prep["orig"], *lists, prep["fbox"], res,
                       prep["nsub"])
    want = rc.visibility_reference(prep["table"], prep["orig"], *lists, res,
                                   prep["nsub"])
    return got, k1, want


def _misaligned(t):
    """A copy of `t` 4 bytes past a 16-byte boundary: the kernels stage it
    with plain loads (mode 0)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


# (scene, chunk, nsub) with sub-blocks of whole 32-face runs: of 32, 64
# and 1,024 faces (a bulk copy a row, mode 1; the others a tensor box,
# mode 2), nsub 1, 4 and 8, the invalid and empty faces, a face larger
# than the tile, and the slivers (most tiles empty)
K2_CASES = [(_random, 256, 8), (_random, 256, 4), (_depth_stack_copies, 32, 1),
            (_sphere, 256, 8), (_sphere, 1024, 1), (_big_and_small, 256, 8),
            (_sliver, 1024, 8)]


@pytest.mark.parametrize("make,chunk,nsub", K2_CASES,
                         ids=[f"{m.__name__[1:]}-{c}-{n}"
                              for m, c, n in K2_CASES])
def test_visibility_v4_kernel_equals_plain_version_and_k1(card, make, chunk,
                                                          nsub):
    """K2: face_id, z and the chunk flags identical bit for bit to the plain
    version (`visibility_reference`) and to K1 on the same inputs; one
    launch counted per call."""
    prep, res = _prep(card, make, 3, chunk=chunk, nsub=nsub, variant=4)
    launches = rc.visibility_v4.launches
    got, k1, want = _k2_k1_plain(prep, res)
    assert rc.visibility_v4.launches == launches + 1
    assert int((want[1] > 0).sum()) > 0
    for a, b, c in zip(got, want, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    if make is _big_and_small:
        assert int((want[1] == 1501).sum()) > 100
    if make is _sliver:
        assert int((prep["counts"] == 0).sum()) > 0


@pytest.mark.parametrize("smem", [0, None])
@pytest.mark.parametrize("mode", ["plain loads", "copies"])
@pytest.mark.parametrize("make,chunk,nsub", [
    (_random, 256, 8), (_sphere, 1024, 1), (_holes, 128, 4),
    (_big_and_small, 256, 8), (_depth_stack_copies, 32, 1)])
def test_visibility_v4_kernel_staging_modes_and_rings(card, monkeypatch,
                                                      make, chunk, nsub,
                                                      mode, smem):
    """K2 and K1 with their rows staged by plain loads (a table 4 bytes
    off a 16-byte boundary, mode 0) or by the copy engine (a tensor box,
    mode 2, or at 1,024 faces a bulk copy a row, mode 1), with a ring of
    one slot (no shared memory to spare) and of the default depth: the
    outputs are the plain version's bit for bit, with invalid and empty
    faces and a face larger than the tile."""
    if smem is not None:
        monkeypatch.setattr(rc, "K1_SMEM", smem)
    prep, res = _prep(card, make, 5, chunk=chunk, nsub=nsub, variant=4)
    table = _misaligned(prep["table"]) if mode == "plain loads" else None
    got, k1, want = _k2_k1_plain(prep, res, table)
    for a, b, c in zip(got, want, k1):
        assert torch.equal(a, b) and torch.equal(a, c)
    if make is _holes:
        empty = (prep["fbox"][..., 0] > prep["fbox"][..., 1])
        assert int(empty.sum()) > 0


def test_visibility_v4_kernel_rejects_bad_inputs(card):
    """Run bases off the card, of another type or length, in place of the
    slot ids, and sub-blocks that are not whole runs raise before any
    launch."""
    prep, res = _prep(card, _random, 4, chunk=256, variant=4)
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"],
             prep["fbox"])
    launches = rc.visibility_v4.launches
    bb = prep["bbase"]
    for bad in (bb.cpu(), bb.long(), bb[:-1].contiguous(), prep["orig"]):
        with pytest.raises(ValueError):
            rc.visibility_v4(prep["table"], bad, *lists, res, prep["nsub"])
    with pytest.raises(ValueError):
        rc.visibility_v4(prep["table"], bb, *lists, res, 16)
    assert rc.visibility_v4.launches == launches


def _v6(prep, res):
    """K3 and its plain version on a variant-6 prep."""
    args = (prep["table"], prep["orig"], prep["units"], prep["counts6"],
            prep["zu"])
    got = rc.visibility_v6(*args, prep["fbox"], prep["ubox"], res,
                           prep["nsub"])
    torch.cuda.synchronize()
    return got, rc.visibility_v6_reference(*args, res, prep["nsub"])


def _empty_units(prep):
    ub = prep["ubox"]
    return int(((ub[..., 0] > ub[..., 1]) | (ub[..., 2] > ub[..., 3])).sum())


# (scene, nsub): units of 16 faces (chunk 128) and of 64 (chunk 128, nsub
# 2), the depth stack's units of one face, the sphere's of 32 and 128, the
# slivers' of 128 and the invalid and empty faces' of 16
V6_CASES = [(_random, 8), (_random, 2), (_depth_stack, 2), (_sphere, 8),
            (_sphere, 2), (_sliver, 8), (_holes, 8)]


@pytest.mark.parametrize("cap", [128, 2, 1])
@pytest.mark.parametrize("make,nsub", V6_CASES,
                         ids=[f"{m.__name__[1:]}-{n}" for m, n in V6_CASES])
def test_visibility_v6_kernel_equals_plain_version(card, make, nsub, cap):
    """K3: face_id, z and the slot flags identical bit for bit to
    `visibility_v6_reference`, with the unit lists capped at 128, at 2
    (most tiles overflow) and at 1 (every tile with more than one unit
    does); on the random, depth-stack and sphere scenes at caps 128 and 2
    z and face_id identical to K1's too (they hold no face whose depth
    falls below its unit's z-min, and no sliver that reaches a pixel
    outside its vertex bbox); one launch counted per call."""
    prep, res = _prep(card, make, 3, nsub=nsub, variant=6, v6_cap=cap)
    launches = rc.visibility_v6.launches
    got, want = _v6(prep, res)
    assert rc.visibility_v6.launches == launches + 1
    assert int((want[1] > 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if (make, nsub) in ((_random, 8), (_depth_stack, 2), (_sphere, 8)) \
            and cap > 1:
        k1 = rc.visibility(prep["table"], prep["orig"], prep["order"],
                           prep["counts"], prep["masks"], prep["zlo"],
                           prep["fbox"], res, prep["nsub"])
        assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
    if cap < 128:
        assert int((prep["counts6"] > prep["S"]).sum()) > 0
    if make is _holes:
        assert 0 < _empty_units(prep) < prep["ubox"].shape[1] * 2


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("smem", [0, 8 * 1024, 24 * 1024, 64 * 1024])
@pytest.mark.parametrize("make,nsub,cap", [(_random, 8, 2), (_sphere, 8, 4),
                                           (_big_and_small, 8, 2),
                                           (_holes, 8, 128)])
def test_visibility_v6_kernel_splits_and_rings(card, monkeypatch, make, nsub,
                                               cap, split, smem):
    """K3 with every split of an overflow tile over a cluster of blocks
    (1, 2, 4, 8) and rings from one slot (no shared memory to spare) to
    the most (`MAX_RING`, 16): the outputs are the plain version's bit for
    bit."""
    monkeypatch.setattr(rc, "K3_SPLIT", split)
    monkeypatch.setattr(rc, "K3_SMEM", smem)
    chunk = 256 if make is _big_and_small else None
    kw = {"chunk": chunk} if chunk else {}
    prep, res = _prep(card, make, 5, nsub=nsub, variant=6, v6_cap=cap, **kw)
    got, want = _v6(prep, res)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert make is _holes or int((prep["counts6"] > prep["S"]).sum()) > 0


@pytest.mark.parametrize("make,nsub", [(_random, 8), (_depth_stack, 2),
                                       (_sliver, 8), (_holes, 8)])
def test_cull_units_equals_unit_boxes(card, make, nsub):
    """The fused launch's unit boxes equal `unit_boxes`' bit for bit, and
    its face boxes `cull_boxes`'; `prepare` makes both for variant 6 with
    one launch of `cull_units` and none of `cull`."""
    cull, units = rc.cull.launches, rc.cull_units.launches
    prep, res = _prep(card, make, 3, nsub=nsub, variant=6)
    assert (rc.cull.launches, rc.cull_units.launches) == (cull, units + 1)
    assert torch.equal(prep["fbox"], rc.cull_boxes(prep["table"], res))
    sub = prep["table"].shape[-1] // prep["nsub"]
    want = rc.unit_boxes(prep["fbox"], sub, res)
    assert torch.equal(prep["ubox"], want)
    fbox, ubox = rc.cull_units(prep["table"], res, sub)
    assert torch.equal(fbox, prep["fbox"]) and torch.equal(ubox, want)
    if make is _holes:
        assert _empty_units(prep) > 0


# (chunk, nsub): units of 128 faces (the full width's: a warp a unit, 4
# slots a lane), of 512 (16 a lane), of 12 (not a divisor of the warp: 2
# units a warp, 8 lanes idle), of 8 (4 a warp), and chunk 2 (nsub falls
# back to 1: variant 3 only, the fused launch at units of the whole chunk,
# 16 a warp)
FUSED_SHAPES = [(1024, 8), (1024, 2), (96, 8), (128, 16), (2, 8)]


@pytest.mark.parametrize("chunk,nsub", FUSED_SHAPES,
                         ids=[f"{c}-{n}" for c, n in FUSED_SHAPES])
@pytest.mark.parametrize("make", [_random, _depth_stack, _sphere,
                                  _big_and_small, _sliver, _holes])
def test_fused_cull_kernel_equals_plain_versions(card, make, chunk, nsub):
    """Both instantiations of the cull kernel against both plain versions,
    bit for bit: `cull` against `cull_boxes`, `cull_units` against
    `cull_boxes` and `unit_boxes`; variant 6's prep with one launch of
    `cull_units` and none of `cull`. The visibility kernel that reads the
    boxes (K1, and K3 for variant 6) gives its plain version's outputs."""
    prep, res = _prep(card, make, 3, chunk=chunk, nsub=nsub)
    table = prep["table"]
    sub = chunk // prep["nsub"]
    fbox = rc.cull_boxes(table, res)
    ubox = rc.unit_boxes(fbox, sub, res)
    assert torch.equal(prep["fbox"], fbox)
    assert torch.equal(rc.cull(table, res), fbox)
    got = rc.cull_units(table, res, sub)
    assert torch.equal(got[0], fbox) and torch.equal(got[1], ubox)
    lists = (table, prep["orig"], prep["order"], prep["counts"],
             prep["masks"], prep["zlo"])
    if chunk >= 96:
        k1 = rc.visibility(*lists, prep["fbox"], res, prep["nsub"])
        want = rc.visibility_reference(*lists, res, prep["nsub"])
        for a, b in zip(k1, want):
            assert torch.equal(a, b)
    if prep["nsub"] == 1:
        return
    cull, units = rc.cull.launches, rc.cull_units.launches
    p6, res = _prep(card, make, 3, chunk=chunk, nsub=nsub, variant=6)
    assert (rc.cull.launches, rc.cull_units.launches) == (cull, units + 1)
    assert torch.equal(p6["fbox"], fbox) and torch.equal(p6["ubox"], ubox)
    if chunk >= 96:
        for a, b in zip(*_v6(p6, res)):
            assert torch.equal(a, b)


def test_cull_kernels_reject_bad_inputs(card):
    """A table off the card or of the wrong type or layout, and units that
    do not divide a chunk, raise before any launch."""
    prep, res = _prep(card, _random, 4)
    table = prep["table"]
    launches = (rc.cull.launches, rc.cull_units.launches)
    for bad in (table.double(), table[..., ::2]):
        with pytest.raises(ValueError):
            rc.cull(bad, res)
        with pytest.raises(ValueError):
            rc.cull_units(bad, res, 16)
    for sub in (0, 3, 256):
        with pytest.raises(ValueError):
            rc.cull_units(table, res, sub)
    assert (rc.cull.launches, rc.cull_units.launches) == launches


def test_visibility_v6_kernel_rejects_bad_inputs(card, monkeypatch):
    """Boxes off the card or of the wrong type or shape, and a split that
    is not 1, 2, 4 or 8, raise before any launch."""
    prep, res = _prep(card, _random, 4, variant=6)
    args = (prep["table"], prep["orig"], prep["units"], prep["counts6"],
            prep["zu"])
    launches = rc.visibility_v6.launches
    for fbox, ubox in ((prep["fbox"].cpu(), prep["ubox"]),
                       (prep["fbox"], prep["ubox"].int()),
                       (prep["fbox"], prep["ubox"][:, :-1].contiguous())):
        with pytest.raises(ValueError):
            rc.visibility_v6(*args, fbox, ubox, res, prep["nsub"])
    monkeypatch.setattr(rc, "K3_SPLIT", 3)
    with pytest.raises(ValueError):
        rc.visibility_v6(*args, prep["fbox"], prep["ubox"], res,
                         prep["nsub"])
    assert rc.visibility_v6.launches == launches


def _winner_ids(rng, B, H, W, Fn):
    """1-based winner ids (B, H·W) int32 in raster order as a render gives
    them: runs of one to twelve pixels with one winner along each row, a
    third of the image background, a few ids beyond the Fn faces (also
    background for K5); tile 0 all background and tile 1 won whole by
    one face."""
    n = B * H * W
    lens = rng.integers(1, 13, n)
    ids = rng.integers(1, Fn + 1, n)
    ids[rng.uniform(size=n) < 0.33] = 0
    ids[rng.uniform(size=n) < 0.01] = Fn + 7
    fid = np.repeat(ids, lens)[:n].reshape(B, H, W)
    fid[:, :16, :32] = 0
    fid[:, :16, 32:64] = 3
    return fid.reshape(B, H * W).astype(np.int32)


@pytest.mark.parametrize("res", [(64, 96), (256, 256)])
@pytest.mark.parametrize("B", [1, 10])
@pytest.mark.parametrize("R", [1, 3, 41, 42, 64])
def test_resolve_fwd_kernel_equals_plain_version(card, R, B, res):
    """K5: the rows equal the plain version's exactly (a copy of a float),
    zero on background, at an odd R (4-byte loads), an even one (8-byte),
    and more channels than a slice of the transpose (64); with a tile of
    all background and a tile that one face wins whole; one launch
    counted per call."""
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    rng = np.random.default_rng(6)
    H, W = res
    Fn = 700
    fid = torch.as_tensor(_winner_ids(rng, B, H, W, Fn), device=card)
    pf = torch.as_tensor(rng.normal(size=(B, Fn, R)).astype(np.float32),
                         device=card)
    n = rv.resolve_fwd.launches
    got = rv.resolve_fwd(pf, fid, (H, W))
    torch.cuda.synchronize()
    assert rv.resolve_fwd.launches == n + 1
    want = rv.resolve_fwd_reference(pf, fid, (H, W))
    assert torch.equal(got, want)
    bg = rv.to_tile_order(((fid == 0) | (fid > Fn))[..., None], (H, W))[:, 0]
    assert not got[bg[:, None].expand_as(got)].any()
    assert not got[:, :, :rv.TP].any()                    # tile 0
    assert torch.equal(got[:, :, rv.TP:2 * rv.TP],
                       pf[:, 2, :, None].expand(B, R, rv.TP))


@pytest.mark.parametrize("offset", [False, True],
                         ids=["aligned", "4_bytes_off"])
def test_resolve_fwd_kernel_block_rows_and_alignment(card, offset):
    """K5 on rows that are 8-byte aligned and on rows 4 bytes off (pf a
    float past an 8-byte boundary: 4-byte loads at an even R), over tiles
    of two blocks of 8 tile rows each: the plain version's rows bit for
    bit."""
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    rng = np.random.default_rng(7)
    B, H, W, R, Fn = 2, 64, 96, 42, 300
    fid = torch.as_tensor(_winner_ids(rng, B, H, W, Fn), device=card)
    pf = torch.as_tensor(rng.normal(size=(B, Fn, R)).astype(np.float32),
                         device=card)
    want = rv.resolve_fwd_reference(pf, fid, (H, W))
    if offset:
        buf = torch.empty(pf.numel() + 1, device=card)
        x = buf[1:].view(pf.shape)
        x.copy_(pf)
        assert x.data_ptr() % 8 != 0
    else:
        x = pf
        assert x.data_ptr() % 8 == 0
    assert torch.equal(rv.resolve_fwd(x, fid, (H, W)), want)


# ---------------------------------------------------------------------------
# the training loop, the test path and checkpoints on the card
# ---------------------------------------------------------------------------

CARD_CLI_OVERRIDES = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "dataset.batch_size=2", "dataset.num_workers=2", "dataset.dino_feature_dim=4",
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=256",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
    "use_logger=false", "log_loss_freq=1", "mixed_precision=false"]


def _synth_folders(root):
    pytest.importorskip("PIL")
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    write_synth_dataset(str(root / "train"), n=4, size=64, dino_dim=4)
    write_synth_dataset(str(root / "test"), n=3, size=64, dino_dim=4, seed=1)
    return str(root / "train"), str(root / "test")


def test_train_and_test_paths_on_card(card, tmp_path):
    """`run.main` on the card (its default device) at a small width: two
    training iterations write checkpoint 2 with finite losses, the test
    config loads it by name and writes mesh, image and pose files for
    every test image; the kernels of each path launch."""
    import json
    import os
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    from animals3d_tpu_torch.precision import set_mixed_precision
    train, test = _synth_folders(tmp_path)
    ckpt_dir = str(tmp_path / "ckpt")
    kernels = (rc.cull, rc.visibility, fm.fused_mlp_fwd, fm.fused_mlp_bwd,
               rv.resolve_bwd)
    counts = [k.launches for k in kernels]
    try:
        trainer = run.main(["--config-name", "train_magicpony_horse",
                            *CARD_CLI_OVERRIDES,
                            f"dataset.train_data_dir={train}",
                            "dataset.val_data_dir=null",
                            f"checkpoint_dir={ckpt_dir}", "num_iters=2"])
        assert trainer.model.device.type == "cuda"
        assert [k.launches - c for k, c in zip(kernels, counts)] == [2] * 5
        with open(os.path.join(ckpt_dir, "metrics.json")) as f:
            losses = [m["loss"] for m in json.load(f)["train"]]
        assert len(losses) == 2 and np.isfinite(losses).all()
        counts = [k.launches for k in kernels]
        run.main(["--config-name", "test_magicpony_horse",
                  *CARD_CLI_OVERRIDES, f"dataset.test_data_dir={test}",
                  f"checkpoint_dir={ckpt_dir}",
                  "checkpoint_name=checkpoint0000002.pth"])
        # two test batches (2 + 1 images), one render each
        assert [k.launches - c for k, c in zip(kernels, counts)] == \
            [2, 2, 0, 0, 0]
    finally:
        set_mixed_precision(None)
    files = os.listdir(os.path.join(ckpt_dir, "test_results_0000002"))
    for suffix in ("_mesh.obj", "_image_pred.png", "_pose.txt"):
        assert sum(f.endswith(suffix) for f in files) == 3, suffix


def test_checkpoint_round_trip_on_card(card, tmp_path):
    """A checkpoint of a model and its optimizers after a step on the card
    reloads onto the card: every parameter, Adam moment and step count
    equal bit for bit, on the parameters' device."""
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    cfg = cfglib.load_config("train_magicpony_horse",
                             overrides=CARD_CLI_OVERRIDES)
    mcfg = dict(cfg["model"], dataset=cfg["dataset"])
    model = build_model(mcfg, device="cuda")
    model.init_params(0)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    train_step(model, opt, fake_batch(model, 2), 50000, gen)
    ckpt.save_checkpoint(str(tmp_path), 7,
                         {"model": model.state_dict(), **opt.state_dict()})
    other = build_model(mcfg, device="cuda")
    other.init_params(1)
    opt2 = make_optimizer(other)
    assert ckpt.load_checkpoint(str(tmp_path), other, opt2,
                                map_location="cuda") == 7
    for k, v in model.state_dict().items():
        w = other.state_dict()[k]
        assert w.device.type == "cuda" and torch.equal(w, v), k
    for name, o in opt.optimizers.items():
        want, got = o.state_dict()["state"], opt2.optimizers[name] \
            .state_dict()["state"]
        assert set(got) == set(want)
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(got[i][k].to(v.device), v), (name, i, k)
                if k != "step":
                    assert got[i][k].device.type == "cuda"


# ---------------------------------------------------------------------------
# 3D-Fauna at a small width
# ---------------------------------------------------------------------------

FAUNA_CARD_OVERRIDES = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "dataset.batch_size=2", "dataset.dino_feature_dim=4",
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_base.cfg_bank.memory_bank_size=14",
    "+model.cfg_predictor_base.cfg_bank.memory_bank_topk=3",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.num_layers=2",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.num_layers=1",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.num_layers=2",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32"]


def _fauna(overrides=()):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfglib.load_config("train_fauna", overrides=FAUNA_CARD_OVERRIDES
                             + list(overrides))
    model = build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                        device="cuda")
    model.init_params(0)
    return model


def _fauna_batch(model):
    from animals3d_tpu_torch.data.synth import fake_batch
    batch = fake_batch(model, 2)
    batch["bboxs"] = torch.zeros((2, 1, 9), device="cuda")
    return batch


def _fauna_kernels():
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    return (rc.cull, rc.visibility, rv.resolve_bwd, fm.fused_mlp_fwd,
            fm.fused_mlp_bwd)


def test_fauna_step_and_recon_on_card(card):
    """A float32 Fauna `train_step` inside the discriminator window, then
    its `disc_step`, and a `reconstruct` through the bank, on the card: per
    step the cull kernel and K1 twice (input and random view), K4 once,
    K6 and K7 never (the modulated SDF keeps the fused sweep off); the
    generator step moves netBase (the bank among it) and netInstance but
    not netDisc, the discriminator step moves netDisc alone; per recon
    the cull kernel and K1 once."""
    from animals3d_tpu_torch.trainer import (disc_step, make_optimizer,
                                             train_step)
    model = _fauna()
    batch = _fauna_batch(model)
    kernels = _fauna_kernels()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    counts = [k.launches for k in kernels]
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    met = train_step(model, opt, batch, 100000, gen)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == \
        [2, 2, 1, 0, 0]
    assert np.isfinite(float(met["loss"])) and "mask_disc_loss" in met
    mid = {k: v.clone() for k, v in model.state_dict().items()}
    for k, v in mid.items():
        moved = not torch.equal(v, before[k])
        if k.startswith("netDisc.") or ".ViT." in k:
            assert not moved, k
    assert not torch.equal(mid["netBase.memory_bank"],
                           before["netBase.memory_bank"])
    loss = disc_step(model, opt, met["_disc_record"])
    assert np.isfinite(float(loss))
    for k, v in model.state_dict().items():
        assert torch.equal(v, mid[k]) != k.startswith("netDisc."), k
    counts = [k.launches for k in kernels]
    images = batch["images"]
    shaded, out = model.reconstruct(model, images, 100000)
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == \
        [1, 1, 0, 0, 0]
    assert shaded.shape == (2, 4, 64, 64)
    assert bool(torch.isfinite(shaded).all()) and float(shaded[:, 3].sum()) > 0


def test_kernels_on_a_fauna_random_view_equal_plain_versions(card):
    """K1 and the cull kernel bit for bit their plain versions on the
    random view's posed meshes of a Fauna step (cameras from any azimuth
    about the predicted translation), and K4 within 1e-5 of the largest
    entry on the step's own cotangent."""
    import animals3d_tpu_torch.ops.rasterize as ro
    import animals3d_tpu_torch.render.render as rr
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    model = _fauna()
    batch = _fauna_batch(model)
    scenes, calls = [], []
    real_r, real_b = rr.rasterize_cuda, ro.resolve_bwd

    def rast(v_clip, faces, f_valid, res, **kw):
        scenes.append((v_clip.detach().clone(), kw["v_pos0"].detach(),
                       faces, f_valid, res))
        return real_r(v_clip, faces, f_valid, res, **kw)

    def bwd(g, face_id, num_faces):
        calls.append((g.detach().clone(), face_id.clone(), num_faces))
        return real_b(g, face_id, num_faces)
    rr.rasterize_cuda, ro.resolve_bwd = rast, bwd
    try:
        gen = torch.Generator(device="cuda").manual_seed(3)
        loss, _ = model.forward(batch, 100000, gen)
        loss.backward()
    finally:
        rr.rasterize_cuda, ro.resolve_bwd = real_r, real_b
    assert len(scenes) == 2 and len(calls) == 1
    for v_clip, v0, faces, f_valid, res in scenes:
        prep = rc.prepare(v_clip, v0, faces, f_valid, res)
        assert torch.equal(prep["fbox"], rc.cull_boxes(prep["table"], res))
        args = (prep["table"], prep["orig"], prep["order"], prep["counts"],
                prep["masks"], prep["zlo"])
        got = rc.visibility(*args, prep["fbox"], res, prep["nsub"])
        want = rc.visibility_reference(*args, res, prep["nsub"])
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert int((got[1] > 0).sum()) > 0
    g, fid, Fn = calls[0]
    got = rv.resolve_bwd(g, fid, Fn)
    want = rv.resolve_bwd_reference(g, fid, Fn)
    assert float((got - want).abs().max()) <= \
        1e-5 * float(want.abs().max())


def test_fauna_checkpoint_round_trip_with_the_disc_adam_on_card(card,
                                                                tmp_path):
    """A Fauna checkpoint after a generator and a discriminator step on the
    card reloads onto the card: the model (netDisc and the bank among it)
    and the generator optimizers' state bit for bit; the `disc` Adam's
    state is saved but starts afresh on load, as the JAX trainer's."""
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch.trainer import (disc_step, make_optimizer,
                                             train_step)
    model = _fauna()
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    met = train_step(model, opt, _fauna_batch(model), 100000, gen)
    disc_step(model, opt, met["_disc_record"])
    ckpt.save_checkpoint(str(tmp_path), 100001,
                         {"model": model.state_dict(), **opt.state_dict()})
    other = _fauna()
    other.init_params(1)
    opt2 = make_optimizer(other)
    assert ckpt.load_checkpoint(str(tmp_path), other, opt2,
                                map_location="cuda") == 100001
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    want_all, got_all = opt.state_dict()["optimizer"], \
        opt2.state_dict()["optimizer"]
    assert set(want_all) == {"base", "instance", "disc"}
    assert want_all["disc"]["state"] and not got_all["disc"]["state"]
    for name, sd in want_all.items():
        if name == "disc":
            continue
        assert set(got_all[name]["state"]) == set(sd["state"]) != set()
        for i, st in sd["state"].items():
            for k, v in st.items():
                assert torch.equal(got_all[name]["state"][i][k]
                                   .to(v.device), v), (name, i, k)


# ---------------------------------------------------------------------------
# Ponymation at a small width
# ---------------------------------------------------------------------------

PONY_CARD_OVERRIDES = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "dataset.batch_size=1", "dataset.num_frames=3",
    "dataset.num_workers=2", "dataset.dino_feature_dim=4",
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=256",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
    "model.cfg_predictor_instance.cfg_deform.hidden_size=32",
    "model.cfg_predictor_instance.cfg_motion_vae.latent_dim=32",
    "+model.cfg_predictor_instance.cfg_motion_vae.transformer_layer_num=1",
    "use_logger=false", "log_loss_freq=1", "mixed_precision=false"]


def _pony(config):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    cfg = cfglib.load_config(config, overrides=PONY_CARD_OVERRIDES)
    model = build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                        device="cuda")
    model.init_params(0)
    return model


def _pony_kernels():
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    return (rc.cull, rc.visibility, rv.resolve_bwd, fm.fused_mlp_fwd,
            fm.fused_mlp_bwd)


def _moved(before, model):
    return {".".join(k.split(".")[:2]) for k, v in model.state_dict().items()
            if v.is_floating_point() and not torch.equal(v, before[k])}


def test_pony_steps_and_generate_on_card(card):
    """Ponymation at a small width in float32 on the card. A stage-1 step
    at spp 4 (64² images, 256² visibility): the cull kernel, K1, K6 and K4
    once, K7 never (netBase is frozen), only netArticulation moved. A
    stage-2 step: K6 alone (no render), only netVAE moved. Stage 2's eval
    forward (`generate`): the cull kernel and K1 once, 3 generated frames
    of a finite mask."""
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    kernels = _pony_kernels()
    for config, want, net in (
            ("train_ponymation_horse_stage1", [1, 1, 1, 1, 0],
             "netInstance.netArticulation"),
            ("train_ponymation_horse_stage2", [0, 0, 0, 1, 0],
             "netInstance.netVAE")):
        model = _pony(config)
        batch = fake_batch(model, 1 if "stage1" in config else 2)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model)
        assert set(opt.optimizers) == {"instance"}
        gen = torch.Generator(device="cuda").manual_seed(0)
        counts = [k.launches for k in kernels]
        met = train_step(model, opt, batch, 100000, gen)
        torch.cuda.synchronize()
        assert [k.launches - c for k, c in zip(kernels, counts)] == want
        assert np.isfinite(float(met["loss"]))
        assert _moved(before, model) == {net}
    counts = [k.launches for k in kernels]
    with torch.no_grad():
        _l, (_m, aux) = model.forward(batch, 100000, gen,
                                      model.phase_for_iter(100000, False))
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == \
        [1, 1, 0, 0, 0]
    assert aux["mask_pred"].shape == (1, 3, 64, 64)
    assert bool(torch.isfinite(aux["mask_pred"]).all())


def test_pony_cli_warm_start_chain_on_card(card, tmp_path):
    """The port's CLI on a synthetic sequence tree at a small width: stage
    1 resumed at 100,000 from a MagicPony checkpoint the port writes (2
    steps), stage 2 from stage 1's checkpoint (2 steps; netVAE kept at
    init), a resume of stage 2 with every Adam state tensor restored bit
    for bit, and stage 1's test with flows loaded and rendered writing
    `_flow_gt.png` and `_flow_pred.png`."""
    import os
    import shutil
    pytest.importorskip("PIL")
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.trainer import make_optimizer
    tree = write_synth_dataset(str(tmp_path / "seq"), size=64, dino_dim=4,
                               sequences=2, frames=4)
    s1, s2 = str(tmp_path / "s1"), str(tmp_path / "s2")
    cfg = cfglib.load_config("train_magicpony_horse",
                             overrides=CARD_CLI_OVERRIDES)
    mp = build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                     device="cuda")
    mp.init_params(0)
    ckpt.save_checkpoint(s1, 100000, {"model": mp.state_dict(),
                                      **make_optimizer(mp).state_dict()})
    common = PONY_CARD_OVERRIDES + [f"dataset.train_data_dir={tree}",
                                    "dataset.val_data_dir=null",
                                    "checkpoint_path=null"]
    try:
        t1 = run.main(["--config-name", "train_ponymation_horse_stage1",
                       f"checkpoint_dir={s1}", "num_iters=100002"] + common)
        assert t1.start_iter == 100000
        os.makedirs(s2)
        shutil.copy(os.path.join(s1, "checkpoint0100002.pth"), s2)
        stage2 = ["--config-name", "train_ponymation_horse_stage2",
                  f"checkpoint_dir={s2}", "dataset.batch_size=2"] + common
        t2 = run.main(stage2 + ["num_iters=100004"])
        assert t2.start_iter == 100002
        losses = [m["loss"] for m in t2.metrics_trace.data["train"]]
        assert len(losses) == 2 and np.isfinite(losses).all()
        saved = ckpt.read_checkpoint(os.path.join(s2,
                                                  "checkpoint0100004.pth"))
        _c, _m, tr = run.build(stage2 + ["num_iters=100005"])
        opt, start = tr.restore()
        assert start == 100004 and set(opt.optimizers) == {"instance"}
        want = saved["optimizer"]["instance"]["state"]
        got = opt.optimizers["instance"].state_dict()["state"]
        assert set(got) == set(want) != set()
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(got[i][k].cpu(), v), (i, k)
        run.main(stage2 + ["num_iters=100005"])
        run.main(["--config-name", "train_ponymation_horse_stage1",
                  f"checkpoint_dir={s1}", "run_train=false", "run_test=true",
                  f"dataset.test_data_dir={tree}", "dataset.load_flow=true",
                  "model.cfg_render.render_flow=true"] + common
                 + ["dataset.train_data_dir=null"])
    finally:
        set_mixed_precision(None)
    files = os.listdir(os.path.join(s1, "test_results_0100002"))
    assert any(f.endswith("_flow_gt.png") for f in files)
    assert any(f.endswith("_flow_pred.png") for f in files)


# ---------------------------------------------------------------------------
# the render modes and the Visualizer on the card
# ---------------------------------------------------------------------------

VIS_MODES = ["input_view", "other_views", "rotation", "animation",
             "canonicalization"]
# `chip_smoke.py`'s VIS_REF_OVERRIDES: the netSDF at its full depth and
# width (5 × 256), the rest narrow
VIS_CARD_OVERRIDES = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32"]


def _flip_share(got, want, tol):
    """The largest share of an image's pixels with a channel beyond
    `tol`: those whose winning face flips on rounding between the card
    and the CPU, and their antialiased neighbours."""
    bad = (np.abs(np.asarray(got) - np.asarray(want)) > tol).any(-3)
    return float(bad.reshape(-1, *bad.shape[-2:]).mean((1, 2)).max())


def test_render_modes_on_card_equal_cpu(card):
    """Every render mode (`kd`, `ks`, `normal`, `geo_normal`, `shading`,
    `depth` and `tangent` with `shaded`) of a small model's prior from two
    cameras at spp 1 and 2, on the card against the CPU: within 2e-3 but
    at most 1% of an image's pixels."""
    import dataclasses
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.geometry.mesh import compute_tangents
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfglib.load_config("test_magicpony_horse",
                             overrides=CARD_CLI_OVERRIDES)
    model_cfg = dict(cfg["model"], dataset=cfg["dataset"])
    gpu = build_model(model_cfg, device="cuda")
    gpu.init_params(0)
    cpu = build_model(model_cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    modes = ["shaded", "kd", "ks", "normal", "geo_normal", "shading",
             "depth", "tangent"]
    r = np.random.default_rng(0)
    ang = np.asarray([0.4, 2.3], np.float32)
    c, s_ = np.cos(ang), np.sin(ang)
    z, o = np.zeros_like(ang), np.ones_like(ang)
    pose = np.concatenate([np.stack([c, z, s_, z, o, z, -s_, z, c], -1),
                           [[0.1, -0.2, 0.3], [-0.2, 0.1, 0.0]]], -1)
    feat = r.uniform(-1, 1, (2, 32)).astype(np.float32)
    light = np.asarray([[0.3, 0.8, 0.5, 0.3, 0.6], [-0.6, 0.6, 0.5, 0.4,
                                                     0.5]], np.float32)
    out = {}
    for name, m in (("cuda", gpu), ("cpu", cpu)):
        dev = m.device
        grid, v_cap, f_cap = m.grid_for_phase(m.phase_for_iter(50000))
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        with torch.no_grad():
            prior, _ = m.netBase(grid, v_cap, f_cap)
            uvs = torch.from_numpy(np.random.default_rng(3).uniform(
                0, 1, (prior.t_pos_idx.shape[0], 3, 2)).astype(
                np.float32)).to(dev)
            prior = dataclasses.replace(prior, v_tng=compute_tangents(
                prior.v_pos, prior.t_pos_idx, uvs, prior.v_nrm,
                prior.v_valid, prior.f_valid))
            mvp, w2c, campos = m.netInstance.get_camera_extrinsics_from_pose(
                t(pose))
            out[name] = {spp: {k: v.cpu().numpy() for k, v in m.render(
                modes, prior, mvp, w2c, campos, (64, 64),
                im_features=t(feat), light_params=t(light), prior_mesh=prior,
                spp=spp).items()} for spp in (1, 2)}
    for spp in (1, 2):
        for k in modes:
            assert np.isfinite(out["cuda"][spp][k]).all(), k
            assert _flip_share(out["cuda"][spp][k], out["cpu"][spp][k],
                               2e-3) <= 0.01, (k, spp)


def test_visualizer_on_card_equal_cpu(card, tmp_path, monkeypatch):
    """A small float32 Visualizer run, TF32 off (`VIS_CARD_OVERRIDES`:
    grid 16, netSDF 5 × 256, 64², spp 2; every mode, two keyframe files,
    the keypoint artifacts) on the card and on the CPU from one checkpoint, as
    `chip_smoke.py`'s `vis_reference_phase` runs it: the same files, each
    frame within 2e-3 but at most 1% of its pixels (the pixels whose
    winning face flips on rounding between the two devices, and their
    antialiased neighbours), uv projections within 1e-4."""
    import os
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch import visualization as tvis
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.utils import results_io
    pytest.importorskip("PIL")
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = str(tmp_path / "data")
    write_synth_dataset(data, n=1, size=64, dino_dim=4, seed=3)
    anim = tmp_path / "anim"
    anim.mkdir()
    cfg = cfglib.load_config("test_magicpony_horse", overrides=[
        *VIS_CARD_OVERRIDES,
        f"dataset.test_data_dir={data}", f"checkpoint_dir={tmp_path}",
        "checkpoint_name=small.pth", "resolution=64", "+spp=2",
        "evaluate_keypoint=true", f"+arti_param_dir={anim}",
        "+canon_frames=5", "render_modes=[" + ",".join(VIS_MODES) + "]"])
    frames = {}
    real = results_io.save_image
    monkeypatch.setitem(sys.modules, "cv2", None)   # every frame a png
    try:
        for dev in ("cuda", "cpu"):
            frames[dev] = {}

            def save(path, img, _d=frames[dev]):
                _d[os.path.basename(path)] = np.array(
                    img.detach().cpu().numpy() if hasattr(img, "detach")
                    else img, np.float32)
                real(path, img)
            results_io.save_image = save
            vis = tvis.Visualizer(dict(cfg, output_dir=str(tmp_path / dev)),
                                  device=dev)
            if dev == "cuda":
                vis.model.init_params(0)
                torch.save({"model": vis.model.state_dict()},
                           str(tmp_path / "small.pth"))
                K = vis.model.netInstance.num_bones
                for i, deg in enumerate((0.0, 20.0)):
                    np.savetxt(str(anim / f"arti_params_{i:02d}.txt"),
                               np.full((K, 3), deg))
            vis.run()
    finally:
        results_io.save_image = real
    assert sorted(os.listdir(tmp_path / "cuda")) == \
        sorted(os.listdir(tmp_path / "cpu"))
    assert sorted(frames["cuda"]) == sorted(frames["cpu"])
    shares = {name: _flip_share(frames["cuda"][name][None], want[None],
                                2e-3) for name, want in frames["cpu"].items()}
    print(f"visualizer card against CPU: {len(shares)} frames, at most "
          f"{100 * max(shares.values()):.3f}% of a frame's pixels off")
    assert max(shares.values()) <= 0.01, {k: v for k, v in shares.items()
                                          if v > 0.01}
    uv = [np.loadtxt(str(tmp_path / d / "0000000_2d_projection_uv.txt"))
          for d in ("cuda", "cpu")]
    np.testing.assert_allclose(uv[0], uv[1], atol=1e-4, rtol=0)


def test_png_codec_round_trip(tmp_path):
    """The numpy/zlib PNG codec the port reads its 16-bit flows with (the
    port does not require cv2): `png_write` then `png_read` returns the
    array, 8- and 16-bit, 1 to 4 channels; PIL decodes the 8-bit files to
    the same array; the flow loader maps 0 and 65535 to -1 and 1. Needs
    no card."""
    from animals3d_tpu_torch.data import util
    r = np.random.default_rng(0)
    for dtype in (np.uint8, np.uint16):
        for ch in (1, 2, 3, 4):
            a = (r.uniform(0, 1, (13, 21, ch))
                 * np.iinfo(dtype).max).astype(dtype)
            path = str(tmp_path / f"{dtype.__name__}_{ch}.png")
            util.png_write(path, a)
            np.testing.assert_array_equal(util.png_read(path), a)
            if dtype == np.uint8 and ch in (1, 3, 4):
                PIL = pytest.importorskip("PIL.Image")
                b = np.asarray(PIL.open(path))
                np.testing.assert_array_equal(b.reshape(a.shape), a)
    flow = np.zeros((4, 5, 3), np.uint16)
    flow[..., 1] = 65535
    path = str(tmp_path / "flow.png")
    util.png_write(path, flow)
    got = util.flow_loader(path)
    assert got.shape == (2, 4, 5)
    np.testing.assert_array_equal(got[0], -1.0)
    np.testing.assert_array_equal(got[1], 1.0)


def _kuhn_npz_grid(res, jitter=0.1, seed=0):
    """A general `TetGrid`: the Kuhn lattice of `res` with its interior
    vertices moved by seeded uniform offsets of at most `jitter` of the
    spacing."""
    from animals3d_tpu_torch.geometry import tets as tetlib
    verts, tets = tetlib.kuhn_lattice(res)
    off = np.random.default_rng(seed).uniform(-jitter, jitter,
                                              verts.shape) / res
    interior = (np.abs(verts) < 0.5 - 0.5 / res).all(-1)
    verts = (verts + np.where(interior[:, None], off, 0.0)) \
        .astype(np.float32)
    return tetlib.TetGrid(verts=verts, res=res, is_lattice=False, tets=tets)


def test_general_marching_tets_on_card_equals_cpu(card):
    """The npz path's edge tables (built on the card) and its mesh and
    BCE: identical to the CPU's, vertices within 1e-6."""
    from animals3d_tpu_torch.geometry import tets as tetlib
    grid = _kuhn_npz_grid(16)
    r = np.linalg.norm(grid.verts * np.asarray([1.0, 1.4, 0.8]), axis=-1)
    sdf = torch.from_numpy((0.25 - r).astype(np.float32))
    pos = torch.from_numpy(grid.verts * 5.0)
    outs, bces = [], []
    for dev in (card, torch.device("cpu")):
        g = tetlib.DeviceTetGrid(grid, dev)
        outs.append(dmtet.marching_tets(pos.to(dev), sdf.to(dev), g, 4096,
                                        8192))
        bces.append(float(dmtet.sdf_bce_for_grid(sdf.to(dev), g)))
        if dev == card:
            card_edges = g.edges.cpu()
        else:
            assert torch.equal(card_edges, g.edges)
    got, want = outs
    assert int(want.num_faces) > 0
    for k in ("faces", "v_valid", "f_valid", "face_gidx", "num_verts",
              "num_faces"):
        assert torch.equal(getattr(got, k).cpu(), getattr(want, k)), k
    assert float((got.verts.cpu() - want.verts).abs().max()) <= 1e-6
    np.testing.assert_allclose(bces[0], bces[1], rtol=1e-6)


def test_banded_sweep_on_card_equals_cpu(card):
    """`sdf_lattice_banded` of an analytic field at grid 64 and its
    gradient through the recompute: values within 1e-5, the same count,
    the gradient to a field parameter within 1e-4 relative."""
    from animals3d_tpu_torch.geometry.tets import lattice_verts
    pos = torch.from_numpy(lattice_verts(64) * 7.0)
    outs = []
    for dev in (card, torch.device("cpu")):
        a = torch.tensor(1.4, device=dev, requires_grad=True)

        def field(p):
            r = torch.linalg.norm(p * torch.tensor([1.0, 1.0, 0.6],
                                                   device=p.device), dim=-1)
            return (a - r) + 0.12 * torch.sin(p[..., 0] * 2.1) \
                * torch.cos(p[..., 1] * 1.7)
        sdf, count = dmtet.sdf_lattice_banded(field, pos.to(dev), 64)
        (sdf.clamp(-1, 1) ** 2).sum().backward()
        outs.append((sdf.detach().cpu(), int(count), float(a.grad)))
    (s_g, n_g, g_g), (s_c, n_c, g_c) = outs
    assert n_g == n_c > 0
    assert float((s_g - s_c).abs().max()) <= 1e-5
    np.testing.assert_allclose(g_g, g_c, rtol=1e-4)


def test_environment_shade_on_card_equals_cpu(card):
    """Split-sum environment shading of a cubemap of 16 and its gradient
    to the cubemap: within 1e-5 of the CPU's."""
    from animals3d_tpu_torch.render.light import environment_shade
    r = np.random.default_rng(0)
    cube = r.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32)
    n = r.normal(size=(4, 8, 8, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    pos = r.normal(size=(4, 8, 8, 3)).astype(np.float32)
    kd = r.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    ks = r.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32) * 0.5
    view = (r.normal(size=(4, 1, 1, 3)) * 4).astype(np.float32)
    outs = []
    for dev in (card, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(dev)
        c = t(cube).requires_grad_(True)
        out = environment_shade(c, t(pos), t(n), t(kd), t(ks), t(view))
        out.sum().backward()
        outs.append((out.detach().cpu(), c.grad.cpu()))
    (o_g, g_g), (o_c, g_c) = outs
    assert float((o_g - o_c).abs().max()) <= 1e-5
    assert float((g_g - g_c).abs().max()) <= 1e-5 * float(g_c.abs().max())


def test_resnet_encoder_on_card_equals_cpu(card):
    """ResnetEncoder in float32 (TF32 off) on the card against the CPU,
    the same weights: within 1e-4 of the largest output."""
    from animals3d_tpu_torch.networks.encoders import ResnetEncoder
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.precision import compute_dtype
    saved = (compute_dtype(), torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    set_mixed_precision(False)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(0)
        cpu = ResnetEncoder(6).eval()
        gpu = ResnetEncoder(6).to(card).eval()
        gpu.load_state_dict(cpu.state_dict())
        x = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (2, 3, 64, 64)).astype(np.float32))
        with torch.no_grad():
            want = cpu(x)
            got = gpu(x.to(card)).cpu()
    finally:
        set_mixed_precision("bf16" if saved[0] == torch.bfloat16 else None)
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.backends.cuda.matmul.allow_tf32 = saved[2]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


# ---------------------------------------------------------------------------
# the reference's options and data parallelism on the card
# ---------------------------------------------------------------------------

REFINE_OVERRIDES = CARD_CLI_OVERRIDES + [
    "model.cfg_predictor_instance.cfg_articulation.enable_refine=true",
    "+model.cfg_predictor_instance.cfg_articulation.refine_feature_mode="
    "dino_global+dino_sample",
    "+model.cfg_predictor_instance.cfg_articulation.predict_delta=true",
    "model.cfg_render.background_mode=input",
    "dataset.background_mode=input"]


def _model(overrides, device):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    cfg = cfglib.load_config("train_magicpony_horse", overrides=overrides)
    return build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                       device=device)


def test_refinement_forward_on_card_equals_cpu(card):
    """`forward_articulation` with refinement (a predicted delta on the
    posed bones) on the card against the same weights on the CPU, from
    the CPU's prior mesh, encoder features and cameras, float32 without
    TF32: the angles within 1e-4 (from each device's own encoder the
    ViT's float32 gap grows tenfold through each attention net); and a
    training step with the input image as the background launches the
    step's kernels once each."""
    import dataclasses
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = _model(REFINE_OVERRIDES, "cuda")
    state = {k: v.cpu() for k, v in gpu.init_params(0).items()}
    cpu = _model(REFINE_OVERRIDES, "cpu")
    cpu.load_state_dict(state)
    phase = gpu.phase_for_iter(50000, is_training=False)
    images = torch.rand((2, 1, 3, 64, 64),
                        generator=torch.Generator().manual_seed(0))
    grid, v_cap, f_cap = cpu.grid_for_phase(phase)
    with torch.no_grad():
        prior, *_ = cpu.forward_base(grid, v_cap, f_cap)
        _g, feat, _p, patch = cpu.netInstance.forward_encoder(images)
        out = cpu.netInstance(images, prior, 50000, phase)
        args = (feat, patch, out[3], out[4], 2, 1, phase)
        want = cpu.netInstance.forward_articulation(prior, *args)
        on = lambda x: x.cuda() if torch.is_tensor(x) else x
        got = gpu.netInstance.forward_articulation(
            dataclasses.replace(prior, **{
                f.name: on(getattr(prior, f.name))
                for f in dataclasses.fields(prior)}),
            *[on(a) for a in args])
    assert want[1].shape == (2, 1, 20, 3)
    assert float((got[1].cpu() - want[1]).abs().max()) <= 1e-4
    kernels = (rc.cull, rc.visibility, fm.fused_mlp_fwd, fm.fused_mlp_bwd,
               rv.resolve_bwd)
    counts = [k.launches for k in kernels]
    met = train_step(gpu, make_optimizer(gpu), fake_batch(gpu, 2), 50000,
                     torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    assert [k.launches - c for k, c in zip(kernels, counts)] == [1] * 5
    assert np.isfinite(float(met["loss"]))


def test_one_rank_nccl_step_equals_the_plain_step(card, tmp_path):
    """The training forward and backward inside a one-rank NCCL group
    (`parallel.init_distributed` from a `FileStore`) against the same
    outside it: the loss bit for bit, the reduction of one rank's
    gradients the identity bit for bit, and `train_step` runs there."""
    from animals3d_tpu_torch import parallel
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.noise import Noise
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    model = _model(CARD_CLI_OVERRIDES, "cuda")
    model.init_params(0)
    batch = fake_batch(model, 2)
    opt = make_optimizer(model)
    g = torch.Generator().manual_seed(0)
    noise = Noise(jitter_u=torch.rand((), generator=g),
                  rand_idx=torch.tensor([0, 2]),
                  best_u=torch.rand(2, generator=g))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss, _ = model.forward(batch, 50000,
                                torch.Generator(device="cuda").manual_seed(1),
                                noise=noise)
        loss.backward()
        return loss.detach(), [p.grad.clone() if p.grad is not None
                               else torch.zeros_like(p)
                               for p in opt.trained()]
    plain_loss, plain = loss_and_grads()
    try:
        parallel.init_distributed("cuda", store=str(tmp_path / "store"),
                                  rank=0, world_size=1)
        assert torch.distributed.get_backend() == "nccl"
        loss, _ = loss_and_grads()
        loss = parallel.all_reduce_metrics({"loss": loss})["loss"]
        assert float(loss) == float(plain_loss)
        for p, want in zip(opt.trained(), plain):
            p.grad = want.clone()
        parallel.all_reduce_grads(opt.trained())
        for p, want in zip(opt.trained(), plain):
            assert torch.equal(p.grad, want)
        met = train_step(model, opt, batch, 50000,
                         torch.Generator(device="cuda").manual_seed(2))
        assert np.isfinite(float(met["loss"]))
    finally:
        parallel.shutdown()
