"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips."""
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


@pytest.mark.parametrize("make", [_random, _depth_stack, _sphere])
def test_visibility_kernel_equals_plain_version(card, make):
    """face_id, z and the chunk flags identical bit for bit; one launch
    counted per call."""
    v_clip, v_pos0, faces, f_valid, res, chunk = make(
        np.random.default_rng(3))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=card)
    prep = rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                      t(f_valid, torch.bool), res, chunk)
    args = (prep["table"], prep["orig"], prep["order"], prep["counts"],
            prep["masks"], prep["zlo"], res, prep["nsub"])
    launches = rc.visibility.launches
    got = rc.visibility(*args)
    torch.cuda.synchronize()
    assert rc.visibility.launches == launches + 1
    want = rc.visibility_reference(*args)
    assert int((want[1] > 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_visibility_kernel_rejects_bad_inputs(card):
    v_clip, v_pos0, faces, f_valid, res, chunk = _random(
        np.random.default_rng(4))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=card)
    prep = rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                      t(f_valid, torch.bool), res, chunk)
    with pytest.raises(ValueError):
        rc.visibility(prep["table"].cpu(), prep["orig"], prep["order"],
                      prep["counts"], prep["masks"], prep["zlo"], res,
                      prep["nsub"])
    with pytest.raises(ValueError):
        rc.visibility(prep["table"][:, :, :, ::2].contiguous(), prep["orig"],
                      prep["order"], prep["counts"], prep["masks"],
                      prep["zlo"], res, prep["nsub"])


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
    kernels = (rc.visibility, fm.fused_mlp_fwd, fm.fused_mlp_bwd,
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


# ---------------------------------------------------------------------------
# visibility variants 4 and 6 (K2, K3) and the resolve-rows forward (K5)
# ---------------------------------------------------------------------------

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


@pytest.mark.parametrize("make,chunk,nsub", [
    (_random, 256, 8), (_depth_stack_copies, 32, 1), (_sphere, 256, 8)])
def test_visibility_v4_kernel_equals_plain_version_and_k1(card, make, chunk,
                                                          nsub):
    """K2: face_id, z and the chunk flags identical bit for bit to the plain
    version (`visibility_reference`) and to K1 on the same inputs; one
    launch counted per call."""
    prep, res = _prep(card, make, 3, chunk=chunk, nsub=nsub, variant=4)
    lists = (prep["table"], prep["orig"], prep["order"], prep["counts"],
             prep["masks"], prep["zlo"])
    launches = rc.visibility_v4.launches
    got = rc.visibility_v4(*lists, prep["fbox"], res, prep["nsub"])
    torch.cuda.synchronize()
    assert rc.visibility_v4.launches == launches + 1
    want = rc.visibility_reference(*lists, res, prep["nsub"])
    k1 = rc.visibility(*lists, res, prep["nsub"])
    assert int((want[1] > 0).sum()) > 0
    for a, b, c in zip(got, want, k1):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("cap", [128, 2])
@pytest.mark.parametrize("make,nsub", [(_random, 8), (_depth_stack, 2),
                                       (_sphere, 8)])
def test_visibility_v6_kernel_equals_plain_version(card, make, nsub, cap):
    """K3: face_id, z and the slot flags identical bit for bit to
    `visibility_v6_reference`, with the unit lists capped at 128 and at 2
    (the full-scan loop); z and face_id identical to K1's."""
    prep, res = _prep(card, make, 3, nsub=nsub, variant=6, v6_cap=cap)
    args = (prep["table"], prep["orig"], prep["units"], prep["counts6"],
            prep["zu"], res, prep["nsub"])
    launches = rc.visibility_v6.launches
    got = rc.visibility_v6(*args)
    torch.cuda.synchronize()
    assert rc.visibility_v6.launches == launches + 1
    want = rc.visibility_v6_reference(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    k1 = rc.visibility(prep["table"], prep["orig"], prep["order"],
                       prep["counts"], prep["masks"], prep["zlo"], res,
                       prep["nsub"])
    assert torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
    if cap == 2:
        assert int((prep["counts6"] > prep["S"]).sum()) > 0


def test_resolve_fwd_kernel_equals_plain_version(card):
    """K5: the rows equal the plain version's exactly (a copy of a float),
    zero on background; one launch counted per call."""
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    rng = np.random.default_rng(6)
    B, H, W, R, Fn = 3, 64, 96, 42, 700
    fid = rng.integers(0, Fn + 1, (B, H * W)).astype(np.int32)
    fid[:, : H * W // 3] = 0
    pf = torch.as_tensor(rng.normal(size=(B, Fn, R)).astype(np.float32),
                         device=card)
    fid = torch.as_tensor(fid, device=card)
    n = rv.resolve_fwd.launches
    got = rv.resolve_fwd(pf, fid, (H, W))
    torch.cuda.synchronize()
    assert rv.resolve_fwd.launches == n + 1
    want = rv.resolve_fwd_reference(pf, fid, (H, W))
    assert torch.equal(got, want)
    bg = rv.to_tile_order((fid == 0)[..., None], (H, W))[:, 0]
    assert not got[bg[:, None].expand_as(got)].any()
