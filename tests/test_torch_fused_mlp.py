"""The port's fused netSDF sweep (`animals3d_tpu_torch.ops.fused_mlp`)
against the JAX package: the Pallas kernels in interpret mode
(`ops.fused_mlp.mlp_sweep`, as `tests/test_fused_mlp.py` runs them) and the
flax `CoordMLP`. On the CPU the port runs the plain versions of its CUDA
kernels; the kernels themselves are held to those on the card
(`tests/test_torch_cuda.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.networks.mlp import CoordMLP as JCoordMLP
from animals3d_tpu.networks.mlp import harmonic_embedding as jembed
from animals3d_tpu.ops import fused_mlp as jfm
from animals3d_tpu.precision import set_mixed_precision as jset_precision
from animals3d_tpu_torch.convert_jax import export_jax_grads, load_jax_params
from animals3d_tpu_torch.networks.mlp import CoordMLP
from animals3d_tpu_torch.ops import fused_mlp as fm
from animals3d_tpu_torch.precision import set_mixed_precision
from torch_parity import flat_tree, numpy_tree

SCALAR = 2 * np.pi / 7 * 0.9
FREQ = 8


def _make(num_layers, n, seed=0):
    """flax CoordMLP + params, the port's CoordMLP carrying them, points
    and their JAX embedding."""
    jmlp = JCoordMLP(3, 1, num_layers, nf=256, activation=None, min_max=None,
                     n_harmonic_functions=FREQ, embedder_scalar=SCALAR,
                     embed_concat_pts=True)
    pts = np.random.default_rng(seed).uniform(-3, 3, (n, 3)) \
        .astype(np.float32)
    params = jmlp.init(jax.random.PRNGKey(seed), jnp.asarray(pts))["params"]
    tmlp = CoordMLP(3, 1, num_layers, nf=256, n_harmonic_functions=FREQ,
                    embedder_scalar=SCALAR, embed_concat_pts=True)
    load_jax_params(tmlp, numpy_tree(params))
    e = jnp.concatenate([jnp.asarray(pts), jembed(jnp.asarray(pts), FREQ,
                                                  SCALAR)], -1)
    return jmlp, params, tmlp, pts, e


@pytest.fixture(autouse=True)
def _float32():
    set_mixed_precision(None)
    jset_precision(None)
    yield
    set_mixed_precision(None)
    jset_precision(None)


@pytest.mark.parametrize("num_layers,n", [(5, 1000), (2, 257)])
def test_sweep_forward_matches_pallas_and_flax(num_layers, n):
    """rtol/atol 2e-5, the JAX package's own tolerance between its kernel
    and flax (`tests/test_fused_mlp.py`)."""
    jmlp, params, tmlp, pts, e = _make(num_layers, n)
    flax = np.asarray(jmlp.apply({"params": params}, jnp.asarray(pts))[:, 0])
    pallas = np.asarray(jfm.mlp_sweep(params, e, num_layers=num_layers,
                                      tb=512))
    tp = torch.from_numpy(pts)
    with torch.no_grad():
        got = fm.mlp_sweep(tmlp, tmlp.embed(tp), num_layers=num_layers)
        plain = tmlp(tp)[:, 0]
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), flax, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_sweep_vjp_matches_pallas_and_flax():
    """Every weight's gradient of sum(out · w), relative to the leaf's
    largest entry: atol 3e-6 (`tests/test_fused_mlp.py::test_vjp_parity`)."""
    num_layers, n = 5, 1500
    jmlp, params, tmlp, pts, e = _make(num_layers, n)
    w = np.random.default_rng(1).normal(size=(n,)).astype(np.float32)
    jw = jnp.asarray(w)
    g_flax = jax.grad(lambda p: jnp.sum(
        jmlp.apply({"params": p}, jnp.asarray(pts))[:, 0] * jw))(params)
    g_pallas = jax.grad(lambda p: jnp.sum(
        jfm.mlp_sweep(p, e, num_layers=num_layers, tb=512) * jw))(params)
    tp = torch.from_numpy(pts)
    out = fm.mlp_sweep(tmlp, tmlp.embed(tp), num_layers=num_layers)
    (out * torch.from_numpy(w)).sum().backward()
    got = flat_tree(export_jax_grads(tmlp))
    assert len(got) == len(flat_tree(numpy_tree(g_flax))) == 7
    for ref in (g_pallas, g_flax):
        for path, leaf in flat_tree(numpy_tree(ref)).items():
            scale = np.abs(leaf).max() + 1e-8
            np.testing.assert_allclose(got[path] / scale, leaf / scale,
                                       rtol=0, atol=3e-6,
                                       err_msg="/".join(path))


def test_sweep_raises_on_input_that_requires_grad():
    """The zero input cotangent is structural: positions that require grad
    are refused instead of silently getting zeros."""
    _jmlp, _params, tmlp, pts, _e = _make(2, 16)
    e = tmlp.embed(torch.from_numpy(pts)).requires_grad_(True)
    with pytest.raises(ValueError, match="does not differentiate"):
        fm.mlp_sweep(tmlp, e, num_layers=2)
    narrow = CoordMLP(3, 1, 2, nf=32, n_harmonic_functions=FREQ,
                      embedder_scalar=SCALAR)
    assert not fm.coordmlp_sweep_params_ok(narrow, 2)
    with pytest.raises(ValueError, match="256-wide"):
        fm.mlp_sweep(narrow, narrow.embed(torch.from_numpy(pts)),
                     num_layers=2)


@pytest.mark.parametrize("hidden,training,want",
                         [(256, True, True), (256, False, False),
                          (32, True, False)])
def test_use_fused_sweep_gate(hidden, training, want):
    """On for training, off for eval, off at a hidden size other than 256 —
    the JAX package's gate."""
    from animals3d_tpu.predictors.base import BasePredictor as JBase
    from animals3d_tpu.predictors.config import (BasePredictorConfig,
                                                 DINOConfig, ShapeConfig)
    from animals3d_tpu_torch.predictors import base as tbase
    from animals3d_tpu_torch.predictors import config as tconf
    kw = dict(grid_res=8, num_layers=2, hidden_size=hidden, embedder_freq=4)
    tmod = tbase.BasePredictor(tconf.BasePredictorConfig(
        cfg_shape=tconf.ShapeConfig(**kw),
        cfg_dino=tconf.DINOConfig(feature_dim=4, num_layers=2,
                                  hidden_size=32)))
    assert tmod._use_fused_sweep(training=training) is want
    jmod = JBase(BasePredictorConfig(
        cfg_shape=ShapeConfig(**kw),
        cfg_dino=DINOConfig(feature_dim=4, num_layers=2, hidden_size=32)))
    # the flax gate also asks `is_initializing()`, which needs a bound
    # module: bind it to an empty tree
    assert jmod.bind({"params": {}})._use_fused_sweep(training=training) \
        is want


def test_get_prior_mesh_fused_matches_dense_and_jax():
    """`get_prior_mesh` with jitter (the fused path) against the dense
    sweep on the same jittered lattice and against the JAX package's fused
    path: sdf rtol/atol 2e-5, same vertex count, vertices within 1e-4; the
    gradients of a mesh loss through marching tets agree per leaf to 1e-4
    of the leaf's largest entry."""
    from animals3d_tpu.geometry import tets as jtets
    from animals3d_tpu.geometry.tets import DeviceTetGrid as JGrid
    from animals3d_tpu.predictors.base import BasePredictor as JBase
    from animals3d_tpu.predictors.config import (BasePredictorConfig,
                                                 DINOConfig, ShapeConfig)
    from animals3d_tpu_torch.geometry import tets as ttets
    from animals3d_tpu_torch.predictors import base as tbase
    from animals3d_tpu_torch.predictors import config as tconf
    kw = dict(grid_res=12, spatial_scale=7.0, num_layers=5, hidden_size=256,
              embedder_freq=8, init_sdf="ellipsoid", jitter_grid=0.05,
              symmetrize=True)
    dkw = dict(feature_dim=4, num_layers=2, hidden_size=32)
    jmod = JBase(BasePredictorConfig(cfg_shape=ShapeConfig(**kw),
                                     cfg_dino=DINOConfig(**dkw)))
    jgrid = JGrid(jtets.load_tet_grid(12, data_dir="/nonexistent"))
    v_cap, f_cap = 2048, 4096
    params = jmod.init(jax.random.PRNGKey(0), jgrid, v_cap, f_cap,
                       method=JBase.init_all)["params"]
    key = jax.random.PRNGKey(7)
    u = float(jax.random.uniform(key, ()))
    tgt = np.random.default_rng(3).normal(size=(1, v_cap, 3)) \
        .astype(np.float32) * 0.1

    def jloss(p):
        mesh, sdf = jmod.apply({"params": p}, jgrid, v_cap, f_cap, 0, key)
        return (jnp.sum((mesh.v_pos - tgt) ** 2 * mesh.v_valid[None, :, None])
                + 1e-3 * jnp.sum(sdf ** 2)), (mesh, sdf)
    (_, (jmesh, jsdf)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params)

    tmod = tbase.BasePredictor(tconf.BasePredictorConfig(
        cfg_shape=tconf.ShapeConfig(**kw), cfg_dino=tconf.DINOConfig(**dkw)))
    load_jax_params(tmod, numpy_tree(params))
    tgrid = ttets.DeviceTetGrid(ttets.load_tet_grid(12), "cpu")
    assert tmod._use_fused_sweep(training=True)
    launches = fm.fused_mlp_fwd.launches
    mesh, sdf = tmod.get_prior_mesh(tgrid, v_cap, f_cap,
                                    jitter=torch.tensor(u))
    assert fm.fused_mlp_fwd.launches == launches    # plain version on CPU
    loss = ((mesh.v_pos - torch.from_numpy(tgt)) ** 2
            * mesh.v_valid[None, :, None]).sum() + 1e-3 * (sdf ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(sdf.detach().numpy(), np.asarray(jsdf),
                               rtol=2e-5, atol=2e-5)
    assert int(mesh.num_verts) == int(jmesh.num_verts) > 100
    np.testing.assert_allclose(mesh.v_pos.detach().numpy(),
                               np.asarray(jmesh.v_pos), atol=1e-4)
    got = flat_tree(export_jax_grads(tmod))
    for path, leaf in flat_tree(numpy_tree(jgrads)).items():
        if path[0] == "netDINO":
            assert path not in got          # unused: no grad
            continue
        scale = np.abs(leaf).max() + 1e-6
        np.testing.assert_allclose(got[path] / scale, leaf / scale, atol=1e-4,
                                   err_msg="/".join(path))
    # the dense sweep on the same jittered lattice
    pos = tgrid.verts * 7.0 + (u * 2 - 1) * 0.05 * 7.0
    with torch.no_grad():
        dense = tmod.get_sdf(pos)[..., 0]
    np.testing.assert_allclose(sdf.detach().numpy(), dense.numpy(),
                               rtol=2e-5, atol=2e-5)


def test_bf16_mode_close_to_f32():
    """bf16 compute tracks the float32 result to bf16 round-off and the
    plain bf16 CoordMLP closely (the same truncation points) — the bounds
    of `tests/test_fused_mlp.py::test_bf16_mode_close_to_f32`."""
    _jmlp, _params, tmlp, pts, _e = _make(5, 1000)
    tp = torch.from_numpy(pts)
    with torch.no_grad():
        ref32 = tmlp(tp)[:, 0]
        set_mixed_precision("bf16")
        ref16 = tmlp(tp)[:, 0]
        got16 = fm.mlp_sweep(tmlp, tmlp.embed(tp), num_layers=5)
    scale = float(ref32.abs().max())
    assert float((got16 - ref16).abs().max()) / scale < 0.02
    assert float((got16 - ref32).abs().max()) / scale < 0.05
    w = torch.from_numpy(np.random.default_rng(2).normal(size=1000)
                         .astype(np.float32))
    out = fm.mlp_sweep(tmlp, tmlp.embed(tp), num_layers=5)
    (out * w).sum().backward()
    for name, p in tmlp.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name


@pytest.mark.parametrize("n,chunk_rows", [
    (0, fm.CHUNK_ROWS), (77, fm.CHUNK_ROWS), (3 * 512, 512),
    (3 * 512 + 77, 512), (129 ** 3, fm.CHUNK_ROWS)])
def test_bwd_plan_covers_every_row_once(n, chunk_rows):
    """The bf16 backward's chunk plan (a pure function): every row in
    exactly one chunk, chunks in order and at most C rows each, C a
    multiple of the chain pass's tile and no larger than N needs, the
    scratch planes (2L - 1 of (C, 256), then the (C, dp) input rows) side
    by side without overlap, and the scratch within 512 MiB."""
    L, dp = 5, 64
    plan = fm.bwd_plan(n, L, dp, chunk_rows)
    assert plan.C % fm.TILE_ROWS == 0 and plan.C <= chunk_rows
    assert plan.C == min(chunk_rows, -(-n // fm.TILE_ROWS) * fm.TILE_ROWS)
    seen = np.zeros(n, np.int64)
    end = 0
    for r0, rows in plan.chunks:
        assert r0 == end and 0 < rows <= plan.C
        seen[r0:r0 + rows] += 1
        end = r0 + rows
    assert end == n and (seen == 1).all()
    assert len(plan.chunks) == -(-n // plan.C) if n else not plan.chunks
    assert len(plan.plane_offsets) == 2 * L
    widths = [fm.NF] * (2 * L - 1) + [dp]
    spans = sorted((o, o + plan.C * w)
                   for o, w in zip(plan.plane_offsets, widths))
    assert spans[0][0] == 0 and spans[-1][1] == plan.scratch_elems
    for (_, a_end), (b0, _) in zip(spans, spans[1:]):
        assert a_end <= b0
    assert plan.scratch_elems * 2 <= 512 * 2 ** 20
    assert plan.splits == fm.WGRAD_SPLITS
    assert plan.chain_blocks == (min(fm.NUM_BLOCKS, plan.C // fm.TILE_ROWS)
                                 if n else 0)


def test_bwd_plan_rejects_bad_chunks():
    with pytest.raises(ValueError):
        fm.bwd_plan(1000, 5, 64, fm.TILE_ROWS + 1)
    with pytest.raises(ValueError):
        fm.bwd_plan(1000, 5, 64, 0)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 3 * 128 + 1,
                               132 * 128, 132 * 128 + 1, 129 ** 3])
def test_fwd_f32_plan_covers_every_row_once(n):
    """The float32 forward's launch (a pure function): block b takes tiles
    b, b + grid, ... of `tile_rows` rows; together they hold every row
    exactly once, every block has a tile, and the grid is at most one block
    per SM."""
    plan = fm.fwd_f32_plan(n, 5, 64)
    assert plan.tile_rows == fm.TILE_ROWS
    assert plan.tiles * plan.tile_rows >= n > (plan.tiles - 1) * plan.tile_rows
    assert plan.grid == min(fm.NUM_BLOCKS, plan.tiles)
    seen = np.zeros(n, np.int64)
    for blk in range(plan.grid):
        mine = range(blk, plan.tiles, plan.grid)
        assert len(mine) > 0
        for t in mine:
            seen[t * plan.tile_rows:(t + 1) * plan.tile_rows] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("L", range(2, 9))
@pytest.mark.parametrize("dp", [64, 128])
def test_fwd_f32_plan_shared_memory(dp, L):
    """The float32 forward's shared memory fits one block on an H100 at
    the input widths the sweep pads to, for any depth: the tile buffer,
    ring and sums do not grow with dp or L."""
    plan = fm.fwd_f32_plan(129 ** 3, L, dp)
    assert plan.smem <= 232448          # a block's most on an H100
    assert plan.smem == fm.fwd_f32_plan(1, 2, 64).smem


def test_fwd_f32_plan_matches_the_kernel_source():
    """`fwd_f32_plan`'s tile, slice and ring sizes and its shared-memory
    bytes are the CUDA kernel's (`csrc/fused_mlp.cu`, which no CPU test can
    compile)."""
    import pathlib
    import re
    src = (pathlib.Path(fm.__file__).parent.parent / "csrc"
           / "fused_mlp.cu").read_text()
    define = lambda name: int(re.search(rf"#define {name} (\d+)", src)[1])
    assert define("F32_ROWS") == fm.TILE_ROWS
    assert define("F32_KS") == fm.F32_SLICE_ROWS
    assert define("F32_NST") == fm.F32_STAGES
    assert define("MAX_SMEM") == 232448
    assert "#define F32_LDT (F32_ROWS + 4)" in src
    assert fm.fwd_f32_plan(1, 5, 64).smem == 204832   # the source's note


@pytest.mark.parametrize("n,L,dp", [(-1, 5, 64), (100, 1, 64), (100, 5, 0),
                                    (100, 5, 24), (100, 5, 320)])
def test_fwd_f32_plan_rejects_bad_inputs(n, L, dp):
    with pytest.raises(ValueError):
        fm.fwd_f32_plan(n, L, dp)


@pytest.mark.parametrize("dp,nl", [(64, 4), (128, 1)])
def test_weight_stream_layout(dp, nl):
    """`weight_stream` (a pure layout change): undoing `slice_layout` gives
    back, slice by slice of 32 rows, win, then ws[0 .. L-2], then
    ws[L-2 .. 0]^T; the forward reads exactly the first dp / 32 + 8 (L - 1)
    slices (`stream_slices`). The layout is a permutation whose strides are
    the kernels' wgmma descriptor's: 8 elements per 16-byte chunk swizzled
    by the row, 512 to the next 64 columns, 2048 to the next 8 rows."""
    rng = np.random.default_rng(dp + nl)
    win = torch.from_numpy(rng.normal(size=(dp, fm.NF)).astype(np.float32))
    ws = torch.from_numpy(rng.normal(size=(nl, fm.NF, fm.NF))
                          .astype(np.float32))
    stream = fm.weight_stream(win, ws)
    fwd, total = fm.stream_slices(dp, nl + 1)
    assert fwd == dp // 32 + 8 * nl and total == fwd + 8 * nl
    assert tuple(stream.shape) == (total, fm.SLICE_ROWS * fm.NF)
    layout = fm.slice_layout()
    assert torch.equal(torch.sort(layout).values,
                       torch.arange(fm.SLICE_ROWS * fm.NF))
    pos = lambda k, n: int(layout[k * fm.NF + n])
    assert (pos(0, 0), pos(0, 8), pos(1, 0), pos(1, 8), pos(0, 64),
            pos(8, 0), pos(9, 70)) == (0, 8, 72, 64, 512, 2048, 2638)
    undone = stream[:, layout].reshape(total, fm.SLICE_ROWS, fm.NF)
    mats = [win] + list(ws) + [w.T for w in ws.flip(0)]
    want = [m[r:r + fm.SLICE_ROWS] for m in mats
            for r in range(0, m.shape[0], fm.SLICE_ROWS)]
    assert len(want) == total
    for i, w in enumerate(want):
        assert torch.equal(undone[i], w), i
    forward = [m[r:r + fm.SLICE_ROWS] for m in [win] + list(ws)
               for r in range(0, m.shape[0], fm.SLICE_ROWS)]
    assert len(forward) == fwd
