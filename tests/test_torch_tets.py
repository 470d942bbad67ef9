"""npz tet grids and the banded lattice sweep of the port against the JAX
package on the CPU: `load_tet_grid` and the edge tables, the general
(edge-table) marching tets and BCE regularizer, the banded SDF sweep, its
hook in the base predictor and its model-level gate, and the training
forward of both models on an npz grid in the working directory.

The npz grids are Kuhn lattices whose interior vertices are moved by
seeded uniform offsets of at most 0.1 of the spacing (`jittered_grid`), so
that no lattice shortcut can apply; nothing is downloaded.
"""
import copy
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from animals3d_tpu.geometry import tets as jtets
from animals3d_tpu.ops import dmtet as jdmtet
from animals3d_tpu_torch.geometry import tets as ttets
from animals3d_tpu_torch.ops import dmtet as tdmtet
from animals3d_tpu_torch.precision import set_mixed_precision
import test_torch_train
import torch_search
from test_animal_model import TINY_OVERRIDES
from torch_parity import TRAIN_OVERRIDES, build_pair, to_np

GRID_SEED = 15


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def jittered_grid(res, seed=GRID_SEED, amount=0.1):
    """(vertices, indices) of the Kuhn lattice of `res` with its interior
    vertices moved by uniform offsets of at most `amount` of the spacing
    on each axis."""
    verts, tets = jtets.kuhn_lattice(res)
    rng = np.random.default_rng(seed)
    off = rng.uniform(-amount, amount, verts.shape) / res
    interior = (np.abs(verts) < 0.5 - 0.5 / res).all(-1)
    verts = verts + np.where(interior[:, None], off, 0.0)
    return verts.astype(np.float32), tets


def write_grid(root, res, jitter=True):
    """`root/data/tets/{res}_tets.npz`: the jittered grid of `res`, or the
    plain lattice as an npz."""
    verts, tets = jittered_grid(res) if jitter else jtets.kuhn_lattice(res)
    d = os.path.join(root, "data", "tets")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, f"{res}_tets.npz"), vertices=verts,
             indices=tets)


def clear_grid_caches():
    jtets.load_tet_grid.cache_clear()
    ttets._load_tet_grid.cache_clear()


def field(verts, seed, scale=5.0):
    """A bumpy ellipsoid SDF at `verts` · scale."""
    rng = np.random.default_rng(seed)
    bumps = 0.02 * rng.standard_normal(verts.shape[0])
    r = np.linalg.norm(verts * np.asarray([1.0, 1.4, 0.8]), axis=-1)
    return (verts * scale).astype(np.float32), \
        (0.22 - r + bumps).astype(np.float32)


def test_load_tet_grid_reads_the_npz(tmp_path):
    write_grid(tmp_path, 4)
    grid = ttets.load_tet_grid(4, data_dir=str(tmp_path / "data" / "tets"))
    want = jtets.load_tet_grid(4, data_dir=str(tmp_path / "data" / "tets"))
    assert not grid.is_lattice and not want.is_lattice
    np.testing.assert_array_equal(grid.verts, want.verts)
    np.testing.assert_array_equal(grid.tets, want.tets)
    lattice = ttets.load_tet_grid(4, data_dir=str(tmp_path / "none"))
    assert lattice.is_lattice and lattice.tets is None


@pytest.mark.parametrize("res", [4, 8])
def test_unique_edges_match_jax(res):
    """Sorted unique edges and each tet's edge ids, equal."""
    verts, tets = jittered_grid(res)
    want_e, want_ids = jtets._unique_edges(tets, verts.shape[0])
    got_e, got_ids = ttets._unique_edges(torch.from_numpy(tets),
                                         verts.shape[0])
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    grid = ttets.DeviceTetGrid(
        ttets.TetGrid(verts=verts, res=res, is_lattice=False, tets=tets),
        "cpu")
    np.testing.assert_array_equal(grid.edges.numpy(), want_e)
    np.testing.assert_array_equal(grid.tet_edge_ids.numpy(), want_ids)


def general_pair(res, seed):
    verts, tets = jittered_grid(res)
    jgrid = jtets.TetGrid(verts=verts, tets=tets, res=res, is_lattice=False)
    tgrid = ttets.DeviceTetGrid(
        ttets.TetGrid(verts=verts, res=res, is_lattice=False, tets=tets),
        "cpu")
    pos, sdf = field(verts, seed)
    return jgrid, tgrid, pos, sdf


@pytest.mark.parametrize("res,caps", [(8, None), (16, None),
                                      (16, (256, 512))])
def test_marching_tets_general_matches_jax(res, caps):
    """Counts, vertex slots, faces (the file's raw winding), valid masks
    and global face ids identical, also past the capacities; vertices
    within 1e-6 (XLA may fuse the interpolation into an FMA); the
    gradient of a weighted sum of the vertices to the SDF and to the
    positions within 1e-5 relative."""
    jgrid, tgrid, pos, sdf = general_pair(res, seed=res)
    v_cap, f_cap = caps or jtets.default_capacity(res)
    w = np.random.default_rng(1).standard_normal((v_cap, 3)) \
        .astype(np.float32)

    def jloss(p, s):
        out = jdmtet.marching_tets(p, s, jgrid, v_cap, f_cap)
        return jnp.sum(out.verts * w), out
    (_l, want), (jgp, jgs) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(pos),
                                             jnp.asarray(sdf))
    p = torch.from_numpy(pos).requires_grad_(True)
    s = torch.from_numpy(sdf).requires_grad_(True)
    got = tdmtet.marching_tets(p, s, tgrid, v_cap, f_cap)
    (got.verts * torch.from_numpy(w)).sum().backward()
    assert (int(got.num_faces) > f_cap) == (caps is not None)
    for name in ("faces", "v_valid", "f_valid", "face_gidx", "num_verts",
                 "num_faces"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(to_np(got.verts), np.asarray(want.verts),
                               atol=1e-6, rtol=0)
    for g, jg in ((p.grad, jgp), (s.grad, jgs)):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())


def test_sdf_bce_reg_loss_matches_jax():
    """The general BCE regularizer and its gradient: 1e-6 relative."""
    jgrid, tgrid, _pos, sdf = general_pair(8, seed=4)
    edges = jnp.asarray(jgrid.edges)
    want, jg = jax.value_and_grad(
        lambda s: jdmtet.sdf_bce_reg_loss(s, edges))(jnp.asarray(sdf))
    s = torch.from_numpy(sdf).requires_grad_(True)
    got = tdmtet.sdf_bce_for_grid(s, tgrid)
    got.backward()
    assert float(want) > 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())


def test_general_path_on_the_lattice_matches_the_lattice_path():
    """On one Kuhn grid read as an npz, the general path gives the lattice
    path's mesh with the face columns reversed, and the same BCE."""
    verts, tets = jtets.kuhn_lattice(8)
    pos, sdf = field(verts, seed=2)
    tgrid = ttets.DeviceTetGrid(
        ttets.TetGrid(verts=verts, res=8, is_lattice=False, tets=tets),
        "cpu")
    p, s = torch.from_numpy(pos), torch.from_numpy(sdf)
    gen = tdmtet.marching_tets(p, s, tgrid, 2048, 4096)
    lat = tdmtet.marching_tets_lattice(p, s, 8, 2048, 4096)
    assert int(gen.num_faces) > 0
    for name in ("v_valid", "f_valid", "face_gidx", "num_verts",
                 "num_faces"):
        np.testing.assert_array_equal(to_np(getattr(gen, name)),
                                      to_np(getattr(lat, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(gen.faces.flip(-1).numpy(),
                                  lat.faces.numpy())
    np.testing.assert_allclose(gen.verts.numpy(), lat.verts.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(tdmtet.sdf_bce_for_grid(s, tgrid)),
                               float(tdmtet.sdf_bce_reg_loss_lattice(s, 8)),
                               rtol=1e-5)


# ---- the banded sweep -------------------------------------------------

def analytic_field(p, xp):
    """A near-eikonal ellipsoid with a smooth bump (`tests/test_dmtet.py`)."""
    scale = xp.asarray([1.0, 1.0, 0.6], dtype=p.dtype) \
        if xp is torch else xp.asarray([1.0, 1.0, 0.6])
    r = xp.linalg.norm(p * scale, axis=-1) if xp is jnp else \
        torch.linalg.norm(p * scale, dim=-1)
    return (1.4 - r) + 0.12 * xp.sin(p[..., 0] * 2.1) \
        * xp.cos(p[..., 1] * 1.7)


@pytest.mark.parametrize("res,seg_cap", [(32, 512), (64, None), (32, 4)])
def test_banded_sweep_matches_jax(res, seg_cap):
    """Values within 1e-6 and the band's count equal, on a cap with
    headroom, the default cap (which this field overflows at 64) and a
    cap of 4 (flagged segments past the cap keep the interpolated
    values); the segments within the cap carry the exact field."""
    verts, _ = jtets.kuhn_lattice(res)
    pos = verts * 7.0
    want, wcount = jdmtet.sdf_lattice_banded(
        lambda p: analytic_field(p, jnp), jnp.asarray(pos), res,
        seg_cap=seg_cap)
    got, count = tdmtet.sdf_lattice_banded(
        lambda p: analytic_field(p, torch), torch.from_numpy(pos), res,
        seg_cap=seg_cap)
    assert int(count) == int(wcount) > 0
    if seg_cap == 4:
        assert int(count) > 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    dense, _ = tdmtet.sdf_lattice_banded(
        lambda p: analytic_field(p, torch), torch.from_numpy(pos), res,
        force_branch="dense")
    exact = (got - dense).abs() < 1e-6
    segs = exact[:exact.numel() // tdmtet.BAND_SEG * tdmtet.BAND_SEG] \
        .reshape(-1, tdmtet.BAND_SEG).all(1)
    nseg = -(-(res + 1) ** 3 // tdmtet.BAND_SEG)
    cap = seg_cap or tdmtet.default_seg_cap(res)
    assert int(segs.sum()) >= min(int(count), cap)


class TinyMLP(nn.Module):
    """The flax `Tiny` below, in torch."""

    def __init__(self):
        super().__init__()
        self.a = nn.Linear(3, 32)
        self.b = nn.Linear(32, 1)

    def forward(self, p):
        h = torch.relu(self.a(torch.sin(p * 1.3)))
        r = torch.linalg.norm(p * torch.tensor([1.0, 1.0, 0.6]), dim=-1)
        return (1.4 - r) + 0.05 * self.b(h)[..., 0]


@pytest.mark.parametrize("res", [32, 64])
def test_banded_bce_and_gradients_match_jax(res):
    """`sdf_bce_reg_loss` over the banded field of a small MLP and its
    parameter gradients, both recomputed in the backward: the loss within
    1e-5 and each gradient within 1e-4 of its norm of JAX's, on the same
    weights."""
    import flax.linen as fnn

    class Tiny(fnn.Module):
        @fnn.compact
        def __call__(self, p):
            h = fnn.relu(fnn.Dense(32, name="a")(jnp.sin(p * 1.3)))
            r = jnp.linalg.norm(p * jnp.asarray([1.0, 1.0, 0.6]), axis=-1)
            return (1.4 - r) + 0.05 * fnn.Dense(1, name="b")(h)[..., 0]

    verts, tets = jtets.kuhn_lattice(res)
    pos = verts * 7.0
    edges_np, _ = jtets._unique_edges(tets, verts.shape[0])
    m = Tiny()
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(pos[:2]))

    def jloss(params):
        sdf, _ = jdmtet.sdf_lattice_banded(lambda p: m.apply(params, p),
                                           jnp.asarray(pos), res,
                                           seg_cap=512)
        return jdmtet.sdf_bce_reg_loss(sdf, jnp.asarray(edges_np))
    want, jg = jax.value_and_grad(jloss)(params)

    t = TinyMLP()
    with torch.no_grad():
        for name in ("a", "b"):
            lin = getattr(t, name)
            lin.weight.copy_(torch.from_numpy(
                np.asarray(params["params"][name]["kernel"]).T.copy()))
            lin.bias.copy_(torch.from_numpy(
                np.asarray(params["params"][name]["bias"])))
    sdf, _ = tdmtet.sdf_lattice_banded(t, torch.from_numpy(pos), res,
                                       seg_cap=512)
    got = tdmtet.sdf_bce_reg_loss(sdf, torch.from_numpy(edges_np))
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name in ("a", "b"):
        lin = getattr(t, name)
        for tp, key, tr in ((lin.weight, "kernel", True),
                            (lin.bias, "bias", False)):
            ref = np.asarray(jg["params"][name][key])
            ref = ref.T if tr else ref
            gap = np.linalg.norm(tp.grad.numpy() - ref) / np.linalg.norm(ref)
            assert gap <= 1e-4, (name, key, gap)


BAND = ["+model.cfg_predictor_base.cfg_shape.sparse_band_eval=true"]


@pytest.mark.parametrize("weights,on", [((0.1, 0.1), True),
                                        ((0.0, 0.0), False),
                                        ((0.0, 0.1), True)])
def test_band_gate_matches_jax(weights, on):
    """The band turns off where both the BCE and eikonal weights are 0."""
    from animals3d_tpu import config as jcfg
    from animals3d_tpu.models import build_model as jbuild
    from animals3d_tpu_torch import config as tcfg
    from animals3d_tpu_torch.models import build_model as tbuild
    ov = TINY_OVERRIDES + BAND + [
        f"model.cfg_loss.sdf_bce_reg_loss_weight={weights[0]}",
        f"model.cfg_loss.sdf_gradient_reg_loss_weight={weights[1]}"]
    jc = jcfg.load_config("train_magicpony_horse", overrides=ov)
    tc = tcfg.load_config("train_magicpony_horse", overrides=ov)
    jm = jbuild(jc["model"])
    tm = tbuild(tc["model"], device="cpu")
    assert jm.cfg_predictor_base.cfg_shape.sparse_band_eval is on
    assert tm.cfg_predictor_base.cfg_shape.sparse_band_eval is on
    assert tm.netBase.cfg.cfg_shape.sparse_band_eval is on


def test_banded_prior_mesh_matches_jax(monkeypatch):
    """netBase's eval forward at grid 64 with the band on (the dense sweep
    does not run): SDF within 1e-5 relative, topology identical, vertices
    within 1e-5."""
    set_mixed_precision(None)
    counts = []
    band = tdmtet.sdf_lattice_banded

    def counted(*args, **kwargs):
        out = band(*args, **kwargs)
        counts.append(int(out[1]))
        return out
    monkeypatch.setattr(tdmtet, "sdf_lattice_banded", counted)
    ov = TINY_OVERRIDES + BAND + [
        "model.cfg_predictor_base.cfg_shape.grid_res=64",
        "model.cfg_predictor_base.cfg_shape.grid_res_coarse=64"]
    jm, jp, tm = build_pair(ov, iters=(50000,))
    phase = jm.phase_for_iter(50000)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)
    want, sdf_want = jm.netBase.apply({"params": jp["netBase"]}, grid,
                                      v_cap, f_cap, 50000, None)
    tgrid, _, _ = tm.grid_for_phase(tm.phase_for_iter(50000, False))
    with torch.no_grad():
        got, sdf, *_ = tm.forward_base(tgrid, v_cap, f_cap)
    assert len(counts) == 1 and counts[0] > 0
    np.testing.assert_allclose(to_np(sdf), np.asarray(sdf_want), atol=1e-6,
                               rtol=1e-5)
    assert int(got.num_faces) > 0
    for name in ("t_pos_idx", "v_valid", "f_valid", "num_verts",
                 "num_faces"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(to_np(got.v_pos), np.asarray(want.v_pos),
                               atol=1e-5, rtol=0)


# ---- the npz grid on the training path --------------------------------

@pytest.fixture
def npz_cwd(tmp_path, monkeypatch):
    """A working directory holding `data/tets/8_tets.npz`."""
    write_grid(tmp_path, 8)
    monkeypatch.chdir(tmp_path)
    clear_grid_caches()
    yield tmp_path
    clear_grid_caches()


def test_npz_grid_prior_mesh_matches_jax(npz_cwd):
    """With `data/tets/8_tets.npz` in the working directory both packages
    build the prior mesh on that grid: SDF, topology (the file's winding)
    and vertices as in `test_torch_prior.test_get_prior_mesh`."""
    set_mixed_precision(None)
    jm, jp, tm = build_pair(TINY_OVERRIDES, iters=(50000,))
    phase = jm.phase_for_iter(50000)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)
    tgrid, _, _ = tm.grid_for_phase(tm.phase_for_iter(50000, False))
    assert not grid.is_lattice and not tgrid.is_lattice
    want, sdf_want = jm.netBase.apply({"params": jp["netBase"]}, grid,
                                      v_cap, f_cap, 50000, None)
    with torch.no_grad():
        got, sdf, *_ = tm.forward_base(tgrid, v_cap, f_cap)
    np.testing.assert_allclose(to_np(sdf), np.asarray(sdf_want), atol=1e-6,
                               rtol=1e-5)
    assert int(got.num_faces) > 0
    for name in ("t_pos_idx", "v_valid", "f_valid", "face_gidx",
                 "num_verts", "num_faces"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(to_np(got.v_pos), np.asarray(want.v_pos),
                               atol=1e-5, rtol=0)


NUDGES = (1, 2)      # the seeds of `NpzPair.steady`'s one-ulp nudges


class NpzPair(test_torch_train.Pair):
    """`test_torch_train.Pair` whose key search also skips keys one ulp
    from a decision, as `test_torch_fauna.FaunaPair.jax_steady` does:
    there a one-ulp nudge of a package's parameters moves its own
    gradient tree by more than a leaf's tolerance (`ROADMAP.md` C)."""

    def other_views_agree(self, rng, jout, tout):
        return self.steady(rng)

    def steady(self, rng):
        """Each package's own tree stays within each leaf's tolerance of
        itself under the `NUDGES`; the port's go to a copy of its model."""
        tm = self.tm
        self.tm = copy.deepcopy(tm)
        try:
            for grads_aux in (self.jax_grads_aux, self.port_grads_aux):
                grads, _ = grads_aux(rng)
                for nudge in NUDGES:
                    moved, _ = grads_aux(rng, nudge=nudge)
                    if test_torch_train.worst_multiple({
                            p: np.linalg.norm(moved[p] - g)
                            / np.linalg.norm(g) for p, g in grads.items()
                            if "ViT" not in p
                            and np.linalg.norm(g) > 0}) > 1:
                        return False
            return True
        finally:
            self.tm = tm


def child_search(its, overrides):
    """`test_torch_train.search_here` on an `NpzPair` in a fresh working
    directory that holds the jittered grid of 8 (`torch_search` runs this
    in a child)."""
    os.chdir(tempfile.mkdtemp())
    write_grid(".", 8)
    clear_grid_caches()
    out = {}
    for it in its:
        pair = NpzPair(it, overrides)
        out[it] = (test_torch_train.search_here(pair), pair.tie_keys,
                   pair.relu_keys)
    return out


@pytest.fixture(scope="module")
def npz_step():
    """The training step of `test_torch_train` (iteration 50,000, the
    fused sweep on both sides) on the npz grid, at the first key on which
    the packages' discrete decisions agree."""
    got = torch_search.in_child("test_torch_tets", [test_torch_train.IT],
                                TRAIN_OVERRIDES)[test_torch_train.IT]
    if isinstance(got, str):
        pytest.fail(got)
    return got[0]


def test_npz_grid_training_forward_matches_jax(npz_step):
    """Every metric and the total loss within 1e-4 relative, with the
    grid's BCE term in them."""
    s = npz_step
    assert set(s["tmet"]) == set(s["jmet"])
    for name, want in s["jmet"].items():
        np.testing.assert_allclose(float(s["tmet"][name]), float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(s["tloss"]), float(s["jloss"]),
                               rtol=1e-4)
    assert float(s["tmet"]["sdf_bce_reg_loss"]) > 0


def test_npz_grid_gradient_tree_matches_jax(npz_step):
    """Every gradient leaf within `test_torch_train`'s tolerances (1e-3
    of the leaf's norm, 5e-3 on its noisy leaves)."""
    from torch_parity import flat_tree, numpy_tree
    gaps = test_torch_train.gradient_gaps(
        flat_tree(npz_step["tgrads"]), flat_tree(numpy_tree(
            npz_step["jgrads"])))
    assert len(gaps) > 40
    bad = {"/".join(p): g for p, g in gaps.items()
           if g > test_torch_train.leaf_tolerance(p)}
    assert not bad, bad
