"""Port parity of the prior shape (netBase): lattice marching tets and
`get_prior_mesh` against the JAX package on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.geometry import tets as jtets
from animals3d_tpu.geometry.mesh import face_normals as jfn
from animals3d_tpu.ops import dmtet as jdmtet
from animals3d_tpu_torch.geometry import tets as ttets
from animals3d_tpu_torch.geometry.mesh import face_normals as tfn
from animals3d_tpu_torch.ops import dmtet as tdmtet
from animals3d_tpu_torch.precision import set_mixed_precision
from test_animal_model import TINY_OVERRIDES
from torch_parity import build_pair, to_np


def _field(res, seed):
    """A bumpy ellipsoid SDF over the lattice, made with numpy."""
    verts, _tets = jtets.kuhn_lattice(res)
    rng = np.random.default_rng(seed)
    bumps = 0.02 * rng.standard_normal(verts.shape[0])
    r = np.linalg.norm(verts * np.asarray([1.0, 1.4, 0.8]), axis=-1)
    return verts * 5.0, (0.22 - r + bumps).astype(np.float32)


def test_lattice_tables_match():
    np.testing.assert_array_equal(ttets.kuhn_corners(), jtets.kuhn_corners())
    for res in (4, 16):
        v_j, t_j = jtets.kuhn_lattice(res)
        v_t, t_t = ttets.kuhn_lattice(res)
        np.testing.assert_array_equal(v_t, v_j)
        np.testing.assert_array_equal(t_t, t_j)
    for res in (8, 32, 128):
        assert ttets.default_capacity(res) == jtets.default_capacity(res)


@pytest.mark.parametrize("res,caps", [(16, None), (32, None),
                                      (16, (512, 1024))])
def test_marching_tets_lattice_identical(res, caps):
    """Vertex and face buffers, valid masks, global face ids and counts
    identical, also when the mesh overflows its capacities; vertex
    positions equal to float32 rounding (the edge interpolation may be
    fused into an FMA by XLA)."""
    pos, sdf = _field(res, seed=res)
    v_cap, f_cap = caps or jtets.default_capacity(res)
    want = jdmtet.marching_tets_lattice(jnp.asarray(pos), jnp.asarray(sdf),
                                        res, v_cap, f_cap)
    got = tdmtet.marching_tets_lattice(torch.from_numpy(pos),
                                       torch.from_numpy(sdf), res, v_cap,
                                       f_cap)
    assert (int(got.num_faces) > f_cap) == (caps is not None)
    for name in ("faces", "v_valid", "f_valid", "face_gidx", "num_verts",
                 "num_faces"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(to_np(got.verts), np.asarray(want.verts),
                               atol=1e-6, rtol=0)


def test_first_geq_matches():
    rng = np.random.default_rng(0)
    csum = np.cumsum(rng.integers(0, 3, (4, 50)), -1).astype(np.int32)
    targets = np.arange(1, 70, dtype=np.int32)
    for row in csum:
        want = jdmtet.first_geq(jnp.asarray(row), jnp.asarray(targets))
        got = tdmtet.first_geq(torch.from_numpy(row).long(),
                               torch.from_numpy(targets))
        np.testing.assert_array_equal(to_np(got), np.asarray(want))


@pytest.mark.parametrize("res", [16, 32])
def test_get_prior_mesh(res):
    """netBase's eval forward (dense SDF sweep + marching tets + normals):
    SDF within 1e-5 relative (float32 sums in another order), topology
    identical, vertices within 1e-5. Vertex normals are normalized cross
    products of short edges, which amplify the vertices' rounding: 1e-4."""
    set_mixed_precision(None)
    overrides = TINY_OVERRIDES + [
        f"model.cfg_predictor_base.cfg_shape.grid_res={res}",
        f"model.cfg_predictor_base.cfg_shape.grid_res_coarse={res}"]
    jm, jp, tm = build_pair(overrides)
    phase = jm.phase_for_iter(50000)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)
    want, sdf_want = jm.netBase.apply({"params": jp["netBase"]}, grid,
                                      v_cap, f_cap, 50000, None)
    tgrid, tv_cap, tf_cap = tm.grid_for_phase(
        tm.phase_for_iter(50000, is_training=False))
    assert (tgrid.res, tv_cap, tf_cap) == (grid.res, v_cap, f_cap)
    with torch.no_grad():
        got, sdf, *_ = tm.forward_base(tgrid, tv_cap, tf_cap)
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
    np.testing.assert_allclose(to_np(got.v_nrm), np.asarray(want.v_nrm),
                               atol=1e-4, rtol=0)


def test_face_normals_match():
    """Unit face normals of a lattice mesh, zero on invalid faces."""
    pos, sdf = _field(16, seed=3)
    v_cap, f_cap = jtets.default_capacity(16)
    out = tdmtet.marching_tets_lattice(torch.from_numpy(pos),
                                       torch.from_numpy(sdf), 16, v_cap,
                                       f_cap)
    v = out.verts[None]
    want = jfn(jnp.asarray(v.numpy()), jnp.asarray(out.faces.numpy()),
               jnp.asarray(out.f_valid.numpy()))
    got = tfn(v, out.faces, out.f_valid)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)
