"""The port's `interpolate` (and its sorted-segment-sum backward), the
mesh regularizers and the OBJ/MTL export against the JAX package on the
CPU, and the OBJ/MTL round trip. The meshes are lattice marching-tets
meshes of a seeded field at grid 16 (both packages extract the same one,
`tests/test_torch_prior.py`), built once in numpy and handed to both."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.geometry import mesh as jmesh
from animals3d_tpu.geometry import tets as jtets
from animals3d_tpu.ops import dmtet as jdmtet
from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render import export as jexport
from animals3d_tpu.render import regularizer as jreg
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu_torch.geometry import mesh as tmesh
from animals3d_tpu_torch.ops import rasterize as trz
from animals3d_tpu_torch.render import export as texport
from animals3d_tpu_torch.render import regularizer as treg

RES = 16


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def meshes():
    """(JAX Mesh, port Mesh) of one marching-tets mesh, batch 2 (the
    second a scaled, shifted copy), with normals and v_tex."""
    verts, _ = jtets.kuhn_lattice(RES)
    r = np.random.default_rng(0)
    rad = np.linalg.norm(verts * np.asarray([1.0, 1.4, 0.8]), axis=-1)
    sdf = (0.3 - rad + 0.02 * r.standard_normal(len(verts))) \
        .astype(np.float32)
    v_cap, f_cap = jtets.default_capacity(RES)
    out = jdmtet.marching_tets_lattice(jnp.asarray(verts), jnp.asarray(sdf),
                                       RES, v_cap, f_cap)
    v = np.asarray(out.verts)
    vb = np.stack([v, v * 1.1 + 0.05]).astype(np.float32)
    args = (vb, np.asarray(out.faces), np.asarray(out.v_valid),
            np.asarray(out.f_valid), np.asarray(out.num_verts),
            np.asarray(out.num_faces))
    jm = jmesh.make_mesh(*(jnp.asarray(a) for a in args),
                         v_tex=jnp.asarray(vb[:1]),
                         face_gidx=out.face_gidx)
    tm = tmesh.make_mesh(t(vb), t(args[1]).long(), t(args[2]), t(args[3]),
                         t(args[4]), t(args[5]), v_tex=t(vb[:1]),
                         face_gidx=t(np.asarray(out.face_gidx)).long())
    return jm, tm


def camera_rast(jm, H=32):
    """JAX's rasterization of `jm` from a camera 1.5 units back: the same
    `Rast` (uv, z, face_id) for both packages."""
    f = 4.0
    proj = np.asarray([[f, 0, 0, 0], [0, f, 0, 0], [0, 0, -1.02, -0.2],
                       [0, 0, -1, 0]], np.float32)
    view = np.eye(4, dtype=np.float32)
    view[2, 3] = -1.5
    mvp = np.broadcast_to(proj @ view, (2, 4, 4))
    clip = jxfm(jm.v_pos, jnp.asarray(mvp))
    rast = jrz.rasterize(clip, jm.t_pos_idx, jm.f_valid, (H, H))
    rast = jrz.Rast(uv=jrz.compute_barycentrics(
        clip, jm.t_pos_idx, rast.face_id, (H, H)), z=rast.z,
        face_id=rast.face_id) if rast.uv is None else rast
    assert int((np.asarray(rast.face_id) > 0).sum()) > 100
    return rast


@pytest.mark.parametrize("fn", ["interpolate", "interpolate_sorted_bwd"])
@pytest.mark.parametrize("shared", [False, True])
def test_interpolate_matches_jax(meshes, fn, shared):
    """Values within 1e-6; the gradients to the attributes and to the
    barycentrics within 1e-5 of their largest entry (sums in another
    order: autograd's scatter-add or the sorted segment sum)."""
    jm, _tm = meshes
    rast = camera_rast(jm)
    r = np.random.default_rng(1)
    V = jm.v_pos.shape[1]
    attr = r.normal(size=(V, 4) if shared else (2, V, 4)) \
        .astype(np.float32)
    w = r.normal(size=(2, 32, 32, 4)).astype(np.float32)
    faces = jm.t_pos_idx

    def jf(a, uv):
        out = getattr(jrz, fn)(a, jrz.Rast(uv=uv, z=rast.z,
                                           face_id=rast.face_id), faces)
        return jnp.sum(out * w), out
    (_l, want), (ja, juv) = jax.value_and_grad(jf, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(attr), rast.uv)
    ta = t(attr).requires_grad_(True)
    tuv = t(rast.uv).requires_grad_(True)
    got = getattr(trz, fn)(ta, trz.Rast(uv=tuv, z=t(rast.z),
                                        face_id=t(rast.face_id)),
                           t(faces).long())
    (got * t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    for g, jg in ((ta.grad, ja), (tuv.grad, juv)):
        jg = np.asarray(jg)
        assert np.abs(jg).max() > 0
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())


def test_gather_rows_matches_jax():
    """The batched row gather and its sorted-segment-sum backward."""
    r = np.random.default_rng(2)
    table = r.normal(size=(2, 50, 3)).astype(np.float32)
    idx = r.integers(0, 50, (2, 7, 9)).astype(np.int32)
    w = r.normal(size=(2, 7, 9, 3)).astype(np.float32)
    out_j = jrz.gather_rows(jnp.asarray(table), jnp.asarray(idx))
    jg = jax.grad(lambda x: jnp.sum(jrz.gather_rows(x, jnp.asarray(idx))
                                    * w))(jnp.asarray(table))
    tt = t(table).requires_grad_(True)
    got = trz.gather_rows(tt, t(idx).long())
    (got * t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)


def test_regularizers_match_jax(meshes):
    """Both regularizers and their gradients to the vertex positions (and
    normals): 1e-6 relative on the values, 1e-5 of the largest entry on
    the gradients; `index_add_` sums in another order than XLA's
    scatter-add."""
    jm, tm = meshes
    for name, field in (("laplace_regularizer_const", "v_pos"),
                        ("normal_consistency", "v_nrm")):
        want, jg = jax.value_and_grad(lambda x: getattr(jreg, name)(
            dataclasses.replace(jm, **{field: x})))(getattr(jm, field))
        x = getattr(tm, field).clone().requires_grad_(True)
        got = getattr(treg, name)(dataclasses.replace(tm, **{field: x}))
        got.backward()
        assert float(want) > 0
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        jg = np.asarray(jg)
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max(),
                                   err_msg=name)


def texture_fns():
    """The same analytic texture field for both packages: (1, P, 3) →
    (1, P, 4), a sigmoid of a fixed linear map of sines."""
    m = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)

    def jfn(p):
        return jax.nn.sigmoid(jnp.sin(p * 4.0) @ m)

    def tfn(p):
        return torch.sigmoid(torch.sin(p * 4.0) @ torch.from_numpy(m))
    return jfn, tfn


def test_atlas_layouts_and_bakes_match_jax(meshes):
    """`face_cell_uvs`, `map_uv_reference` equal; both bakes within 1e-6
    (the texture field is evaluated on the same float32 positions)."""
    jm, tm = meshes
    jfn, tfn = texture_fns()
    F = jm.t_pos_idx.shape[0]
    for a, b in zip(texport.face_cell_uvs(F), jexport.face_cell_uvs(F)):
        np.testing.assert_array_equal(a, b)
    gidx = np.asarray(jm.face_gidx)[np.asarray(jm.f_valid)]
    max_idx = 2 * 6 * RES ** 3
    for a, b in zip(texport.map_uv_reference(gidx, max_idx),
                    jexport.map_uv_reference(gidx, max_idx)):
        np.testing.assert_array_equal(a, b)
    want, wuv = jexport.bake_texture_atlas(jm, jfn, atlas_res=64)
    got, guv = texport.bake_texture_atlas(tm, tfn, atlas_res=64)
    np.testing.assert_array_equal(guv, wuv)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert want.std() > 0.01
    want, wuv = jexport.bake_texture_atlas_reference(jm, jfn, max_idx, 64)
    got, guv = texport.bake_texture_atlas_reference(tm, tfn, max_idx, 64)
    np.testing.assert_array_equal(guv, wuv)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("layout", ["dense", "reference", None])
def test_obj_export_matches_jax_and_round_trips(meshes, tmp_path, layout):
    """The written OBJ and MTL equal the JAX package's byte for byte, the
    baked PNGs within one 8-bit level; `load_obj` / `load_mtl` read back
    the vertex, face and uv counts and the material (kd sRGB → linear,
    ks's red channel cleared), as the JAX readers do."""
    from PIL import Image
    jm, tm = meshes
    jfn, tfn = texture_fns()
    kw = dict(atlas_res=64)
    if layout == "reference":
        kw.update(uv_layout="reference", max_gidx=2 * 6 * RES ** 3)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath = jexport.save_obj_with_mtl(str(tmp_path / "j" / "m.obj"), jm,
                                      jfn if layout else None, **kw)
    tpath = texport.save_obj_with_mtl(str(tmp_path / "t" / "m.obj"), tm,
                                      tfn if layout else None, **kw)
    assert open(tpath).read() == open(jpath).read()
    v, f, uv, uv_idx = texport.load_obj(tpath)
    n_v, n_f = int(jm.num_verts), int(jm.num_faces)
    assert v.shape == (n_v, 3) and f.shape == (n_f, 3)
    for a, b in zip((v, f, uv, uv_idx), jexport.load_obj(jpath)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    if layout is None:
        assert uv is None
        return
    assert uv.shape == (3 * n_f, 2) and uv_idx.shape == (n_f, 3)
    assert open(tpath[:-4] + ".mtl").read() == \
        open(jpath[:-4] + ".mtl").read()
    png = lambda p: np.asarray(Image.open(p[:-4] + "_kd.png"), np.int32)
    assert np.abs(png(tpath) - png(jpath)).max() <= 1
    (tmat,), (jmat,) = texport.load_mtl(tpath[:-4] + ".mtl"), \
        jexport.load_mtl(jpath[:-4] + ".mtl")
    assert set(tmat) == set(jmat)
    for key in ("kd", "ks"):
        np.testing.assert_allclose(tmat[key].numpy(), np.asarray(jmat[key]),
                                   atol=2e-6, rtol=0, err_msg=key)
