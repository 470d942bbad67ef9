"""Port parity of the render modes the Visualizer and the trainer's visual
logging ask for (`kd`, `ks`, `normal`, `geo_normal`, `shading`, `depth`,
`tangent`), at spp 1 and 2, and of the helpers they use: tangents, the
fixed light, axis-angle conversions, the orbit cameras, the camera's
`offset_extra` and `articulate_with_angles` (MagicPony's skeleton and the
bird's legless one), and one eval forward of `train_magicpony_bird`.

Images: atol 1e-4, 1e-3 on antialiased silhouette pairs, away from the
pixels whose face flips on float32 rounding (each a float64 tie, at most
0.1% of the full-resolution pixels), as `torch_parity.assert_images_close`
sets out; z within 1e-3 at spp 1 and 3e-3 at spp 2, as in
`tests/test_torch_recon.py`: at 128² more faces are sub-pixel, and the
plane equation of one at NDC depth ~0.98 loses digits to cancellation
(1.5e-3 seen). Helpers on seeded inputs: 1e-5 (float32 math of the same
formulas)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.geometry import mesh as jmesh
from animals3d_tpu.geometry import skinning as jsk
from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render import light as jlight
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu.visualization import azimuth_rotation as j_azimuth
from animals3d_tpu.visualization import orbit_cameras as j_orbit
from animals3d_tpu_torch.geometry import mesh as tmesh
from animals3d_tpu_torch.geometry import skinning as tsk
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render import light as tlight
from animals3d_tpu_torch.render.camera import xfm_points as txfm
from animals3d_tpu_torch.visualization import azimuth_rotation, orbit_cameras
from test_animal_model import TINY_OVERRIDES
from test_torch_render import H, _port_mesh, scene  # noqa: F401
from torch_parity import (_grow, _silhouette_pairs, assert_same_visibility,
                          build_pair, to_np)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


NEW_MODES = ("kd", "ks", "normal", "geo_normal", "shading", "depth",
             "tangent")
HELPER_TOL = 1e-5


def _face_uvs(n_faces, seed=3):
    return np.random.default_rng(seed).uniform(
        0, 1, (n_faces, 3, 2)).astype(np.float32)


def _with_tangents(jprior):
    """The JAX prior with `v_tng` from `compute_tangents` on seeded UVs,
    and the port's copy carrying the port's own tangents."""
    uvs = _face_uvs(jprior.t_pos_idx.shape[0])
    jt = jmesh.compute_tangents(jprior.v_pos, jprior.t_pos_idx,
                                jnp.asarray(uvs), jprior.v_nrm,
                                jprior.v_valid, jprior.f_valid)
    import dataclasses
    jp = dataclasses.replace(jprior, v_tng=jt)
    tp = _port_mesh(jprior)
    tt = tmesh.compute_tangents(tp.v_pos, tp.t_pos_idx,
                                torch.from_numpy(uvs), tp.v_nrm, tp.v_valid,
                                tp.f_valid)
    return jp, dataclasses.replace(tp, v_tng=tt)


def assert_images_close_spp(got, want, rast, rast_want, v_clip, faces, spp,
                            atol=1e-4, silhouette_atol=1e-3, z_atol=1e-3,
                            max_share=0.001):
    """`torch_parity.assert_images_close` for an image rendered at spp:
    the visibility check runs at full resolution, and an output pixel is
    left out (or held to `silhouette_atol`) where any of its spp × spp
    samples is."""
    got, want = to_np(got), to_np(want)
    fid, fid_want = to_np(rast.face_id), to_np(rast_want.face_id)
    assert_same_visibility(fid, fid_want, to_np(rast.z), to_np(rast_want.z),
                           to_np(v_clip), to_np(faces), z_atol=z_atol,
                           max_share=max_share)

    def pool(m):
        b, h, w = m.shape
        return m.reshape(b, h // spp, spp, w // spp, spp).any((2, 4))

    # the antialias pass blends neighbours; shading at the base resolution
    # reads one sample of each spp × spp block: grow by spp
    near = fid != fid_want
    for _ in range(spp):
        near = _grow(near)
    near = pool(near)
    sil = pool(_silhouette_pairs(fid, to_np(rast.z))
               | _silhouette_pairs(fid_want, to_np(rast_want.z)))
    for mask, tol in ((~near & ~sil, atol), (~near & sil, silhouette_atol)):
        keep = np.broadcast_to(mask[:, None], got.shape)
        np.testing.assert_allclose(got[keep], want[keep], atol=tol, rtol=0)


_RENDERS = {}


def _renders(scene, spp):  # noqa: F811
    """Both packages' renders of every new mode at `spp`, with the
    full-resolution rasts (cached per spp)."""
    if spp in _RENDERS:
        return _RENDERS[spp]
    set_mixed_precision(None)
    jm, jp, tm, prior, mvp, w2c, campos, feat, light, bg = scene
    jprior, tprior = _with_tangents(prior)
    want = jm.render(jp, list(NEW_MODES), jprior, jnp.asarray(mvp),
                     jnp.asarray(w2c), jnp.asarray(campos), (H, H),
                     im_features=jnp.asarray(feat),
                     light_params=jnp.asarray(light), prior_mesh=jprior,
                     background=jnp.asarray(bg), spp=spp)
    t = torch.from_numpy
    with torch.no_grad():
        got = tm.render(list(NEW_MODES), tprior, t(mvp), t(w2c), t(campos),
                        (H, H), im_features=t(feat), light_params=t(light),
                        prior_mesh=tprior, background=t(bg), spp=spp)
        v_clip = txfm(tprior.v_pos.expand(2, -1, -1), t(mvp))
        rast = rc.rasterize_cuda(v_clip, tprior.t_pos_idx, tprior.f_valid,
                                 (H * spp, H * spp), v_pos0=tprior.v_pos[0])
    jclip = jxfm(jnp.broadcast_to(prior.v_pos, (2, *prior.v_pos.shape[1:])),
                 jnp.asarray(mvp))
    jrast = jrz.rasterize(jclip, prior.t_pos_idx, prior.f_valid,
                          (H * spp, H * spp))
    _RENDERS[spp] = (got, want, rast, jrast, v_clip, tprior.t_pos_idx)
    return _RENDERS[spp]


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("mode", NEW_MODES)
def test_render_mode_matches(scene, mode, spp):  # noqa: F811
    """Each new mode of the port's `render_mesh` (through `AnimalModel.
    render` with `spp`) against the JAX one on the same prior mesh, two
    cameras, texture, light and background."""
    got, want, rast, jrast, v_clip, faces = _renders(scene, spp)
    assert (to_np(rast.face_id) > 0).sum() > 200 * spp * spp
    g, w = got[mode], want[mode]
    assert g is not None and w is not None, mode
    assert tuple(g.shape) == tuple(w.shape), mode
    assert np.isfinite(to_np(g)).all()
    assert_images_close_spp(g, w, rast, jrast, v_clip, faces, spp,
                            z_atol=1e-3 if spp == 1 else 3e-3)


def test_tangents_and_mesh_views(scene):  # noqa: F811
    """`compute_tangents` on seeded face UVs against JAX (1e-5; the mesh
    has invalid capacity vertices, which take [1, 0, 0]), and
    `with_positions`, `first_n`, `get_n`."""
    jprior, tprior = _with_tangents(scene[3])
    np.testing.assert_allclose(to_np(tprior.v_tng), np.asarray(jprior.v_tng),
                               atol=HELPER_TOL, rtol=0)
    ext = tprior.extend(3)
    assert ext.v_tng.shape[0] == 3
    assert torch.equal(ext.get_n(2).v_pos, tprior.v_pos)
    assert ext.first_n(2).v_tex.shape[0] == 2
    moved = tprior.with_positions(tprior.v_pos + 1)
    assert torch.equal(moved.v_pos, tprior.v_pos + 1)
    assert moved.t_pos_idx is tprior.t_pos_idx


def test_rotation_helpers_match():
    """`matrix_to_axis_angle`, `axis_angle_to_matrix`, `azimuth_rotation`,
    `orbit_cameras` and `fixed_direction_light` against JAX on seeded
    inputs (1e-5), the identity's zero angle included."""
    r = np.random.default_rng(11)
    v = r.normal(size=(6, 3)).astype(np.float32)
    v[0] = 0.0
    t = torch.from_numpy
    mats = tsk.axis_angle_to_matrix(t(v))
    np.testing.assert_allclose(to_np(mats),
                               np.asarray(jsk.axis_angle_to_matrix(v)),
                               atol=HELPER_TOL, rtol=0)
    np.testing.assert_allclose(
        to_np(tsk.matrix_to_axis_angle(mats)),
        np.asarray(jsk.matrix_to_axis_angle(jnp.asarray(to_np(mats)))),
        atol=HELPER_TOL, rtol=0)
    ang = r.uniform(0, 2 * np.pi, 5).astype(np.float32)
    np.testing.assert_allclose(to_np(azimuth_rotation(t(ang))),
                               np.asarray(j_azimuth(jnp.asarray(ang))),
                               atol=HELPER_TOL, rtol=0)
    mvp, w2c = (r.normal(size=(4, 4)).astype(np.float32) for _ in range(2))
    campos = r.normal(size=3).astype(np.float32)
    angles = list(np.linspace(0, 2 * np.pi, 7, endpoint=False))
    for g, w in zip(orbit_cameras(t(mvp), t(w2c), t(campos), angles),
                    j_orbit(jnp.asarray(mvp), jnp.asarray(w2c),
                            jnp.asarray(campos), angles)):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=HELPER_TOL,
                                   rtol=0)
    d = r.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tlight.fixed_direction_light(t(d), 0.2, 0.7, 3)),
        np.asarray(jlight.fixed_direction_light(jnp.asarray(d), 0.2, 0.7,
                                                3)),
        atol=HELPER_TOL, rtol=0)


BIRD_OVERRIDES = TINY_OVERRIDES + [
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16"]


@pytest.fixture(scope="module", params=["train_magicpony_horse",
                                        "train_magicpony_bird"])
def skeleton_pair(request):
    set_mixed_precision(None)
    return request.param, build_pair(BIRD_OVERRIDES, config=request.param)


def _priors(jm, jp, tm, it):
    phase = jm.phase_for_iter(it)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)
    jprior, _ = jm.netBase.apply({"params": jp["netBase"]}, grid, v_cap,
                                 f_cap, it, None)
    tgrid, tv, tf = tm.grid_for_phase(tm.phase_for_iter(it))
    with torch.no_grad():
        tprior, _ = tm.netBase(tgrid, tv, tf)
    return jprior, tprior


def test_articulate_and_camera_offset_match(skeleton_pair):
    """`articulate_with_angles` on seeded angles (B 1, F 2) and
    `get_camera_extrinsics_from_pose(offset_extra=…)` against JAX, for
    MagicPony's skeleton and the bird's legless one (`num_legs: 0`,
    `static_root_bones: true`), both skinning the JAX prior's vertices
    (the port's own prior agrees within 1e-5): posed vertices within 1e-4,
    their normals within 5e-4 (a normal normalizes a sum of cross
    products, which amplifies the posed vertices' float32 differences at
    vertices whose faces are slivers: 1.3e-4 seen), cameras within
    1e-5."""
    config, (jm, jp, tm) = skeleton_pair
    jprior, own_prior = _priors(jm, jp, tm, 50000)
    np.testing.assert_allclose(to_np(own_prior.v_pos),
                               np.asarray(jprior.v_pos), atol=1e-5, rtol=0)
    # both skin the same vertices: the skeleton's foot is an argmin over
    # them, which a 1e-6 difference can tip between two vertices
    tprior = _port_mesh(jprior)
    K = tm.netInstance.num_bones
    assert K == jm.netInstance.num_bones
    assert (K == 8) == (config == "train_magicpony_bird")
    angles = np.random.default_rng(5).uniform(
        -0.5, 0.5, (1, 2, K, 3)).astype(np.float32)
    want = jm.netInstance.apply({"params": jp["netInstance"]}, jprior,
                                jnp.asarray(angles),
                                method="articulate_with_angles")
    with torch.no_grad():
        got = tm.netInstance.articulate_with_angles(tprior,
                                                    torch.from_numpy(angles))
    assert got.v_pos.shape == want.v_pos.shape == (2, *jprior.v_pos.shape[1:])
    moved = np.abs(np.asarray(want.v_pos) - np.asarray(jprior.v_pos)).max()
    assert moved > 0.01
    np.testing.assert_allclose(to_np(got.v_pos), np.asarray(want.v_pos),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(got.v_nrm), np.asarray(want.v_nrm),
                               atol=5e-4, rtol=0)
    pose = np.concatenate([np.eye(3, dtype=np.float32).reshape(-1),
                           [0.1, -0.2, 0.3]])[None].astype(np.float32)
    for extra in (None, 4.0, 1.5):
        w = jm.netInstance.apply({"params": jp["netInstance"]},
                                 jnp.asarray(pose), offset_extra=extra,
                                 method="get_camera_extrinsics_from_pose")
        g = tm.netInstance.get_camera_extrinsics_from_pose(
            torch.from_numpy(pose), offset_extra=extra)
        for a, b in zip(g, w):
            np.testing.assert_allclose(to_np(a), np.asarray(b),
                                       atol=HELPER_TOL, rtol=0)


def test_bird_forward_matches():
    """One eval forward of `train_magicpony_bird` (the legless skeleton,
    static root bones, articulation and deformation on at 50,000) from
    the same weights and images: cameras, articulation angles and light
    within 1e-4, the posed vertices within 1e-4, and the shaded RGBA per
    `assert_images_close` with the recon test's tolerances
    (`tests/test_torch_recon.py`: silhouettes 4e-3, z 3e-3, 0.2% of the
    pixels flipped at most)."""
    from torch_parity import assert_images_close
    set_mixed_precision(None)
    jm, jp, tm = build_pair(BIRD_OVERRIDES, config="train_magicpony_bird")
    it = 50000
    phase = jm.phase_for_iter(it)
    assert phase.articulation_on and phase.deform_on
    assert jm.netInstance.cfg.cfg_articulation.num_legs == 0
    images = np.random.default_rng(it).uniform(
        0, 1, (2, 1, 3, H, H)).astype(np.float32)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)

    def chain(params, images):
        prior, _ = jm.netBase.apply({"params": params["netBase"]}, grid,
                                    v_cap, f_cap, it, None)
        out = jm.netInstance.apply(
            {"params": params["netInstance"]}, images, prior, it,
            jax.random.PRNGKey(1), phase._replace(is_training=False))
        renders = jm.render(params, ["shaded"], out[0], out[3], out[4],
                            out[5], (H, H), im_features=out[6],
                            light_params=out[10], prior_mesh=prior,
                            num_frames=1)
        rast = jrz.rasterize(jxfm(out[0].v_pos, out[3]), out[0].t_pos_idx,
                             out[0].f_valid, (H, H))
        return renders["shaded"], out, rast
    want, wout, wrast = jax.jit(chain)(jp, jnp.asarray(images))
    shaded, out = tm.reconstruct(tm, torch.from_numpy(images), it)
    for name, i in (("mvp", 3), ("arti_params", 9), ("light_params", 10)):
        np.testing.assert_allclose(to_np(out[i]), np.asarray(wout[i]),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(to_np(out[0].v_pos), np.asarray(wout[0].v_pos),
                               atol=1e-4, rtol=0)
    shape = out[0]
    with torch.no_grad():
        v_clip = txfm(shape.v_pos, out[3])
        rast = rc.rasterize_cuda(v_clip, shape.t_pos_idx, shape.f_valid,
                                 (H, H), v_pos0=shape.v_pos[0])
    assert (to_np(rast.face_id) > 0).sum() > 100
    assert_images_close(shaded, want, rast, wrast, v_clip, shape.t_pos_idx,
                        silhouette_atol=4e-3, z_atol=3e-3, max_share=0.002)
