"""Port parity of `render_mesh` (the modes the MagicPony forward asks for:
`shaded` and `dino_pred`, antialias included) on the JAX prior mesh seen
by two cameras at 64², with the texture and DINO fields of one set of
weights. atol 1e-4, and 1e-3 on antialiased silhouette pairs (4.1e-4
seen), away from pixels whose face flips on float32 rounding (3 of 8,192
seen; each checked as a float64 tie by `assert_images_close`). z within
1e-3: the plane equation of a sub-pixel face at NDC depth ~0.98 loses
digits to cancellation, 9.1e-4 seen."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu_torch.geometry.mesh import Mesh as TMesh
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points as txfm
from test_animal_model import TINY_OVERRIDES
from torch_parity import assert_images_close, build_pair, to_np

H = 64
OVERRIDES = TINY_OVERRIDES + [
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16"]


@pytest.fixture(scope="module")
def scene():
    set_mixed_precision(None)
    jm, jp, tm = build_pair(OVERRIDES)
    phase = jm.phase_for_iter(50000)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)
    prior, _ = jm.netBase.apply({"params": jp["netBase"]}, grid, v_cap,
                                f_cap, 50000, None)
    # two cameras around the prior mesh, as the instance predictor poses
    # them (rotation about y, camera at the configured distance)
    ang = np.asarray([0.4, 2.3], np.float32)
    c, s = np.cos(ang), np.sin(ang)
    z, o = np.zeros_like(ang), np.ones_like(ang)
    rot = np.stack([c, z, s, z, o, z, -s, z, c], -1)
    pose = np.concatenate([rot, np.asarray([[0.1, -0.2, 0.3],
                                            [-0.2, 0.1, 0.0]])], -1)
    mvp, w2c, campos = (to_np(a) for a in
                        tm.netInstance.get_camera_extrinsics_from_pose(
                            torch.from_numpy(pose.astype(np.float32))))
    rng = np.random.default_rng(7)
    feat = rng.uniform(-1, 1, (2, 32)).astype(np.float32)
    ldir = rng.normal(size=(2, 3))
    ldir /= np.linalg.norm(ldir, axis=-1, keepdims=True)
    light = np.concatenate([ldir, np.full((2, 1), 0.3), np.full((2, 1), 0.6)],
                           -1).astype(np.float32)
    bg = rng.uniform(0, 1, (2, H, H, 3)).astype(np.float32)
    return jm, jp, tm, prior, mvp, w2c, campos, feat, light, bg


def _port_mesh(m):
    t = lambda a: torch.from_numpy(np.asarray(a))
    return TMesh(v_pos=t(m.v_pos), t_pos_idx=t(m.t_pos_idx).long(),
                 v_valid=t(m.v_valid), f_valid=t(m.f_valid),
                 num_verts=t(m.num_verts), num_faces=t(m.num_faces),
                 v_nrm=t(m.v_nrm), v_tex=t(m.v_tex))


@pytest.mark.parametrize("modes", [("shaded",), ("shaded", "dino_pred")])
def test_render_mesh_matches(scene, modes):
    set_mixed_precision(None)
    jm, jp, tm, prior, mvp, w2c, campos, feat, light, bg = scene
    want = jm.render(jp, list(modes), prior, jnp.asarray(mvp),
                     jnp.asarray(w2c), jnp.asarray(campos), (H, H),
                     im_features=jnp.asarray(feat),
                     light_params=jnp.asarray(light), prior_mesh=prior,
                     use_dino="dino_pred" in modes,
                     background=jnp.asarray(bg))
    tprior = _port_mesh(prior)
    t = torch.from_numpy
    launches = rc.visibility.launches
    with torch.no_grad():
        got = tm.render(list(modes), tprior, t(mvp), t(w2c), t(campos),
                        (H, H), im_features=t(feat), light_params=t(light),
                        prior_mesh=tprior, use_dino="dino_pred" in modes,
                        background=t(bg))
        v_clip = txfm(tprior.v_pos.expand(2, -1, -1), t(mvp))
        rast = rc.rasterize_cuda(v_clip, tprior.t_pos_idx, tprior.f_valid,
                                 (H, H), v_pos0=tprior.v_pos[0])
    assert rc.visibility.launches == launches      # the CPU path launches none
    jclip = jxfm(jnp.broadcast_to(prior.v_pos, (2, *prior.v_pos.shape[1:])),
                 jnp.asarray(mvp))
    jrast = jrz.rasterize(jclip, prior.t_pos_idx, prior.f_valid, (H, H))
    assert (to_np(rast.face_id) > 0).sum() > 200   # the mesh is in view
    for key in modes:
        assert got[key].shape == want[key].shape, key
        assert_images_close(got[key], want[key], rast, jrast, v_clip,
                            tprior.t_pos_idx)
