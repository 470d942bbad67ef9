"""The reference's non-default options in the port, against the JAX
package on the CPU in float32: the single-pose rotation representations
(`rot_rep` euler_angle, quaternion, lookat), the ViT encoder without its
final conv (`final_layer_type` none), the articulation refinement pass
(`enable_refine`), the real-background training forward
(`background_mode` input and background), farthest-point bone sampling
(`estimate_bones(resample=True)`), `xfm_vectors` and `normalize_imagenet`;
and the discriminator Adam's restart on resume, as the JAX trainer does
it. The JAX weights are carried across with `load_jax_params`; inputs are
made with numpy from a seed.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.geometry import skinning as jsk
from animals3d_tpu.geometry import tets as jtets
from animals3d_tpu.geometry.tets import DeviceTetGrid
from animals3d_tpu.networks import vit as jvit
from animals3d_tpu.phase import Phase as JPhase
from animals3d_tpu.predictors import BasePredictor as JBase
from animals3d_tpu.predictors import InstancePredictor as JInstance
from animals3d_tpu.predictors.instance import ViTEncoder as JViTEncoder
from animals3d_tpu.render import camera as jcam
from animals3d_tpu_torch import checkpoint as tckpt
from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch import run as trun
from animals3d_tpu_torch.convert_jax import load_jax_params
from animals3d_tpu_torch.geometry import skinning as tsk
from animals3d_tpu_torch.geometry.mesh import Mesh as TMesh
from animals3d_tpu_torch.networks import vit as tvit
from animals3d_tpu_torch.phase import Phase as TPhase
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.predictors import InstancePredictor as TInstance
from animals3d_tpu_torch.predictors import (InstancePredictorConfig as
                                            TInstanceConfig)
from animals3d_tpu_torch.predictors.instance import ViTEncoder as TViTEncoder
from animals3d_tpu_torch.render import camera as tcam
from animals3d_tpu_torch.trainer import disc_step, make_optimizer
from test_animal_model import TINY_OVERRIDES
from test_predictors import (F_CAP, GRID_RES, V_CAP, _base_cfg,
                             _instance_cfg)
from test_torch_train import (DARK, Pair, gradient_gaps, leaf_tolerance,
                              search_here)
from torch_parity import batch_to, fake_batch_np, flat_tree, numpy_tree

ATOL = 1e-5          # the networks' parity limit (test_torch_networks.py)
ARTI_ATOL = 1e-4     # the articulation limit of test_torch_phases.py


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _float32():
    set_mixed_precision(None)
    yield
    set_mixed_precision(None)


def _port_cfg(jcfg):
    return tcfg.bind(TInstanceConfig, dataclasses.asdict(jcfg))


def _with(cfg, section, **kw):
    return dataclasses.replace(
        cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed, B=2, H=64):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, 1, 3, H, H)).astype(np.float32)


# ---------------------------------------------------------------------------
# pose representations and the encoder without its final conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep,cout", [("euler_angle", 6), ("quaternion", 7),
                                      ("lookat", 6)])
def test_forward_pose_rot_reps_match_jax(rep, cout):
    """Each single-pose head, sized and decoded as the JAX package does;
    its hypothesis sampling refuses, as JAX's does."""
    jcfg = _with(_instance_cfg(), "cfg_pose", rot_rep=rep,
                 max_rot_x_range=30.0, max_rot_y_range=120.0,
                 max_rot_z_range=45.0)
    jm = JInstance(cfg=jcfg)
    images = _images(1)

    def pose_only(m, images):
        _g, _k, p_out, p_key = m.forward_encoder(images)
        return m.forward_pose(p_out, p_key, zeroy=True)

    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(images),
                     method=pose_only)["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(images),
                               method=pose_only))
    tm = TInstance(_port_cfg(jcfg), image_size=64)
    tree = numpy_tree(params)
    load_jax_params(tm.netEncoder, tree["netEncoder"])
    load_jax_params(tm.netPose, tree["netPose"])
    with torch.no_grad():
        _g, _k, p_out, p_key = tm.forward_encoder(torch.from_numpy(images))
        got = tm.forward_pose(p_out, p_key, zeroy=True).numpy()
    assert got.shape == want.shape == (2, cout)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    with pytest.raises(NotImplementedError):
        tm.sample_pose_hypothesis(torch.from_numpy(got), 1000, False)


def test_vit_encoder_without_final_conv_matches_jax():
    """`final_layer_type` none: the class token and its block-11 key are
    the global features; no Encoder32 head is built."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 32, 32)) \
        .astype(np.float32)
    jm = JViTEncoder(cout=32, final_layer_type="none")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = TViTEncoder(cout=32, final_layer_type="none", image_size=32)
    assert not hasattr(tm, "final_layer_patch_out")
    load_jax_params(tm, numpy_tree(params))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got[0].shape == (2, 384) and got[1].shape == (2, 384)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# articulation refinement
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def prior(tmp_path_factory):
    """The JAX prior mesh of `tests/test_predictors.py` (on the Kuhn
    lattice: the directory holds no npz grid), and as a port `Mesh`."""
    grid = DeviceTetGrid(jtets.load_tet_grid(
        GRID_RES, data_dir=str(tmp_path_factory.mktemp("tets"))))
    base = JBase(cfg=_base_cfg())
    bparams = base.init(jax.random.PRNGKey(0), grid, V_CAP, F_CAP,
                        method=JBase.init_all)["params"]
    m, _ = base.apply({"params": bparams}, grid, V_CAP, F_CAP)
    port = TMesh(v_pos=_t(m.v_pos), t_pos_idx=_t(m.t_pos_idx).long(),
                 v_valid=_t(m.v_valid), f_valid=_t(m.f_valid),
                 num_verts=_t(m.num_verts), num_faces=_t(m.num_faces),
                 v_nrm=_t(m.v_nrm), v_tex=_t(m.v_tex))
    return m, port


@pytest.mark.parametrize("delta", [False, True])
def test_articulation_refine_matches_jax(prior, delta):
    """The second articulation pass on the posed bones
    (`refine_feature_mode` dino_global+dino_sample), adding a delta or
    re-predicting, at the sizes of `test_predictors.py`'s refine test:
    `forward_articulation`'s angles and posed vertices from the same
    encoder features and cameras (the JAX encoder's; the ViT's own float32
    gap, ~1e-5, grows tenfold through each random-weight attention net),
    and the whole instance forward's angles without the delta."""
    jprior, tprior = prior
    jcfg = _with(_instance_cfg(), "cfg_articulation", enable_refine=True,
                 refine_feature_mode="dino_global+dino_sample",
                 predict_delta=delta)
    jm = JInstance(cfg=jcfg)
    images = jnp.asarray(_images(3))
    params = jm.init(jax.random.PRNGKey(0), images, jprior, 5000,
                     jax.random.PRNGKey(1),
                     method=JInstance.init_all)["params"]
    jphase = JPhase(deform_on=False, articulation_on=True,
                    constrain_legs=True, zeroy=True, is_training=False)
    tm = TInstance(_port_cfg(jcfg), image_size=64)
    assert hasattr(tm, "netArticulationRefine")
    load_jax_params(tm, numpy_tree(params))
    tphase = TPhase(**jphase._asdict())

    def inputs(m, images):
        _g, feat_key, _p, patch_key = m.forward_encoder(images)
        out = m(images, jprior, 5000, jax.random.PRNGKey(2), jphase)
        return feat_key, patch_key, out[3], out[4], out[9]

    feat, patch, mvp, w2c, jarti = jm.apply({"params": params}, images,
                                            method=inputs)
    jmesh, jangles, _ = jm.apply(
        {"params": params}, jprior, feat, patch, mvp, w2c, 2, 1, jphase,
        method=JInstance.forward_articulation)
    with torch.no_grad():
        tmesh, tangles, _ = tm.forward_articulation(
            tprior, _t(feat), _t(patch), _t(mvp), _t(w2c), 2, 1, tphase)
        tarti = tm(_t(images), tprior, 5000, tphase)[9]
    assert tangles.shape == (2, 1, 20, 3)
    np.testing.assert_allclose(tangles.numpy(), np.asarray(jangles),
                               atol=ARTI_ATOL, rtol=0)
    np.testing.assert_allclose(tmesh.v_pos.numpy(), np.asarray(jmesh.v_pos),
                               atol=ARTI_ATOL, rtol=0)
    if not delta:
        np.testing.assert_allclose(tarti.numpy(), np.asarray(jarti),
                                   atol=ARTI_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# farthest-point sampling, bones from a subsample, the two helpers
# ---------------------------------------------------------------------------

def _two_clusters():
    """The points of `test_skinning.py`'s farthest-point test."""
    rng = np.random.default_rng(3)
    a = rng.normal(0, 0.01, (40, 3)) + np.array([5.0, 0, 0])
    b = rng.normal(0, 0.01, (40, 3)) - np.array([5.0, 0, 0])
    return np.concatenate([a, b]).astype(np.float32)[None]


@pytest.mark.parametrize("masked,start", [(False, None), (True, None),
                                          (False, 17)])
def test_sample_farthest_points_matches_jax(masked, start):
    """The same indices and points, with and without a validity mask (the
    first cluster invalid) and from a given start."""
    pts = _two_clusters()
    valid = np.ones((1, 80), bool)
    valid[:, :40] = not masked
    st = None if start is None else np.array([start], np.int32)
    jout, jsel = jsk.sample_farthest_points(
        jnp.asarray(pts), 8, valid=jnp.asarray(valid),
        start=None if st is None else jnp.asarray(st))
    tout, tsel = tsk.sample_farthest_points(
        torch.from_numpy(pts), 8, valid=torch.from_numpy(valid),
        start=None if st is None else torch.from_numpy(st).long())
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    if masked:
        assert (tsel.numpy() >= 40).all()


def test_estimate_bones_resample_matches_jax():
    """`estimate_bones(resample=True)`: the V // 4 farthest points of the
    quadruped cloud of `test_skinning.py`, then the same bones and
    attachments."""
    from test_skinning import _quadruped_cloud
    pts = _quadruped_cloud(600)
    valid = np.ones(pts.shape[0], bool)
    valid[::7] = False
    jb, js = jsk.estimate_bones(jnp.asarray(pts)[None, None],
                                jnp.asarray(valid), 8, 4, 3, resample=True)
    tb, ts = tsk.estimate_bones(torch.from_numpy(pts)[None, None],
                                torch.from_numpy(valid), 8, 4, 3,
                                resample=True)
    assert tb.shape == (1, 1, 20, 2, 3)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(ts.body_bone_idx.numpy(),
                                  np.asarray(js.body_bone_idx))
    np.testing.assert_array_equal(ts.ancestors.numpy(),
                                  np.asarray(js.ancestors))


def test_xfm_vectors_and_normalize_imagenet_match_jax():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(2, 7, 3)).astype(np.float32)
    m = rng.normal(size=(2, 4, 4)).astype(np.float32)
    img = rng.uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.xfm_vectors(torch.from_numpy(v), torch.from_numpy(m)).numpy(),
        np.asarray(jcam.xfm_vectors(jnp.asarray(v), jnp.asarray(m))),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        tvit.normalize_imagenet(torch.from_numpy(img)).numpy(),
        np.asarray(jvit.normalize_imagenet(jnp.asarray(img))),
        atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# the real-background training forward
# ---------------------------------------------------------------------------

BG_IT = 20000        # articulation on, as test_animal_model.py's bg test
BG_SIZE = 32         # the background frame's width: resized to the render


def bg_overrides(mode):
    return TINY_OVERRIDES + [f"model.cfg_render.background_mode={mode}",
                             f"dataset.background_mode={mode}"]


class BgPair(Pair):
    """`test_torch_train.Pair` at `TINY_OVERRIDES` with a real-background
    mode; "background" batches carry a dark `bg_images` frame of
    `BG_SIZE`², which both packages resize to the render."""

    def __init__(self, it, overrides, models=None):
        super().__init__(it, overrides, models)
        if "model.cfg_render.background_mode=background" in overrides:
            r = np.random.default_rng(5)
            self.batch["bg_images"] = (r.uniform(0, 1, (
                2, 1, 3, BG_SIZE, BG_SIZE)) * DARK).astype(np.float32)
            self.jbatch = batch_to(self.batch, jnp.asarray)
            self.tbatch = batch_to(self.batch, torch.from_numpy)


_BG_PAIRS = {}
# the key the first mode's search settled on: the modes share weights,
# batch images and draws, and the background enters no discrete
# decision, so the second mode's search starts there
_BG_KEYS = {}


def bg_pair(mode):
    """The `BgPair` of `mode`, built once for the module. The modes share
    their weights, so the second is made from the first's models with
    `cfg_render.background_mode` changed (the only setting the mode
    reads): a shallow copy of the JAX model, and the port model itself,
    its mode set on every call. It also takes the first's jitted JAX
    texture pre-activations (`Pair.relu_tie`): the texture field reads the
    posed surface and the image features, which the background leaves
    alone."""
    if mode not in _BG_PAIRS:
        other = next(iter(_BG_PAIRS.values()), None)
        models = None
        if other is not None:
            jm = copy.copy(other.jm)
            jm.cfg_render = dataclasses.replace(jm.cfg_render,
                                                background_mode=mode)
            models = (jm, other.jp, other.tm)
        _BG_PAIRS[mode] = BgPair(BG_IT, bg_overrides(mode), models)
        if other is not None:
            _BG_PAIRS[mode].jax_preactivations = other.jax_preactivations
    pair = _BG_PAIRS[mode]
    pair.tm.cfg_render = dataclasses.replace(pair.tm.cfg_render,
                                             background_mode=mode)
    return pair


@pytest.mark.parametrize("mode", ["input", "background"])
def test_background_training_forward_matches_jax(mode):
    """The training forward compositing over the input image or over the
    batch's background frame (resized from 32² to 64²), its rgb loss
    unmasked: every metric and the loss within rtol 1e-4, every gradient
    leaf within `GRAD_TOL` of its norm (`leaf_tolerance`), at the first
    key on which both packages take the same discrete decisions
    (`search_here`, in this process at the module's two torch threads: a
    child's imports and second build would cost more than its passive
    waits save; the second mode starts from the first's key,
    `_BG_KEYS`). Where the render leaves a pixel and its neighbours
    uncovered the prediction is the background."""
    pair = bg_pair(mode)
    step = search_here(pair, start=_BG_KEYS.get("found", 0))
    _BG_KEYS.setdefault("found", step["seed"])
    assert set(step["tmet"]) == set(step["jmet"])
    for name, want in step["jmet"].items():
        np.testing.assert_allclose(float(step["tmet"][name]), float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(step["tloss"]), float(step["jloss"]),
                               rtol=1e-4)
    gaps = gradient_gaps(flat_tree(step["tgrads"]),
                         flat_tree(numpy_tree(step["jgrads"])))
    bad = {"/".join(p): g for p, g in gaps.items() if g > leaf_tolerance(p)}
    assert not bad, bad
    taux = step["taux"]
    img = taux["image_pred"].detach().numpy()
    mask = taux["mask_pred"].detach()
    # the antialias pass blends across neighbours: away from them
    near = torch.nn.functional.max_pool2d(
        (mask > 0).float().flatten(0, 1)[:, None], 3, stride=1,
        padding=1)[:, 0].reshape(mask.shape) > 0
    outside = np.broadcast_to((~near).numpy()[:, :, None], img.shape)
    if mode == "input":
        np.testing.assert_allclose(img[outside],
                                   pair.batch["images"][outside], atol=1e-6)
    else:
        assert img[outside].mean() > 0.01


def test_background_mode_without_bg_images_raises_as_jax():
    """`background` without `bg_images`: the same `ValueError` in both
    packages (JAX's while tracing its forward)."""
    pair = bg_pair("background")
    batch = fake_batch_np(0)
    with pytest.raises(ValueError, match="needs bg_images") as jerr:
        jax.jit(lambda p: pair.jm.forward(
            p, batch_to(batch, jnp.asarray), BG_IT, jax.random.PRNGKey(0),
            pair.phase))(pair.jp)
    with pytest.raises(ValueError, match="needs bg_images") as terr:
        pair.tm.forward(batch_to(batch, torch.from_numpy), BG_IT,
                        torch.Generator().manual_seed(0), pair.tphase)
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# the discriminator's Adam on resume
# ---------------------------------------------------------------------------

def test_resume_restarts_the_discriminator_adam(tmp_path):
    """The JAX trainer keeps no discriminator optimizer state and starts
    its Adam afresh at the first discriminator step of a run, a resumed
    one too (`animals3d_tpu/trainer.py` `_disc_opt_state`). The port's
    checkpoint may hold the `disc` Adam's state, but a resume leaves it
    out: the restored Adam has no state (step 0, zero moments), and its
    first step moves `netDisc` exactly as a fresh Adam does on the same
    weights and record."""
    from test_fauna import TINY_FAUNA
    args = ["--config-name", "train_fauna", "--device", "cpu", *TINY_FAUNA,
            "mixed_precision=false", "use_logger=false",
            f"checkpoint_dir={tmp_path}"]
    _c, tm, _tr = trun.build(args)
    tm.init_params(0)
    dim = tm.netBase.memory_bank.shape[1]
    g = torch.Generator().manual_seed(7)
    record = {k: torch.rand((2, 1 + dim, 64, 64), generator=g)
              for k in ("mask_gt", "mask_iv", "mask_rv")}
    opt = make_optimizer(tm)
    for _ in range(2):
        disc_step(tm, opt, record)
    tckpt.save_checkpoint(str(tmp_path), 5, {"model": tm.state_dict(),
                                             **opt.state_dict()})
    assert len(tckpt.read_checkpoint(os.path.join(
        str(tmp_path), "checkpoint0000005.pth"))["optimizer"]["disc"]
        ["state"]) > 0

    _c, resumed, tr = trun.build(args)
    opt2, start = tr.restore()
    assert start == 5 and len(opt2.disc.state) == 0
    _c, fresh, _tr = trun.build(args)
    fresh.load_state_dict(resumed.state_dict())
    disc_step(resumed, opt2, record)
    disc_step(fresh, make_optimizer(fresh), record)
    for (name, a), b in zip(resumed.netDisc.named_parameters(),
                            fresh.netDisc.parameters()):
        assert torch.equal(a, b), name
    assert all(int(s["step"]) == 1 for s in opt2.disc.state.values())
