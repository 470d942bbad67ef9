"""The port's Visualizer (`animals3d_tpu_torch.visualization`) against the
JAX package's on one tiny checkpoint that the JAX `Trainer` writes and
`convert_jax` carries over: every render mode, two keyframe files and the
keypoint artifacts at 64², spp 1 (the same file names; each frame, the uv
projections, the occlusion flags and the vertices compared), the texture
finetune in both loss styles, and Ponymation's animation on a stage-2
model. Without cv2 (hidden here) both packages write each video as png
frames, so every frame is compared.

Frames: each pixel's channels within `FRAME_TOL` of JAX's, but at most
`FRAME_FLIP_SHARE` of a frame's pixels, and of all pixels, off by more:
the pixels where a face flips between the two packages on float32
rounding, and the antialiased neighbours of those (the render parity
tests check such flips as float64 ties; `tests/test_torch_render.py`).
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu import config as jcfg
from animals3d_tpu import visualization as jvis
from animals3d_tpu.data.synth import write_synth_dataset
from animals3d_tpu.models import build_model as jbuild
from animals3d_tpu.precision import set_mixed_precision as jset_precision
from animals3d_tpu.trainer import Trainer as JTrainer
from animals3d_tpu.utils import results_io as jrio
from animals3d_tpu_torch import checkpoint as tckpt
from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch import visualization as tvis
from animals3d_tpu_torch.convert_jax import export_jax_params, load_jax_params
from animals3d_tpu_torch.models import build_model as tbuild
from animals3d_tpu_torch.noise import Noise
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.utils import results_io as trio
from test_animal_model import TINY_OVERRIDES
from torch_parity import flat_tree, jax_noise, numpy_tree


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


N_IMAGES = 1
FRAME_TOL = 2e-3
FRAME_FLIP_SHARE = 0.01
ALL_MODES = ["input_view", "other_views", "rotation", "animation",
             "canonicalization"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One JAX training iteration at TINY_OVERRIDES (float32), its
    parameters carried into a port checkpoint, and the data folder."""
    root = tmp_path_factory.mktemp("vis")
    synth, test = root / "data", root / "test"
    write_synth_dataset(str(synth), n=2, size=64, dino_dim=4)
    write_synth_dataset(str(test), n=N_IMAGES, size=64, dino_dim=4, seed=1)
    overrides = TINY_OVERRIDES + [
        f"dataset.train_data_dir={synth}", f"dataset.test_data_dir={synth}",
        f"checkpoint_dir={root / 'jax_ckpt'}", "num_iters=1",
        "save_checkpoint_freq=1", "use_logger=false",
        "dataset.num_workers=1", "mixed_precision=false"]
    cfg = jcfg.load_config("train_magicpony_horse", overrides=overrides)
    model_cfg = dict(cfg["model"])
    model_cfg["dataset"] = cfg["dataset"]
    jm = jbuild(model_cfg)
    params = numpy_tree(JTrainer(cfg, jm).train())
    jset_precision(None)
    set_mixed_precision(None)
    tcfg_ = tcfg.load_config("train_magicpony_horse", overrides=overrides)
    tcfg_["model"]["dataset"] = tcfg_["dataset"]
    tm = tbuild(tcfg_["model"], device="cpu")
    load_jax_params(tm, params)
    tckpt.save_checkpoint(str(root / "port_ckpt"), 1,
                          {"model": tm.state_dict()})
    K = tm.netInstance.num_bones
    anim = root / "anim"
    anim.mkdir()
    for i, scale in enumerate((0.0, 20.0)):
        np.savetxt(str(anim / f"arti_params_{i:02d}.txt"),
                   np.full((K, 3), scale))
    return root, test, anim, params


def _vis_overrides(root, synth, anim, out, ckpt_dir, ckpt_name, extra=()):
    return TINY_OVERRIDES + [
        f"dataset.test_data_dir={synth}", f"output_dir={out}",
        f"checkpoint_dir={ckpt_dir}", f"checkpoint_name={ckpt_name}",
        f"+arti_param_dir={anim}", "+canon_frames=5", "resolution=64",
        "+spp=1", "evaluate_keypoint=true", "finetune_texture=false",
        "render_modes=[" + ",".join(ALL_MODES) + "]", *extra]


def _recording(monkeypatch, module):
    """Record each image a results_io module writes, by file name, as
    float32 (C, H, W), and still write it."""
    frames = {}
    real = module.save_image

    def save(path, img):
        arr = img.detach().cpu().numpy() if hasattr(img, "detach") \
            else np.asarray(img)
        frames[os.path.basename(path)] = np.array(arr, np.float32)
        real(path, img)
    monkeypatch.setattr(module, "save_image", save)
    return frames


def _frames_agree(got, want):
    """Each frame's pixels within FRAME_TOL but a bounded share; returns
    (pixels off, pixels)."""
    assert sorted(got) == sorted(want)
    off = total = 0
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        bad = (np.abs(g - w) > FRAME_TOL).any(0) if g.ndim == 3 else \
            np.abs(g - w) > FRAME_TOL
        assert bad.mean() <= FRAME_FLIP_SHARE, (name, bad.mean())
        off += int(bad.sum())
        total += bad.size
    assert off <= FRAME_FLIP_SHARE * total
    return off, total


def _jit_renders(jv):
    """The JAX Visualizer's `render_views`, jitted once per mode list: the
    same function, without eager dispatch of each of its ops for each of
    the ~100 renders of an image."""
    real, cache = jv.render_views, {}

    def render_views(params, shape, prior_mesh, mvp, w2c, campos,
                     im_features, light_params, class_vector=None,
                     modes=("shaded", "geo_normal")):
        key = tuple(modes)
        if key not in cache:
            cache[key] = jax.jit(lambda *a: real(*a, modes=key))
        return cache[key](params, shape, prior_mesh, mvp, w2c, campos,
                          im_features, light_params, class_vector)
    jv.render_views = render_views


@pytest.fixture(scope="module")
def runs(trained, tmp_path_factory):
    """Both packages' `Visualizer.run` with every mode, keyframes and the
    keypoint artifacts; the JAX one from its own checkpoint, the port's
    from the carried-over one named by its file."""
    root, synth, anim, _params = trained
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "cv2", None)
    try:
        jframes = _recording(mp, jrio)
        tframes = _recording(mp, trio)
        jout, tout = str(root / "jax_vis"), str(root / "port_vis")
        jset_precision(None)
        jv = jvis.Visualizer(jcfg.load_config(
            "test_magicpony_horse", overrides=_vis_overrides(
                root, synth, anim, jout, root / "jax_ckpt", "null")))
        _jit_renders(jv)
        t0 = time.perf_counter()
        jv.run()
        print(f"JAX Visualizer.run: {time.perf_counter() - t0:.1f} s")
        set_mixed_precision(None)
        tv = tvis.Visualizer(tcfg.load_config(
            "test_magicpony_horse", overrides=_vis_overrides(
                root, synth, anim, tout, root / "port_ckpt",
                "checkpoint0000001.pth")), device="cpu")
        t0 = time.perf_counter()
        tv.run()
        print(f"port Visualizer.run: {time.perf_counter() - t0:.1f} s "
              f"{tv.seconds}")
    finally:
        mp.undo()
    return jout, tout, jframes, tframes, tv


def test_visualizer_writes_the_same_files_and_frames(runs):
    """The same file names in both output directories (the input view and
    its normals and shading, 12 other views, 75 rotation frames, 6
    animation frames (two keyframes 5-step interpolated), 5
    canonicalization frames and the keypoint files), and every frame in
    agreement (module docstring)."""
    jout, tout, jframes, tframes, tv = runs
    files = sorted(os.listdir(tout))
    assert files == sorted(os.listdir(jout))
    for i in range(N_IMAGES):
        p = f"{i:07d}"
        for suffix, n in (("_other_view_", 12), ("_rotation_", 75),
                          ("_animation_", 6), ("_canonicalization_", 5)):
            assert sum(f.startswith(p + suffix) for f in files) == n, suffix
        for name in ("_input_view.png", "_input_view_geo_normal.png",
                     "_input_view_shading.png", "_2d_projection_uv.txt",
                     "_binary_occlusion.txt", "_3d_vertices.txt",
                     "_pose.txt"):
            assert p + name in files, name
    assert set(tv.seconds) >= set(ALL_MODES) | {"reconstruct"}
    assert tframes["0000000_input_view.png"][:3].std() > 0
    off, total = _frames_agree(tframes, jframes)
    print(f"frames: {off} of {total} pixels beyond {FRAME_TOL}")


def test_keypoint_artifacts_match(runs):
    """uv projections and pose within 1e-4 (files written at 6 decimals),
    the posed vertices within 3e-4 (the skinning weights are a softmax of
    bone distances over a temperature, which amplifies the ViT's float32
    differences: 1.3e-4 seen); the occlusion flags equal but at vertices
    of faces whose visibility flips on a float32 tie: at most 1% of the
    vertices."""
    jout, tout = runs[:2]
    for i in range(N_IMAGES):
        p = f"{i:07d}"
        for name, tol in (("_2d_projection_uv.txt", 1e-4),
                          ("_3d_vertices.txt", 3e-4), ("_pose.txt", 1e-4)):
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(tout, p + name)),
                np.loadtxt(os.path.join(jout, p + name)), atol=tol, rtol=0,
                err_msg=name)
        occ_t = np.loadtxt(os.path.join(tout, p + "_binary_occlusion.txt"))
        occ_j = np.loadtxt(os.path.join(jout, p + "_binary_occlusion.txt"))
        assert occ_t.shape == occ_j.shape
        assert 0 < occ_j.sum() < occ_j.size
        assert (occ_t != occ_j).mean() <= 0.01


def test_evaluation_reads_the_artifacts(runs, tmp_path):
    """`animals3d_tpu_torch.evaluation.main` over the port's artifacts (the
    image's, and a copy as a second image) with keypoints near vertices
    gives the JAX package's scores on the JAX artifacts within 0.05 (the
    occlusion flags may differ at ties)."""
    import shutil
    from animals3d_tpu import evaluation as jev
    from animals3d_tpu_torch import evaluation as tev
    dirs = {}
    for name, out in zip(("jax", "port"), runs[:2]):
        dirs[name] = tmp_path / name
        dirs[name].mkdir()
        for i in range(2):
            for suffix in ("_2d_projection_uv.txt", "_binary_occlusion.txt"):
                shutil.copy(os.path.join(out, "0000000" + suffix),
                            dirs[name] / f"{i:07d}{suffix}")
    uv = np.loadtxt(os.path.join(runs[0], "0000000_2d_projection_uv.txt"))
    ann = tmp_path / "ann"
    ann.mkdir()
    r = np.random.default_rng(0)
    for i in range(2):
        pick = r.integers(0, len(uv), 6)
        kp = np.concatenate([uv[pick] + r.normal(0, 0.02, (6, 2)),
                             np.ones((6, 1))], 1)
        np.savetxt(str(ann / f"{i:07d}_keypoints.txt"), kp)
    args = ["--annotation-dir", str(ann), "--num-pairs", "50"]
    got = tev.main(["--result-dir", str(dirs["port"])] + args)
    want = jev.main(["--result-dir", str(dirs["jax"])] + args)
    assert got["num_valid_kp"] > 0
    assert got["num_pairs"] == want["num_pairs"]
    assert abs(got["pck"] - want["pck"]) <= 0.05


@pytest.mark.parametrize("style", ["magicpony", "fauna_l1"])
def test_finetune_matches_optax(trained, style):
    """Two Adam steps (lr 1e-3) of the finetune on netTexture alone, from
    the same weights, image and draws (the JAX key 0's, every step), in
    MagicPony's loss and in Fauna's unmasked L1 on the eval-phase nets
    (`fauna_finetune_loss`): every other parameter unchanged bit for bit;
    netTexture's entries within 2·2·lr of optax's (an Adam update is at
    most ~lr), each leaf's median gap within 2e-6 (0.1% of the ~2e-3 two
    updates move an entry; 8.5e-7 seen), and at most 15% of a leaf's
    entries beyond 2e-5. Adam divides each entry's gradient by its own
    magnitude, so an entry whose gradient is small against the two
    packages' float32 differences moves by a different share of lr: up to
    2.0e-3 apart, and 10.0% of the first layer's kernel beyond 2e-5 in the
    L1 style (its gradient is the sign of each pixel's residual; 2.1% in
    MagicPony's loss)."""
    from animals3d_tpu_torch.data import util as dutil
    root, synth, anim, params = trained
    extra = ["finetune_iters=2", "finetune_lr=0.001"] + \
        (["+fauna_finetune_loss=true"] if style == "fauna_l1" else [])
    ov = _vis_overrides(root, synth, anim, root / "unused", root, "null",
                        extra)
    jset_precision(None)
    set_mixed_precision(None)
    jv = jvis.Visualizer(jcfg.load_config("test_magicpony_horse",
                                          overrides=ov))
    tv = tvis.Visualizer(tcfg.load_config("test_magicpony_horse",
                                          overrides=ov), device="cpu")
    load_jax_params(tv.model, params)
    stem = sorted(str(p)[:-len("rgb.jpg")] for p in synth.glob("*rgb.jpg"))[0]
    image = dutil.load_image(stem + "rgb.jpg", 64)
    mask = dutil.load_image(stem + "mask.png", 64, mode="L")
    jbatch = jvis._single_image_batch(image, mask, 64)
    tbatch = tvis._single_image_batch(image, mask, 64, "cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    tm = tv.model
    K = tm.netInstance.num_pose_hypos
    phase = tm.phase_for_iter(10 ** 9, is_training=False)._replace(
        is_training=True)
    grid, v_cap, f_cap = tm.grid_for_phase(phase)
    first = jax_noise(jax.random.PRNGKey(0), 1, K)
    with torch.no_grad():
        prior, *_ = tm.forward_base(grid, v_cap, f_cap,
                                    jitter=first.jitter_u, batch=tbatch)
    tv.noise["finetune"] = jax_noise(jax.random.PRNGKey(0), 1, K,
                                     int(prior.num_verts))
    want = flat_tree(numpy_tree(jv.finetune(jparams, jbatch)))
    flags = {n: p.requires_grad for n, p in tm.named_parameters()}
    tv.finetune(tbatch)
    assert flags == {n: p.requires_grad for n, p in tm.named_parameters()}
    got = flat_tree(export_jax_params(tm))
    init = flat_tree(params)
    moved = 0
    for path, leaf in want.items():
        if path[:2] != ("netInstance", "netTexture"):
            np.testing.assert_array_equal(got[path], init[path])
            np.testing.assert_array_equal(leaf, init[path])
            continue
        name = "/".join(path)
        diff = np.abs(got[path] - leaf)
        assert diff.max() <= 4e-3, name
        assert np.median(diff) <= 2e-6, name
        assert (diff > 2e-5).mean() <= 0.15, (name, (diff > 2e-5).mean())
        moved += int(np.any(leaf != init[path]))
    assert moved >= 2


def test_ponymation_animation_on_stage2(tmp_path, monkeypatch):
    """Ponymation's stage-2 model (the VAE's articulation, its ε from the
    JAX `vae` key 2) through both Visualizers' `input_view` and keyframe
    `animation` on one image: the same files, frames in agreement."""
    from test_ponymation import TINY_PONY
    from torch_parity import build_pair
    set_mixed_precision(None)
    jset_precision(None)
    jm, jp, tm = build_pair(TINY_PONY, "train_ponymation_horse_stage2",
                            iters=())
    synth = tmp_path / "data"
    write_synth_dataset(str(synth), n=1, size=64, dino_dim=4)
    K = tm.netInstance.num_bones
    anim = tmp_path / "anim"
    anim.mkdir()
    for i, scale in enumerate((-10.0, 15.0)):
        np.savetxt(str(anim / f"arti_params_{i:02d}.txt"),
                   np.full((K, 3), scale))
    monkeypatch.setitem(sys.modules, "cv2", None)
    jframes = _recording(monkeypatch, jrio)
    tframes = _recording(monkeypatch, trio)
    outs = {}
    for name, pkg in (("jax", jcfg), ("port", tcfg)):
        outs[name] = str(tmp_path / name)
        cfg = pkg.load_config("test_ponymation_horse", overrides=TINY_PONY + [
            f"dataset.test_data_dir={synth}", f"output_dir={outs[name]}",
            f"+arti_param_dir={anim}", "+resolution=64", "+spp=1",
            "render_modes=[input_view,animation]"])
        if name == "jax":
            v = jvis.Visualizer(cfg)
            v.load_params = lambda: jp
            _jit_renders(v)
        else:
            v = tvis.Visualizer(cfg, device="cpu")
            v.model.load_state_dict(tm.state_dict())
            v.load_params = lambda: v.model
            inst = jm.netInstance
            key = inst.apply({"params": jp["netInstance"]},
                             method=lambda m: m.make_rng("vae"),
                             rngs={"vae": jax.random.PRNGKey(2)})
            vae = tm.cfg_motion_vae
            v.noise["reconstruct"] = Noise(vae_normal=torch.from_numpy(
                np.array(jax.random.normal(
                    key, (vae.z_token_num, 1, vae.latent_dim)))))
        v.run()
    files = sorted(os.listdir(outs["port"]))
    assert files == sorted(os.listdir(outs["jax"]))
    assert sum("_animation_" in f for f in files) == 6
    _frames_agree(tframes, jframes)
