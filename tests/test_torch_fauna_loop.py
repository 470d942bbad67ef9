"""The port's Fauna loop, data, conversion and recon against the JAX
package, on the CPU at `tests/test_fauna.py`'s `TINY_FAUNA` widths.

  * `FaunaDataset`: the same samples, category labels (the 9th box
    column) and order as JAX's, bit for bit, through the loaders' index
    stream: single-category blocks with cyclic padding, back-view
    oversampling, `dataset_split_num` pseudo-categories and the per-epoch
    reshuffle;
  * the loop: `Trainer.train` over a synthetic category tree (2
    categories, 64²) for 2 iterations inside the discriminator window
    (`enable_iter` opened to iteration 0, so that the JAX `Trainer`, which
    starts at 0, runs the same phase), float32; the first loss against the
    JAX `Trainer`'s from the same init with its draws imposed, within
    `tests/test_torch_trainer.py`'s step-1 limit (`LOSS_RTOL[0]`); the
    checkpoint holds `netDisc` and the `disc` Adam's state; a resume
    restores `netDisc` bit for bit and starts the `disc` Adam afresh, as
    the JAX trainer does; the curriculum re-split at
    `remake_dataloader_iter`;
  * a reference-layout Fauna `.pth` (netBase with the modulated SDF and
    the bank, netDisc) through `convert.py` to the same parameters as
    through the JAX `convert.py`;
  * `reconstruct` through the bank against the JAX package's bank-threaded
    eval forward (`visualization.py`'s `Visualizer.reconstruct`, then
    `render(["shaded"])`).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu import config as jcfg
from animals3d_tpu import convert as jconvert
from animals3d_tpu import native as jnative
from animals3d_tpu.data import loaders as jloaders
from animals3d_tpu.data.synth import write_synth_dataset
from animals3d_tpu.models import build_model as jbuild
from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu.trainer import Trainer as JTrainer
from animals3d_tpu_torch import checkpoint as tckpt
from animals3d_tpu_torch import convert as tconvert
from animals3d_tpu_torch import native as tnative
from animals3d_tpu_torch import run as trun
from animals3d_tpu_torch.convert_jax import export_jax_params, load_jax_params
from animals3d_tpu_torch.data import loaders as tloaders
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points as txfm
from test_fauna import TINY_FAUNA
from test_torch_trainer import LOSS_RTOL
from torch_parity import (assert_images_close, build_pair, flat_tree,
                          jax_noise, numpy_tree)

H = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads, as `tests/test_torch_trainer.py` (no key search
    here: the loop's keys are the trainer's own)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(root, cats=(("bear", 5), ("cow", 3)), back=None, size=32):
    """A category tree under `root`: `large_scale/<cat>` folders of
    `write_synth_dataset` images, and `few_shot_x_back/<cat>` back views
    for the categories of `back`."""
    for i, (cat, n) in enumerate(cats):
        write_synth_dataset(str(root / "large_scale" / cat), n=n, size=size,
                            dino_dim=4, seed=i)
    for i, (cat, n) in enumerate(back or ()):
        write_synth_dataset(str(root / "few_shot_x" / cat), n=10, size=size,
                            dino_dim=4, seed=20 + i)
        write_synth_dataset(str(root / "few_shot_x_back" / cat), n=n,
                            size=size, dino_dim=4, seed=30 + i)
    return str(root)


def _stream(mod, root, n_batches, **cfg):
    """The first `n_batches` of the train loader's stream."""
    c = mod.DataLoaderConfig(data_type="fauna", batch_size=2, num_workers=2,
                             in_image_size=32, out_image_size=32,
                             train_data_dir=root, load_dino_feature=True,
                             dino_feature_dim=4, **cfg)
    train = mod.get_data_loaders(c)[0]
    it = iter(train)
    return train.dataset, [next(it) for _ in range(n_batches)]


@pytest.mark.parametrize("case", ["blocks", "back_views", "split",
                                  "epochs"])
def test_fauna_dataset_matches_jax(tmp_path, case):
    """Samples, labels and order bit for bit: `blocks` (3 categories of 5,
    3 and 4 images padded cyclically to 6: every batch one category),
    `back_views` (a `few_shot_*_back` tree oversampled to (n // 5) · 4 and
    prepended), `split` (`dataset_split_num` 2: pseudo-categories of at
    most 2)
    and `epochs` (three epochs of the stream: `set_epoch` reshuffles
    within each category)."""
    # load both native libraries before the loaders' threads call them: a
    # thread that finds one still loading takes the cv2 transform, whose
    # float32 rounding differs from the native one's
    jnative.get_lib()
    tnative.get_lib()
    cats = (("bear", 5), ("cow", 3), ("horse", 4))
    kw, n = {}, 6
    if case == "back_views":
        root = _tree(tmp_path, cats=(("bear", 5),), back=(("panda", 3),))
    else:
        root = _tree(tmp_path, cats=cats)
    if case == "split":
        kw = dict(dataset_split_num=2)
    if case == "epochs":
        n = 27
    jds, jb = _stream(jloaders, root, n, **kw)
    tds, tb = _stream(tloaders, root, n, **kw)
    assert tds.all_category_names == jds.all_category_names
    assert len(tds) == len(jds)
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        labels = b["bboxs"][:, 0, 8]
        assert b["bboxs"].shape[-1] == 9 and len(set(labels)) == 1
        np.testing.assert_array_equal(b["seq_idx"], labels.astype(np.int32))
    if case == "back_views":
        stems = tds.categories["panda"]
        assert len(stems) == 10 + (10 // 5) * 4
        assert all("_back" in s for s in stems[:8])
    if case == "split":
        assert len(tds.all_category_names) == 3 + 2 + 2   # 5, 3, 4 by 2
    if case == "epochs":
        epochs = [tds._epoch, jds._epoch]
        assert epochs[0] == epochs[1] >= 2


@pytest.fixture(scope="module")
def fauna_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fauna")
    return _tree(root, cats=(("bear", 3), ("cow", 2)), size=H)


LOOP = TINY_FAUNA + [
    "model.cfg_mask_discriminator.enable_iter=[-1,300000]",
    "dataset.random_xflip_train=false", "dataset.num_workers=2",
    "log_loss_freq=1", "use_logger=false", "mixed_precision=false"]


def test_first_loss_matches_the_jax_trainer(fauna_tree, tmp_path):
    """Both packages' `Trainer.train` over the same category tree for one
    iteration inside the discriminator window, float32, the port from
    JAX's init with the JAX trainer's draws imposed (the random view's
    azimuth included): the loss within `LOSS_RTOL[0]` (5.2e-6 seen), the
    discriminator step's loss within 1e-3 (5.6e-4 seen: its input, the
    recorded masks, carries the silhouettes' float32 ties on the trainer's
    own key; the generator's `mask_disc_loss` reads 1.5e-3), and the terms
    that no silhouette pixel enters within 1e-5."""
    extra = LOOP + [f"dataset.train_data_dir={fauna_tree}",
                    "dataset.val_data_dir=null", "dataset.test_data_dir=null",
                    "num_iters=1", "save_checkpoint_freq=100"]
    cfg = jcfg.load_config("train_fauna", overrides=extra + [
        f"checkpoint_dir={tmp_path / 'jax'}"])
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    init = {}
    real_init = jm.init_params

    def init_params(rng):
        params = real_init(rng)
        init["tree"] = jax.tree_util.tree_map(
            lambda x: np.array(x, copy=True), params)
        return params
    jm.init_params = init_params
    JTrainer(cfg, jm).train()
    with open(tmp_path / "jax" / "metrics.json") as f:
        jtrace = json.load(f)["train"]

    rng = jax.random.PRNGKey(0)
    rng, _init_rng = jax.random.split(rng)
    _rng, step_rng = jax.random.split(rng)
    _c, tm, trainer = trun.build(
        ["--config-name", "train_fauna", "--device", "cpu", *extra,
         f"checkpoint_dir={tmp_path / 'port'}"])
    tm.init_params = lambda seed: load_jax_params(tm, init["tree"])
    real_forward = tm.forward
    K = tm.netInstance.num_pose_hypos

    def forward(batch, total_iter, gen=None, phase=None, grid=None,
                noise=None):
        n = batch["images"].shape[0] * batch["images"].shape[1]
        g, v_cap, f_cap = tm.grid_for_phase(phase)
        with torch.no_grad():
            prior, _sdf, *_ = tm.forward_base(
                g, v_cap, f_cap, jitter=jax_noise(step_rng, n, K).jitter_u,
                batch=batch)
        return real_forward(batch, total_iter, gen, phase, grid,
                            noise=jax_noise(step_rng, n, K,
                                            int(prior.num_verts)))
    tm.forward = forward
    trainer.train()
    with open(tmp_path / "port" / "metrics.json") as f:
        ttrace = json.load(f)["train"]
    assert trainer.model.phase_for_iter(0).disc_on
    for name in ("rgb_loss", "dino_feat_im_loss", "sdf_bce_reg_loss",
                 "sdf_gradient_reg_loss"):
        np.testing.assert_allclose(ttrace[0][name], jtrace[0][name],
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(ttrace[0]["discriminator_loss"],
                               jtrace[0]["discriminator_loss"], rtol=1e-3)
    print("relative gaps: " + ", ".join(
        f"{k} {abs(ttrace[0][k] - jtrace[0][k]) / abs(jtrace[0][k]):.3g}"
        for k in ("loss", "discriminator_loss", "mask_disc_loss")))
    np.testing.assert_allclose(ttrace[0]["loss"], jtrace[0]["loss"],
                               rtol=LOSS_RTOL[0])


def _args(tree, ckpt_dir, extra=()):
    return ["--config-name", "train_fauna", "--device", "cpu", *LOOP,
            f"dataset.train_data_dir={tree}", "dataset.val_data_dir=null",
            "dataset.test_data_dir=null", f"checkpoint_dir={ckpt_dir}",
            "num_iters=2", "save_checkpoint_freq=2", *extra]


def test_loop_checkpoint_and_resume_carry_the_discriminator(fauna_tree,
                                                           tmp_path):
    """Two iterations inside the discriminator window: each logs a finite
    `discriminator_loss`; the checkpoint at 2 holds `netDisc` and the
    `disc` Adam's state (two steps taken); a resume to 3 restores the
    model, netDisc included, and the generator optimizers' state bit for
    bit, starts the `disc` Adam afresh, as the JAX trainer does, and
    takes one more step."""
    out = tmp_path / "ckpt"
    _c, tm, trainer = trun.build(_args(fauna_tree, out))
    trainer.train()
    log = trainer.metrics_trace.data["train"]
    assert len(log) == 2 and all(
        np.isfinite(m["discriminator_loss"]) and "mask_disc_loss" in m
        for m in log)
    saved = tckpt.read_checkpoint(str(out / "checkpoint0000002.pth"))
    assert any(k.startswith("netDisc.") for k in saved["model"])
    disc = saved["optimizer"]["disc"]
    assert len(disc["state"]) == len(list(tm.netDisc.parameters()))
    assert all(float(s["step"]) == 2 for s in disc["state"].values())

    _c, tm2, tr2 = trun.build(_args(fauna_tree, out, ["num_iters=3"]))
    opt, start = tr2.restore()
    assert start == 2
    for k, v in saved["model"].items():
        assert torch.equal(tm2.state_dict()[k], v), k
    got = opt.state_dict()["optimizer"]
    for name, sd in saved["optimizer"].items():
        if name == "disc":
            assert not got[name]["state"]
            continue
        for i, st in sd["state"].items():
            for k, v in st.items():
                assert torch.equal(got[name]["state"][i][k], v), (name, i, k)
    tr2.train()
    assert tr2.start_iter == 2 and os.path.isfile(
        str(out / "checkpoint0000003.pth"))
    again = tckpt.read_checkpoint(str(out / "checkpoint0000003.pth"))
    assert all(float(s["step"]) == 1
               for s in again["optimizer"]["disc"]["state"].values())


def test_curriculum_resplit_at_remake_dataloader_iter(fauna_tree, tmp_path):
    """At `remake_dataloader_iter` the loop rebuilds its loaders with
    `dataset_split_num = remake_dataloader_num`: from then on it draws
    from pseudo-categories of that size (bear_0, bear_1, cow_0)."""
    seen = []
    real = tloaders.get_data_loaders

    def loaders(cfg, **hosts):
        out = real(cfg, **hosts)
        seen.append((cfg.dataset_split_num,
                     list(out[0].dataset.all_category_names)))
        return out
    from animals3d_tpu_torch import trainer as ttrainer
    ttrainer.get_data_loaders = loaders
    try:
        _c, _tm, trainer = trun.build(_args(
            fauna_tree, tmp_path / "ckpt",
            ["remake_dataloader_iter=1", "remake_dataloader_num=2"]))
        trainer.train()
    finally:
        ttrainer.get_data_loaders = real
    assert seen == [(-1, ["bear", "cow"]), (2, ["bear_0", "bear_1", "cow_0"])]
    assert trainer.cfg_dataset.dataset_split_num == 2


def _reference_fauna_sd(tm, rng):
    """A reference checkpoint's netBase (modulated SDF, DINO field, bank)
    and netDisc in the reference's key names and layouts, with random
    values of the port model's shapes."""
    tree = export_jax_params(tm)
    base, sd = tree["netBase"], {}
    sdf = base["netSDF"]
    sd["netShape.mlp.in_layer.weight"] = sdf["in_layer"]["kernel"].T
    sd["netShape.mlp.in_layer.bias"] = sdf["in_layer"]["bias"]
    for i in range(2):
        sd[f"netShape.mlp.style_mlp.network.{2 * i}.weight"] = \
            sdf["style_mlp"][f"layer_{i}"]["kernel"].T
    for i in range(len(sdf["mlp"])):
        sd[f"netShape.mlp.mlp.linear_{i}.weight"] = \
            sdf["mlp"][f"linear_{i}"]["weight"].T
    dino = base["netDINO"]
    sd["netDINO.in_layer.weight"] = dino["in_layer"]["kernel"].T
    sd["netDINO.in_layer.bias"] = dino["in_layer"]["bias"]
    for i in range(len(dino["mlp"])):
        sd[f"netDINO.mlp.network.{2 * i}.weight"] = \
            dino["mlp"][f"layer_{i}"]["kernel"].T
    sd["memory_bank"] = base["memory_bank"]
    sd["memory_bank_keys"] = base["memory_bank_keys"]
    disc = {}
    n = tm.netDisc.n_layers
    for i in range(n):
        disc[f"blocks.{i}.weight"] = tree["netDisc"][f"conv_{i}"]["kernel"] \
            .transpose(3, 2, 0, 1)
    disc["conv_out.weight"] = tree["netDisc"]["conv_out"]["kernel"] \
        .transpose(3, 2, 0, 1)
    rand = lambda d: {k: torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                          .astype(np.float32))
                      for k, v in d.items()}
    return {"netBase": rand(sd), "netDisc": rand(disc)}


def test_reference_pth_converts_as_in_jax(tmp_path):
    """A reference-layout Fauna `.pth` (netBase and netDisc) through the
    port's `convert.convert_checkpoint` and `load_jax_params` gives the
    arrays of the JAX `convert.py` (its `convert_discriminator` at this
    size's 4 layers: its checkpoint reader assumes 256², 6 layers), bit
    for bit; `netInstance` keeps its init."""
    set_mixed_precision(None)
    cfg = jcfg.load_config("train_fauna", overrides=TINY_FAUNA)
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    tcfg = trun.build(["--config-name", "train_fauna", "--device", "cpu",
                       *TINY_FAUNA])
    tm = tcfg[1]
    tm.init_params(0)
    init = flat_tree(export_jax_params(tm))
    cp = _reference_fauna_sd(tm, np.random.default_rng(0))
    pth = str(tmp_path / "pretrained_fauna.pth")
    torch.save(cp, pth)
    load_jax_params(tm, tconvert.convert_checkpoint(pth, tm), strict=False)
    got = flat_tree(export_jax_params(tm))
    jcp = jconvert.load_torch_state_dict(pth)
    want = {"netBase": jconvert.convert_net_base(jcp["netBase"], jm),
            "netDisc": jconvert.convert_discriminator(
                jcp["netDisc"], n_layers=tm.netDisc.n_layers)}
    want = flat_tree(numpy_tree(want))
    # netSDF 2 + 2 + 2, netDINO 2 + 2, the bank 2, netDisc 4 + 1
    assert len(want) == 6 + 4 + 2 + 5
    for path, leaf in got.items():
        if path in want:
            np.testing.assert_array_equal(leaf, want[path], "/".join(path))
        else:
            assert path[0] == "netInstance", path
            np.testing.assert_array_equal(leaf, init[path], "/".join(path))


@pytest.fixture(scope="module")
def models():
    set_mixed_precision(None)
    return build_pair(TINY_FAUNA, "train_fauna", (0, 100000))


def test_reconstruct_through_the_bank_matches_jax(models):
    """The port's `reconstruct` at iteration 100,000's eval phase against
    the JAX package's bank-threaded eval forward (`Visualizer.reconstruct`:
    the class tokens query the bank, its batch mean conditions the prior,
    then the instance forward) rendered as `shaded`: the class vector at
    rtol 1e-5, cameras, articulation and light within 1e-4, the images
    under `tests/test_torch_recon.py`'s limits."""
    from animals3d_tpu.visualization import Visualizer
    jm, jp, tm = models
    it = 100000
    images = np.random.default_rng(7).uniform(
        0, 1, (2, 1, 3, H, H)).astype(np.float32)
    vis = Visualizer.__new__(Visualizer)
    vis.model = jm
    prior, cvec, out = vis.reconstruct(jp, jnp.asarray(images), it)
    shape, mvp = out[0], out[3]
    want = jm.render(jp, ["shaded"], shape, mvp, out[4], out[5], (H, H),
                     im_features=out[6], light_params=out[10],
                     prior_mesh=prior, num_frames=1,
                     class_vector=cvec)["shaded"]
    wrast = jrz.rasterize(jxfm(shape.v_pos, mvp), shape.t_pos_idx,
                          shape.f_valid, (H, H))
    shaded, tout = tm.reconstruct(tm, torch.from_numpy(images), it)
    phase = tm.phase_for_iter(it, is_training=False)
    grid, v_cap, f_cap = tm.grid_for_phase(phase)
    with torch.no_grad():
        _p, _s, tcvec, bank = tm.forward_base(
            grid, v_cap, f_cap, batch={"images": torch.from_numpy(images)})
    np.testing.assert_allclose(tcvec.numpy(), np.asarray(cvec), rtol=1e-5,
                               atol=1e-7)
    assert bank["bank_embedding"][2]["pick_idx"].shape == (2, 3)
    for name, i in (("mvp", 3), ("arti_params", 9), ("light_params", 10)):
        np.testing.assert_allclose(tout[i].numpy(), np.asarray(out[i]),
                                   atol=1e-4, rtol=0, err_msg=name)
    tshape = tout[0]
    with torch.no_grad():
        v_clip = txfm(tshape.v_pos, tout[3])
        rast = rc.rasterize_cuda(v_clip, tshape.t_pos_idx, tshape.f_valid,
                                 (H, H), v_pos0=tshape.v_pos[0])
    assert (rast.face_id.numpy() > 0).sum() > 100
    assert_images_close(shaded, want, rast, wrast, v_clip,
                        tshape.t_pos_idx, silhouette_atol=4e-3, z_atol=3e-3,
                        max_share=0.002)
