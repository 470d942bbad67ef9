"""The port's training loop, checkpoints, warm start, test path, results
writer and CLI (`animals3d_tpu_torch.run`), on the CPU at the tiny size of
`tests/test_trainer.py`, most of them against the JAX package.

Tolerances and why:
  * checkpoints, the scheduler's learning rate and the restored Adam state
    are exact (torch.save round trips are bit for bit);
  * the warm start is exact: the same converted arrays land on the same
    parameters;
  * `results_io` files are byte for byte JAX's for the same values;
  * the loop's losses against the JAX `Trainer`'s, from the same init and
    the same random draws. The loop's keys are the trainer's own, not
    keys picked for agreeing decisions as in `tests/test_torch_train.py`,
    so antialiased silhouette pixels may differ by float32 ties (a pixel
    by ~0.1): step 1's terms that no silhouette pixel enters (rgb, DINO
    features, the SDF regularizers) within rtol 1e-5 (7.3e-7 seen), its
    total within 1e-3 (2.8e-4 seen: the mask terms, through the logit
    loss); steps 2 and 3 within 1e-2 and 1e-1 (1.7e-3 and 3.6e-2 seen).
    Adam's first steps move every entry by ±lr whatever its gradient's
    size, so float32 differences grow by an order of magnitude a step
    (`ROADMAP.md`: at most ~8 steps).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from animals3d_tpu import config as jcfg
from animals3d_tpu import convert as jconvert
from animals3d_tpu.data.synth import write_synth_dataset
from animals3d_tpu.models import build_model as jbuild
from animals3d_tpu.trainer import Trainer as JTrainer
from animals3d_tpu.utils import results_io as jresults
from animals3d_tpu_torch import checkpoint as tckpt
from animals3d_tpu_torch import run as trun
from animals3d_tpu_torch.convert_jax import export_jax_params, load_jax_params
from animals3d_tpu_torch.geometry.mesh import make_mesh
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.utils import results_io as tresults
from test_animal_model import TINY_OVERRIDES
from torch_parity import flat_tree, jax_noise, numpy_tree

LOSS_RTOL = (1e-3, 1e-2, 1e-1)
# step 1's terms that no silhouette pixel enters
EXACT_TERMS = ("rgb_loss", "dino_feat_im_loss", "sdf_bce_reg_loss",
               "sdf_gradient_reg_loss")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two torch threads for this file: the suite runs six pytest workers
    on the machine's cores, and each torch default of one thread per core
    oversubscribes them many times over (the file then takes several
    times its lone run). The float32 results do not depend on the count
    beyond rounding, and every key here is picked at run time."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _float32_policy():
    """The port's Trainer sets its precision policy from the run config (a
    process global); leave it float32 for the next test."""
    yield
    set_mixed_precision(None)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    write_synth_dataset(str(d / "train"), n=4, size=64, dino_dim=4)
    write_synth_dataset(str(d / "test"), n=2, size=64, dino_dim=4)
    return d


def _args(synth_dir, ckpt_dir, extra=(), config="train_magicpony_horse"):
    return ["--config-name", config, "--device", "cpu", *TINY_OVERRIDES,
            f"dataset.train_data_dir={synth_dir}/train",
            f"dataset.val_data_dir={synth_dir}/test",
            f"dataset.test_data_dir={synth_dir}/test",
            f"checkpoint_dir={ckpt_dir}", "dataset.num_workers=2",
            "num_iters=3", "save_checkpoint_freq=2", "log_loss_freq=1",
            "use_logger=false", *extra]


def test_train_loop_and_resume(synth_dir, tmp_path):
    """`tests/test_trainer.py::test_train_loop_and_resume` through the
    port's CLI: three iterations write checkpoints, finite losses in
    metrics.json and eval artifacts in train_results/; a second run
    resumes at iteration 3 with the saved Adam state, bit for bit, and
    writes checkpoint 4."""
    ckpt_dir = str(tmp_path / "ckpt")
    trun.main(_args(synth_dir, ckpt_dir, ["save_train_result_freq=3"]))
    names = sorted(os.listdir(ckpt_dir))
    assert "checkpoint0000002.pth" in names and \
        "checkpoint0000003.pth" in names, names
    with open(os.path.join(ckpt_dir, "metrics.json")) as f:
        losses = [m["loss"] for m in json.load(f)["train"]]
    assert len(losses) == 3 and all(np.isfinite(l) for l in losses)
    train_res = os.path.join(ckpt_dir, "train_results")
    assert any(f.endswith("_mesh.obj") for f in os.listdir(train_res))

    saved = tckpt.read_checkpoint(os.path.join(ckpt_dir,
                                               "checkpoint0000003.pth"))
    assert saved["total_iter"] == 3
    _cfg, _model, trainer = trun.build(_args(synth_dir, ckpt_dir,
                                             ["num_iters=4"]))
    optimizer, start = trainer.restore()
    assert start == 3
    for name, opt in optimizer.optimizers.items():
        want = saved["optimizer"][name]["state"]
        got = opt.state_dict()["state"]
        assert set(got) == set(want) and len(got) >= 8
        for i, st in want.items():
            for k, v in st.items():
                assert torch.equal(got[i][k], v), (name, i, k)
        assert float(got[0]["step"]) == 3
    for k, v in saved["model"].items():
        assert torch.equal(_model.state_dict()[k], v), k

    trainer = trun.main(_args(synth_dir, ckpt_dir, ["num_iters=4"]))
    assert trainer.start_iter == 3
    names = sorted(os.listdir(ckpt_dir))
    assert "checkpoint0000004.pth" in names
    # keep_num_checkpoint=2: the oldest went
    assert "checkpoint0000002.pth" not in names, names


def test_test_path_writes_artifacts(synth_dir, tmp_path):
    """`tests/test_trainer.py::test_test_path_writes_artifacts` through the
    port's CLI: train one iteration, then the test config loads that
    checkpoint by name and writes mesh, image and pose files for every
    test image into test_results_<iter>."""
    ckpt_dir = str(tmp_path / "ckpt_t")
    trun.main(_args(synth_dir, ckpt_dir, ["num_iters=1"]))
    trainer = trun.main(_args(
        synth_dir, ckpt_dir, ["checkpoint_name=checkpoint0000001.pth",
                              "dataset.batch_size=2"],
        config="test_magicpony_horse"))
    result_dir = os.path.join(ckpt_dir, "test_results_0000001")
    files = os.listdir(result_dir)
    for suffix in ("_mesh.obj", "_image_pred.png", "_pose.txt",
                   "_input_image.png", "_mask_pred.png"):
        assert sum(f.endswith(suffix) for f in files) == 2, suffix
    assert trainer.cfg.run_test and not trainer.cfg.run_train


def _lr(trainer):
    return {k: [g["lr"] for g in o.param_groups]
            for k, o in trainer.optimizer.optimizers.items()}


def test_resume_across_a_scheduler_milestone(synth_dir, tmp_path):
    """MultiStepLR on (milestones 2 and 3, gamma 0.5): a run stopped at
    iteration 2, at the first milestone, and resumed to 4 ends with the
    learning rate, the scheduler state and Adam's step count of an
    unbroken 4-iteration run. Without the scheduler's state in the
    checkpoint the resumed schedule would restart at lr 1e-4."""
    sched = [f"+model.cfg_optim_{n}.{k}={v}" for n in ("base", "instance")
             for k, v in (("use_scheduler", "true"),
                          ("scheduler_milestone", "[2,3]"),
                          ("scheduler_gamma", "0.5"))]
    whole = trun.main(_args(synth_dir, str(tmp_path / "a"),
                            sched + ["num_iters=4", "save_checkpoint_freq=100"]))
    trun.main(_args(synth_dir, str(tmp_path / "b"), sched + ["num_iters=2"]))
    resumed = trun.main(_args(synth_dir, str(tmp_path / "b"),
                              sched + ["num_iters=4"]))
    assert resumed.start_iter == 2
    assert _lr(resumed) == _lr(whole) == {"base": [2.5e-5],
                                          "instance": [2.5e-5]}
    for name, s in whole.optimizer.schedulers.items():
        assert resumed.optimizer.schedulers[name].state_dict() == \
            s.state_dict()
    for name, o in whole.optimizer.optimizers.items():
        assert float(resumed.optimizer.optimizers[name]
                     .state_dict()["state"][0]["step"]) == \
            float(o.state_dict()["state"][0]["step"]) == 4


def _reference_netbase_sd(tree, rng):
    """A reference netBase state dict (the key names and layouts that
    `convert.convert_net_base` reads) with random values, for the shapes
    of the flax-layout netBase `tree`."""
    sd = {}
    for net, prefix in (("netSDF", "netShape.mlp"), ("netDINO", "netDINO")):
        t = tree[net]
        sd[f"{prefix}.in_layer.weight"] = t["in_layer"]["kernel"].T
        sd[f"{prefix}.in_layer.bias"] = t["in_layer"]["bias"]
        for i in range(len(t["mlp"])):
            sd[f"{prefix}.mlp.network.{2 * i}.weight"] = \
                t["mlp"][f"layer_{i}"]["kernel"].T
    return {k: torch.from_numpy(rng.normal(0, 0.1, v.shape)
                                .astype(np.float32)) for k, v in sd.items()}


def test_warm_start_from_a_reference_pth(synth_dir, tmp_path):
    """A `.pth` with only netBase under the reference's key names: the
    port's `_warm_start` gives the parameters of JAX's
    `convert.convert_checkpoint` carried over by `load_jax_params`,
    netInstance stays at its init, and training from it runs."""
    cfg = jcfg.load_config("train_magicpony_horse", overrides=TINY_OVERRIDES)
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    pth = str(tmp_path / "pretrained.pth")
    _c, tm, trainer = trun.build(_args(synth_dir, str(tmp_path / "ckpt"), [
        f"checkpoint_path={pth}", "num_iters=1", "save_checkpoint_freq=1"]))
    tm.init_params(0)
    init = flat_tree(export_jax_params(tm))
    torch.save({"netBase": _reference_netbase_sd(
        export_jax_params(tm)["netBase"], np.random.default_rng(0))}, pth)

    trainer._warm_start(pth)
    got = flat_tree(export_jax_params(tm))
    want = flat_tree(numpy_tree(jconvert.convert_checkpoint(pth, jm)))
    assert len(want) == 8
    for path, leaf in got.items():
        if path in want:
            np.testing.assert_array_equal(leaf, want[path], "/".join(path))
        else:
            assert path[0] == "netInstance", path
            np.testing.assert_array_equal(leaf, init[path], "/".join(path))
    tm.init_params(0)
    load_jax_params(tm, numpy_tree(jconvert.convert_checkpoint(pth, jm)),
                    strict=False)
    for path, leaf in flat_tree(export_jax_params(tm)).items():
        np.testing.assert_array_equal(leaf, got[path], "/".join(path))
    with pytest.raises(KeyError):
        load_jax_params(tm, numpy_tree(jconvert.convert_checkpoint(pth, jm)))

    trainer.train()           # warm start at iteration 0, one step
    assert trainer.start_iter == 0
    assert os.path.isfile(str(tmp_path / "ckpt" / "checkpoint0000001.pth"))


def test_warm_start_from_a_port_checkpoint_with_its_optimizer(synth_dir,
                                                              tmp_path):
    """`checkpoint_path` naming the port's own checkpoint: the model and,
    with `load_optim`, each Adam's state come from it."""
    src = str(tmp_path / "src")
    trun.main(_args(synth_dir, src, ["num_iters=2"]))
    path = os.path.join(src, "checkpoint0000002.pth")
    saved = tckpt.read_checkpoint(path)
    for load_optim, step in (("true", 2), ("false", None)):
        _c, tm, trainer = trun.build(_args(
            synth_dir, str(tmp_path / f"dst_{load_optim}"),
            [f"checkpoint_path={path}", f"load_optim={load_optim}"]))
        optimizer, start = trainer.restore()
        assert start == 0
        for k, v in saved["model"].items():
            assert torch.equal(tm.state_dict()[k], v), k
        st = optimizer.optimizers["base"].state_dict()["state"]
        assert (float(st[0]["step"]) if st else None) == step


def _results_aux(rng, B=2, H=16, V=12, Fc=10):
    faces = rng.integers(0, V, (Fc, 3)).astype(np.int64)
    v_valid = np.arange(V) < 9
    f_valid = (faces < 9).all(1)
    return {"mask_pred": rng.uniform(-0.1, 1.1, (B, 1, H, H)),
            "image_pred": rng.uniform(0, 1, (B, 1, 3, H, H)),
            "pose": rng.normal(0, 1, (B, 12)),
            "arti_params": rng.normal(0, 0.1, (B, 1, 20, 3)),
            "v_pos": rng.normal(0, 1, (B, V, 3)), "faces": faces,
            "v_valid": v_valid, "f_valid": f_valid}, {
        "images": rng.uniform(0, 1, (B, 1, 3, H, H)).astype(np.float32),
        "masks": (rng.uniform(0, 1, (B, 1, 1, H, H)) > 0.5)
        .astype(np.float32)}


def test_results_io_files_equal_jax(tmp_path):
    """The same values as numpy (JAX) and as tensors with a port `Mesh`
    (port): the same file names with the same bytes."""
    aux, batch = _results_aux(np.random.default_rng(0))
    f32 = lambda a: a.astype(np.float32)

    class Sh:
        v_pos, t_pos_idx = f32(aux["v_pos"]), aux["faces"]
        v_valid, f_valid = aux["v_valid"], aux["f_valid"]
    jaux = {k: f32(aux[k]) for k in ("mask_pred", "image_pred", "pose",
                                     "arti_params")}
    jaux["shape"] = Sh
    t = lambda a: torch.from_numpy(np.asarray(a))
    mesh = make_mesh(t(f32(aux["v_pos"])), t(aux["faces"]),
                     t(aux["v_valid"]), t(aux["f_valid"]),
                     torch.tensor(9), torch.tensor(int(aux["f_valid"].sum())))
    taux = {k: t(v) for k, v in jaux.items() if k != "shape"}
    taux["shape"] = mesh
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jresults.save_results(None, batch, jaux, str(jdir), start_index=5)
    tresults.save_results(None, {k: t(v) for k, v in batch.items()}, taux,
                          str(tdir), start_index=5)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 14
    for n in names:
        assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n


def test_first_three_losses_match_the_jax_trainer(synth_dir, tmp_path):
    """Both packages' `Trainer.train` over the same folder for three
    iterations, float32: the port from JAX's init parameters
    (`load_jax_params`) with the JAX trainer's draws imposed as a `Noise`
    (its key split per step, `torch_parity.jax_noise`). In metrics.json,
    step 1's `EXACT_TERMS` agree within 1e-5 and the losses within
    `LOSS_RTOL` per step (see the module docstring)."""
    extra = TINY_OVERRIDES + [
        f"dataset.train_data_dir={synth_dir}/train", "num_iters=3",
        "log_loss_freq=1", "use_logger=false", "save_checkpoint_freq=100",
        "mixed_precision=false", "dataset.num_workers=2"]
    cfg = jcfg.load_config("train_magicpony_horse", overrides=extra + [
        f"checkpoint_dir={tmp_path / 'jax'}"])
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    init = {}
    real_init = jm.init_params

    def init_params(rng):
        params = real_init(rng)
        # a copy: the JAX trainer's step donates its parameter buffers
        init["tree"] = jax.tree_util.tree_map(
            lambda x: np.array(x, copy=True), params)
        return params
    jm.init_params = init_params
    JTrainer(cfg, jm).train()
    with open(tmp_path / "jax" / "metrics.json") as f:
        jtrace = json.load(f)["train"]

    rng = jax.random.PRNGKey(0)
    rng, _init_rng = jax.random.split(rng)
    step_rngs = []
    for _ in range(3):
        rng, step_rng = jax.random.split(rng)
        step_rngs.append(step_rng)
    _c, tm, trainer = trun.build(
        ["--config-name", "train_magicpony_horse", "--device", "cpu",
         *extra, f"checkpoint_dir={tmp_path / 'port'}"])
    tm.init_params = lambda seed: load_jax_params(tm, init["tree"])
    real_forward = tm.forward
    K = tm.netInstance.num_pose_hypos

    def forward(batch, total_iter, gen=None, phase=None, grid=None,
                noise=None):
        r = step_rngs[total_iter]
        n = batch["images"].shape[0] * batch["images"].shape[1]
        g, v_cap, f_cap = tm.grid_for_phase(phase)
        with torch.no_grad():
            prior, _sdf, *_ = tm.forward_base(
                g, v_cap, f_cap, jitter=jax_noise(r, n, K).jitter_u)
        return real_forward(batch, total_iter, gen, phase, grid,
                            noise=jax_noise(r, n, K, int(prior.num_verts)))
    tm.forward = forward
    trainer.train()
    with open(tmp_path / "port" / "metrics.json") as f:
        ttrace = json.load(f)["train"]
    for name in EXACT_TERMS:
        np.testing.assert_allclose(ttrace[0][name], jtrace[0][name],
                                   rtol=1e-5, err_msg=name)
    jlosses = [m["loss"] for m in jtrace]
    tlosses = [m["loss"] for m in ttrace]
    rel = np.abs(np.array(tlosses) / np.array(jlosses) - 1)
    print(f"losses: port {tlosses}, JAX {jlosses}, relative {rel}")
    assert len(tlosses) == len(jlosses) == 3
    assert (rel <= LOSS_RTOL).all(), (tlosses, jlosses, rel)
