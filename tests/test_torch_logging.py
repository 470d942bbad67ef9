"""The port trainer's logging: the visuals and turntable videos written to
tensorboard events every `log_image_freq` iterations (the port's version of
`tests/test_trainer.py::test_logging_path_writes_tensorboard_events`), the
port's `visual_log` against the JAX package's numpy module on the same
eval forward, the turntables each trainer composes against JAX's from the
same weights, the wandb writer without `wandb`, and the code archive."""
import os
import struct
import zipfile

import numpy as np
import pytest
import torch

import jax

from animals3d_tpu import config as jcfg
from animals3d_tpu.models import build_model as jbuild
from animals3d_tpu.trainer import Trainer as JTrainer
from animals3d_tpu.utils import visual_log as jvl
from animals3d_tpu_torch import run as trun
from animals3d_tpu_torch.convert_jax import load_jax_params
from animals3d_tpu_torch.data.synth import write_synth_dataset
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.utils import visual_log as tvl
from animals3d_tpu_torch.utils.wandb_writer import WandbWriter
from test_animal_model import TINY_OVERRIDES
from test_torch_visualization import FRAME_FLIP_SHARE, FRAME_TOL, \
    _frames_agree
from torch_parity import numpy_tree


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


ARTI_ON = ("model.cfg_predictor_instance.cfg_articulation."
           "articulation_iter_range=[0, inf]")


@pytest.fixture(autouse=True)
def _float32_policy():
    yield
    set_mixed_precision(None)


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    write_synth_dataset(str(d / "train"), n=4, size=64, dino_dim=4)
    write_synth_dataset(str(d / "val"), n=2, size=64, dino_dim=4, seed=1)
    return d


def _args(synth_dir, ckpt_dir, extra=()):
    return ["--config-name", "train_magicpony_horse", "--device", "cpu",
            *TINY_OVERRIDES, f"dataset.train_data_dir={synth_dir}/train",
            f"dataset.val_data_dir={synth_dir}/val",
            f"checkpoint_dir={ckpt_dir}", "dataset.num_workers=1",
            "num_iters=2", "save_checkpoint_freq=2", "log_loss_freq=1",
            ARTI_ON, *extra]


def _event_tags(logdir):
    """{tag: kinds} of every summary value in the tensorboard event files
    of `logdir` (TFRecord framing: length, its crc, the record, its crc)."""
    from tensorboardX.proto import event_pb2
    tags = {}
    for name in os.listdir(logdir):
        if "tfevents" not in name:
            continue
        with open(os.path.join(logdir, name), "rb") as f:
            data = f.read()
        pos = 0
        while pos < len(data):
            n, = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event()
            ev.ParseFromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                tags.setdefault(v.tag, set()).add(v.WhichOneof("value"))
    return tags


def test_logging_path_writes_tensorboard_events(synth_dir, tmp_path):
    """use_logger=true through the port's CLI with articulation on: two
    iterations with the visuals at iteration 2 on the training batch and
    a validation batch (images, masks, DINO features, histograms, geometry
    normals with the bones, albedo and shading) and the three turntables
    (filmstrip images without moviepy), all in the event files; a failure
    there raises (the JAX trainer prints and goes on). `archive_code`
    writes code.zip."""
    ckpt_dir = str(tmp_path / "ckpt")
    trainer = trun.main(_args(synth_dir, ckpt_dir, [
        "use_logger=true", "log_image_freq=2", "log_train=true",
        "log_val=true", "archive_code=true"]))
    assert trainer.start_iter == 0
    logdir = os.path.join(ckpt_dir, "logs")
    tags = _event_tags(logdir)
    for prefix in ("train_", "val_"):
        for name in ("image_gt", "image_pred", "mask_gt", "mask_pred",
                     "dino_feat_im_gt", "dino_feat_im_pred",
                     "instance_geo_normal", "albedo", "shading"):
            assert tags.get(prefix + "image/" + name) == {"image"}, name
        for name in ("instance_normal_rotation", "prior_image_rotation",
                     "prior_normal_rotation"):
            assert tags.get(prefix + "animation/" + name) == {"image"}, name
        for name in ("arti_params", "sdf", "coordinates", "light/dir_x",
                     "pose/rot_prob_0"):
            assert tags.get(prefix + name) == {"histo"}, name
    assert tags.get("train_loss/loss") == {"simple_value"}
    assert os.path.isfile(os.path.join(ckpt_dir, "code.zip"))


class _Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.calls = []

    def _add(self, kind, tag, value, step, **kw):
        self.calls.append((kind, tag, np.array(value), step))

    def add_image(self, tag, img, step=None):
        self._add("image", tag, img, step)

    def add_histogram(self, tag, values, step=None):
        self._add("histo", tag, values, step)

    def add_video(self, tag, frames, step=None, fps=10):
        self._add("video", tag, frames, step)


def test_visual_log_matches_jax(synth_dir, tmp_path):
    """The port's `log_visuals` and `log_videos` against the JAX package's
    numpy module on the same eval forward's aux, extra renders and
    turntables (handed to JAX as numpy, bf16 values as float32, as the
    port logs them): the same calls, tags and arrays, bit for bit."""
    from types import SimpleNamespace
    from animals3d_tpu_torch.data.loaders import get_data_loaders
    _cfg, model, trainer = trun.build(_args(synth_dir, str(tmp_path / "c")))
    model.init_params(0)
    batch = next(iter(get_data_loaders(trainer.cfg_dataset)[0]))
    got, want = _Recorder(), _Recorder()
    calls = []
    real = tvl.log_visuals

    def spy(model_, writer, batch_, aux, extra, it, prefix="train_"):
        calls.append((aux, extra))
        return real(model_, writer, batch_, aux, extra, it, prefix=prefix)
    tvl.log_visuals = spy
    try:
        trainer._log_visuals(got, batch, 2)
    finally:
        tvl.log_visuals = real
    (aux, extra), = calls
    np_aux = {k: (tvl._np(v) if torch.is_tensor(v) else v)
              for k, v in aux.items()}
    np_aux["shape"] = SimpleNamespace(v_pos=tvl._np(aux["shape"].v_pos))
    np_extra = {k: tvl._np(v) for k, v in extra.items()}
    jvl.log_visuals(model, want, batch, np_aux, np_extra, 2)
    vids = trainer._turntable_videos(aux)
    assert {len(v) for v in vids.values()} == {15}
    jvl.log_videos(want, vids, 2)
    assert [c[:2] for c in got.calls] == [c[:2] for c in want.calls]
    assert len(got.calls) >= 25
    for g, w in zip(got.calls, want.calls):
        np.testing.assert_array_equal(g[2], w[2], err_msg=g[1])


def _spy_turntables(trainer, out):
    """Keep what `trainer._turntable_videos` returns in `out`."""
    real = trainer._turntable_videos

    def spy(*args, **kw):
        out.append(real(*args, **kw))
        return out[-1]
    trainer._turntable_videos = spy


def test_turntables_match_jax(synth_dir, tmp_path):
    """Both trainers' `_log_visuals` on one training batch at the eval
    phase of iteration 2 (articulation on, float32), from the JAX init weights
    carried over with `convert_jax`: the 3 × 15 turntable frames that each
    composes (the first posed shape's geometry normals, the prior shaded
    and its normals, the first image's light and features, the orbit
    cameras around its camera) within `FRAME_TOL` of JAX's but at most
    `FRAME_FLIP_SHARE` of a frame's pixels (the Visualizer test's limits:
    pixels whose face flips on float32 rounding). The posed shape's frames
    differ from the prior's, so a swapped mesh shows."""
    from animals3d_tpu_torch.data.loaders import get_data_loaders
    args = _args(synth_dir, str(tmp_path / "c"), ["mixed_precision=false"])
    overrides = args[4:]                 # after the config name and device
    cfg = jcfg.load_config("train_magicpony_horse", overrides=overrides)
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    jm.grid_for_phase(jm.phase_for_iter(2))
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    jtrainer = JTrainer(cfg, jm)
    _cfg, model, trainer = trun.build(args)
    load_jax_params(model, numpy_tree(jp))
    batch = next(iter(get_data_loaders(trainer.cfg_dataset)[0]))
    jvids, tvids = [], []
    _spy_turntables(jtrainer, jvids)
    _spy_turntables(trainer, tvids)
    jtrainer._log_visuals(_Recorder(), jp, batch, 2)
    trainer._log_visuals(_Recorder(), batch, 2)
    (jv,), (tv,) = jvids, tvids      # JAX's failure only prints: none kept
    assert sorted(tv) == sorted(jv) == [
        "instance_normal_rotation", "prior_image_rotation",
        "prior_normal_rotation"]
    got = {f"{k}_{i}": np.asarray(f, np.float32)
           for k, v in tv.items() for i, f in enumerate(v)}
    want = {f"{k}_{i}": np.asarray(f, np.float32)
            for k, v in jv.items() for i, f in enumerate(v)}
    assert len(want) == 45 and want["prior_image_rotation_0"].shape == \
        (3, 64, 64)
    off, total = _frames_agree(got, want)
    posed = np.stack(jv["instance_normal_rotation"])
    prior = np.stack(jv["prior_normal_rotation"])
    moved = (np.abs(posed - prior) > FRAME_TOL).any(1).mean()
    assert moved > 10 * FRAME_FLIP_SHARE, moved
    print(f"turntables: {off} of {total} pixels beyond {FRAME_TOL}; the "
          f"posed shape's normals off the prior's at {moved:.3f} of pixels")


def test_wandb_writer_without_wandb(synth_dir, tmp_path):
    """Without the wandb package `WandbWriter` makes no run and every call
    is a no-op; `logger_type: wandb` gives the trainer one."""
    with pytest.raises(ImportError):
        import wandb  # noqa: F401
    w = WandbWriter(config={"a": 1})
    assert w._wandb is None and w._run is None
    w.add_scalar("s", 1.0, 0)
    w.add_image("i", np.zeros((3, 4, 4)), 0)
    w.add_video("v", np.zeros((1, 2, 3, 4, 4)), 0)
    w.add_histogram("h", np.arange(5), 0)
    w.flush()
    w.close()
    _cfg, _m, trainer = trun.build(_args(synth_dir, str(tmp_path / "c"), [
        "use_logger=true", "logger_type=wandb"]))
    assert isinstance(trainer._logger(), WandbWriter)


def test_archive_code_lists_the_port(synth_dir, tmp_path):
    """`_archive_code` zips every `.py` and `.yaml` of the port's package,
    and nothing of the JAX package."""
    import animals3d_tpu_torch
    _cfg, _m, trainer = trun.build(_args(synth_dir, str(tmp_path / "c")))
    with zipfile.ZipFile(trainer._archive_code()) as zf:
        names = set(zf.namelist())
    pkg = os.path.dirname(animals3d_tpu_torch.__file__)
    want = set()
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if fn.endswith((".py", ".yaml")):
                want.add(os.path.relpath(os.path.join(root, fn),
                                         os.path.dirname(pkg)))
    assert names == want
    assert "animals3d_tpu_torch/visualization.py" in names
    assert "animals3d_tpu_torch/configs/test_fauna.yaml" in names
    assert not any(n.startswith("animals3d_tpu/") for n in names)
