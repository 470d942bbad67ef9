"""The benchmark's Ponymation stage-2 cell (`ponymation.stage2`, the
`pony_train` entry) on the CPU at a tiny size: the port's step equals the
benchmark's plain reference (`benchmark/refmodel`'s Ponymation) from the
same seeded weights and draws, reading 0 on every compared number; the
planted faults and the float8 control fail the cell's check; the
reference imports neither the port nor JAX; and the port's Ponymation
spans record once a step, in Ponymation alone, where the cell's readers
find them."""
import importlib.util
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)


def _load(name, path):
    """The benchmark's module at `path` under a name of its own (its
    `run.py` and `tests/tiny.py` would take generic names)."""
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


bench_run = _load("bench_run", os.path.join(BENCH, "run.py"))
tiny = _load("bench_tiny", os.path.join(BENCH, "tests", "tiny.py"))

from harness import faults_pony, spec  # noqa: E402
from harness.entries import pony_train  # noqa: E402

from animals3d_tpu_torch import tracing, trainer  # noqa: E402
from animals3d_tpu_torch.precision import set_mixed_precision  # noqa: E402

SEED = 2 ** 31 + 11
PONY = ["dataset.num_frames=2",
        "model.cfg_predictor_instance.cfg_motion_vae.latent_dim=32",
        "+model.cfg_predictor_instance.cfg_motion_vae"
        ".transformer_layer_num=1"]
SPANS = ["a3d.encoder", "a3d.deform", "a3d.teacher", "a3d.vae",
         "a3d.skinning"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
    set_mixed_precision(None)


@pytest.fixture(scope="module")
def cell():
    """The cell at the tiny size: `tiny`'s overrides with netSDF at its
    256 width (the fused sweep's path), two frames a sequence and a
    one-layer VAE of width 32."""
    return tiny.cell("ponymation.stage2", extra=tiny.SWEEP + PONY)


@pytest.fixture(scope="module")
def tiny_model(cell):
    """One tiny port Ponymation with the benchmark's weights, its
    optimizer and one batch of the cell's traffic."""
    from harness import sides, traffic
    side = sides.program()
    name = cell.config["port_configs"]["train"]
    ov = cell.workload["overrides"]
    cfg = side.load_config(name, ov)
    side.set_precision(cfg)
    model = side.build(cfg, "cpu")
    model.load_state_dict(pony_train.make_weights(
        pony_train.reference_side().load_config(name, ov), 3, "cpu"))
    batch = traffic.pool(1, 2, model.in_image_size, model.num_frames,
                         model.dino_feature_dim, 4, "cpu")[0]
    return model, trainer.make_optimizer(model), batch


def _run(cell, side=None):
    return bench_run.run_cell(cell, SEED, 0.3, False, device="cpu",
                              side=side)


def test_port_equals_reference(cell):
    torch.backends.cuda.matmul.allow_tf32 = True
    out = _run(cell)
    assert out["correct"]
    assert set(out["checks"]) == set(cell.limits)
    assert all(c["value"] == 0.0 for c in out["checks"].values()), \
        out["checks"]
    # the first gradient and the change reach the VAE alone
    assert set(out["detail"]["modules"]) == {"netInstance.netVAE"}
    assert out["detail"]["grad"]["median"] == 0.0
    assert out["metrics"]["train_imgs_per_s"]["value"] > 0
    # the check runs the reference with TF32 off
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("what", ["klddropped", "epszero", "skinhalf",
                                  "unchanged", "halfbatch", "control"])
def test_fault_is_not_correct(cell, what):
    out = _run(cell, faults_pony.side_of(what))
    assert out["correct"] is False, out["checks"]


def test_reference_imports_neither_the_port_nor_jax():
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "from harness.entries import pony_train;"
        "import refmodel.models.ponymation;"
        "ref = pony_train.reference_side();"
        "cfg = ref.load_config('train_ponymation_horse_stage2', sys.argv[2:]);"
        "m = ref.build(cfg, 'cpu');"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "{'animals3d_tpu', 'animals3d_tpu_torch', 'jax', 'jaxlib', 'flax'});"
        "assert not bad, bad; print(type(m).__module__)")
    res = subprocess.run(
        [sys.executable, "-c", code, BENCH, *tiny.TINY, *PONY],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ["refmodel.models.ponymation"]


def _step_snapshot(model, opt, batch, it):
    tracing.enable()
    try:
        trainer.train_step(model, opt, batch, it,
                           torch.Generator().manual_seed(5),
                           model.phase_for_iter(it))
    finally:
        tracing.disable()
    return tracing.snapshot()


def test_spans_and_counters_record_once_a_step(tiny_model):
    model, opt, batch = tiny_model
    snap = _step_snapshot(model, opt, batch, 100000)
    spans = snap["spans"]
    for name in SPANS:
        assert spans[name]["calls"] == 1, name
    assert not [c for c in snap["counters"]
                if c.split(".")[0] in ("deform", "vae")]
    # each reader of the cell finds its span, rooted at the step
    ctx = {"entry": pony_train.ENTRY, "program_trace": snap}
    for name in SPANS + ["a3d.backward", "a3d.adam"]:
        metric = name[len("a3d."):] + "_stream_ms.pony"
        assert spec.metric_reader(metric)(ctx) is None   # no CUDA events
        assert pony_train.span_ms(ctx, name, "host_ms") == \
            pytest.approx(spans[name]["host_ms"])
        assert spec.metric_reader(metric)(
            {"entry": "train", "program_trace": snap}) is None


def test_deform_chunks_of_whole_frames(tiny_model, monkeypatch):
    """netDeform in chunks of whole frames gives each row the value of
    one call over all of them, in as many calls as chunks."""
    from animals3d_tpu_torch.predictors import motion_vae
    model, _opt, _batch = tiny_model
    net = model.netInstance
    V, N = 40, 5
    verts = torch.rand((N, V, 3)) - 0.5
    feat = torch.rand((N, net.cfg.cfg_encoder.cout))
    rows = []
    hook = net.netDeform.register_forward_hook(
        lambda _m, args, _out: rows.append(args[0].shape[:2]))
    try:
        with torch.no_grad():
            whole = net._deform_offsets(verts, feat)
            monkeypatch.setattr(motion_vae, "DEFORM_ROWS", 2 * V)
            chunked = net._deform_offsets(verts, feat)
    finally:
        hook.remove()
    torch.testing.assert_close(chunked, whole)
    assert rows == [(N, V), (2, V), (2, V), (1, V)]


def test_magicpony_step_records_none_of_them():
    from animals3d_tpu_torch import config as tcfg
    from animals3d_tpu_torch.models import build_model
    from harness import traffic
    set_mixed_precision(None)
    cfg = tcfg.load_config("train_magicpony_horse",
                           overrides=tiny.TINY + tiny.NARROW)
    cfg["model"]["dataset"] = cfg["dataset"]
    model = build_model(cfg["model"], device="cpu")
    model.init_params(0)
    batch = traffic.pool(1, 2, model.in_image_size, model.num_frames,
                         model.dino_feature_dim, 4, "cpu")[0]
    snap = _step_snapshot(model, trainer.make_optimizer(model), batch,
                          50000)
    assert "a3d.train_step" in snap["spans"]
    assert not set(SPANS) & set(snap["spans"])
