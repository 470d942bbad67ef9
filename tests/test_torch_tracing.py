"""The port's tracer (`animals3d_tpu_torch.tracing`) on the CPU: off it
records nothing and runs no tensor operation; on, a tiny training step and
reconstruction give the layer tree with self times that add up; a
`torch.profiler` session turns it on for its window alone, on the
profiler's clock; the counters match what marching tets and the antialias
pass compute; the raw ring stays bounded; the benchmark's readers of it
read a hand-made snapshot; the trainer's `trace_file` writes it; and the
speed meter counts every iteration's images."""
import gc
import json
import os
import sys
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch import run as trun
from animals3d_tpu_torch import tracing, trainer
from animals3d_tpu_torch.data.synth import write_synth_dataset
from animals3d_tpu_torch.geometry import tets as tetlib
from animals3d_tpu_torch.models import build_model
from animals3d_tpu_torch.ops import antialias, dmtet
from animals3d_tpu_torch.ops.rasterize import Rast
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.utils import meters
from test_animal_model import TINY_OVERRIDES
from torch_parity import batch_to, fake_batch_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
IT = 50000


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with `enable`'s tracing off."""
    tracing.disable()
    yield
    tracing.disable()
    set_mixed_precision(None)


class OpCount(TorchDispatchMode):
    """Counts the tensor operations dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def tiny():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    set_mixed_precision(None)
    cfg = tcfg.load_config("train_magicpony_horse", overrides=TINY_OVERRIDES)
    cfg["model"]["dataset"] = cfg["dataset"]
    model = build_model(cfg["model"], device="cpu")
    model.init_params(0)
    opt = trainer.make_optimizer(model)
    batch = batch_to(fake_batch_np(0), torch.from_numpy)
    yield model, opt, batch
    torch.set_num_threads(old)


def _bench_reader(name):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    from harness import spec
    return spec.metric_reader(name)


def test_off_records_nothing_and_runs_no_tensor_operation(monkeypatch):
    tracing.enable()
    with tracing.span("before"):
        tracing.count("before", 1)
    tracing.disable()
    before = tracing.snapshot()

    def called(*_a, **_k):
        raise AssertionError("called with tracing off")
    for mod, attr in ((torch.cuda, "Event"), (torch.cuda, "synchronize"),
                      (tracing._prof, "record_function")):
        monkeypatch.setattr(mod, attr, called)
    t = torch.ones(3)
    with OpCount() as ops:
        for _ in range(100):
            with tracing.span("off"):
                tracing.count("off", t)
    assert ops.n == 0
    monkeypatch.undo()
    after = tracing.snapshot()
    assert after["spans"] == before["spans"]
    assert after["counters"] == before["counters"]
    assert after["ring"] == before["ring"]
    # the mode sees a device-tensor counter's sum where tracing is on
    tracing.enable()
    with OpCount() as ops:
        tracing.count("on", t)
    assert ops.n > 0


def test_off_span_costs_about_a_microsecond():
    """The least of five runs of 20,000 off spans, entered and left: under
    2 µs a span on a loaded CPU (PERF.md gives the quiet reading)."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(20000):
            with tracing.span("off"):
                pass
        best = min(best, (time.perf_counter() - t0) / 20000)
    assert best < 2e-6, best


def test_train_step_and_reconstruct_give_the_layer_tree(tiny):
    model, opt, batch = tiny
    tracing.enable()
    trainer.train_step(model, opt, batch, IT, torch.Generator().manual_seed(3))
    model.reconstruct(model, batch["images"], IT)
    tracing.disable()
    snap = tracing.snapshot()
    ring = snap["ring"]
    by_id = {r["id"]: r for r in ring}

    def children(r):
        return [c["name"] for c in ring if c["parent"] == r["id"]]

    def only(name):
        (r,) = [r for r in ring if r["name"] == name]
        return r
    roots = [r for r in ring if r["parent"] is None]
    assert [r["name"] for r in roots] == ["a3d.train_step",
                                          "a3d.reconstruct"]
    assert snap["roots"] == 2
    assert children(roots[0]) == ["a3d.forward", "a3d.backward",
                                  "a3d.all_reduce", "a3d.adam"]
    for parent in (only("a3d.forward"), roots[1]):
        assert children(parent) == ["a3d.netbase", "a3d.netinstance",
                                    "a3d.render"]
    for r in ring:
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"]
            assert r["end_ns"] <= p["end_ns"]
            assert r["iteration"] == p["iteration"]
        else:
            assert r["iteration"] == r["id"]
    # a span's self time is its duration less its children's
    dur = {r["id"]: r["end_ns"] - r["start_ns"] for r in ring}
    host, own, calls = {}, {}, {}
    for r in ring:
        kids = sum(dur[c["id"]] for c in ring if c["parent"] == r["id"])
        host[r["name"]] = host.get(r["name"], 0) + dur[r["id"]]
        own[r["name"]] = own.get(r["name"], 0) + dur[r["id"]] - kids
        calls[r["name"]] = calls.get(r["name"], 0) + 1
    spans = snap["spans"]
    assert set(spans) == set(host)
    for name, a in spans.items():
        assert a["calls"] == calls[name] and a["stream_ms"] is None
        assert a["host_ms"] == pytest.approx(host[name] / 1e6, rel=1e-9)
        assert a["self_ms"] == pytest.approx(own[name] / 1e6, rel=1e-9)
    assert sum(a["self_ms"] for a in spans.values()) == pytest.approx(
        sum(spans[r["name"]]["host_ms"] for r in roots), rel=1e-9)
    c = snap["counters"]
    assert 0 < c["mesh.faces"] <= c["mesh.face_slots"]
    assert 0 < c["aa.pairs_kept"] <= c["aa.pairs_found"]
    assert c["launches.visibility"] == 0      # the CPU runs no kernel
    # netInstance's two calls, eager: the CPU captures no CUDA graph
    assert c["netinstance.eager_calls"] == 2
    assert "netinstance.graph_captures" not in c
    assert "netinstance.graph_replays" not in c


def test_profiler_session_turns_tracing_on_afresh():
    assert not tracing.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
        with tracing.span("first"):
            pass
    assert not tracing.on()
    with tracing.span("between"):
        pass
    assert set(tracing.snapshot()["spans"]) == {"a3d.first"}
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("second"):
            tracing.count("n", 2)
    snap = tracing.snapshot()
    assert set(snap["spans"]) == {"a3d.second"}
    assert snap["counters"]["n"] == 2 and snap["roots"] == 1


def test_spans_lie_inside_their_profiler_events(tmp_path):
    """A span's time.time_ns() start and end lie inside its
    `user_annotation` event (ts + baseTimeNanoseconds; 1 µs for the
    export's rounding) and within 0.1 ms of its ends. The garbage
    collector is held off and torch runs one thread: a collection, or
    intra-op threads spinning on a loaded machine, between the two clocks'
    readings would stretch the gap it measures."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with tracing.span("warmup"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            for i in range(5):
                with tracing.span(f"s{i}"):
                    torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        gc.enable()
        torch.set_num_threads(threads)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    events = {e["name"]: e for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    ring = [r for r in tracing.snapshot()["ring"]
            if r["name"] != "a3d.warmup"]
    assert len(ring) == 5
    for r in ring:
        e = events[r["name"]]
        start = base + float(e["ts"]) * 1e3
        end = start + float(e["dur"]) * 1e3
        assert start - 1e3 <= r["start_ns"] <= start + 1e5, (r, e)
        assert end - 1e5 <= r["end_ns"] <= end + 1e3, (r, e)


def test_face_fill_counts_the_extracted_meshes():
    grid = tetlib.DeviceTetGrid(tetlib.load_tet_grid(8), "cpu")
    pos = grid.verts * 2.0
    sdf = 0.6 - pos.norm(dim=-1)
    tracing.enable()
    with tracing.span("train_step"):
        full = dmtet.marching_tets(pos, sdf, grid, 4000, 8000)
        short = dmtet.marching_tets(pos, sdf, grid, 4000, 64)
    tracing.disable()
    faces = int(full.num_faces) + int(short.num_faces)
    assert int(short.num_faces) > 64            # the short buffer overflows
    snap = tracing.snapshot()
    assert snap["counters"]["mesh.faces"] == faces
    assert snap["counters"]["mesh.face_slots"] == 8000 + 64
    got = _bench_reader("face_fill_pct.train")(
        {"entry": "train", "program_trace": snap})
    assert got == pytest.approx(100.0 * faces / (8000 + 64))


def _pairs_by_hand(fid, z, z_tol):
    """Each image's silhouette pairs, by a loop over its pixels."""
    B, H, W = fid.shape
    out = []
    for b in range(B):
        n = 0
        for y in range(H):
            for x in range(W):
                for yy, xx in ((y, x + 1), (y + 1, x)):
                    if yy >= H or xx >= W:
                        continue
                    p, q = fid[b, y, x], fid[b, yy, xx]
                    if p == q or (p == 0 and q == 0):
                        continue
                    if p == 0 or q == 0 or abs(z[b, y, x] - z[b, yy, xx]) \
                            > z_tol:
                        n += 1
        out.append(n)
    return np.array(out)


def test_dropped_share_counts_the_silhouette_pairs():
    rng = np.random.default_rng(0)
    B, H, W, cap = 3, 12, 16, 20
    fid = rng.integers(0, 4, (B, H, W)).astype(np.int32)
    fid[2] = 0
    fid[2, 4:6, 5:7] = 1                        # 8 pairs, under the cap
    z = np.where(fid > 0, rng.uniform(0.1, 0.9, (B, H, W)), 0.0)
    rast = Rast(None, torch.tensor(z, dtype=torch.float32),
                torch.from_numpy(fid))
    faces = torch.tensor([[0, 1, 2]] * 4)
    v_clip = torch.tensor(rng.uniform(-1, 1, (B, 3, 4)),
                          dtype=torch.float32)
    v_clip[..., 3] = 1.0
    tracing.enable()
    with tracing.span("train_step"):
        pr = antialias.silhouette_pairs(rast, v_clip, faces, pair_cap=cap)
    tracing.disable()
    found = _pairs_by_hand(fid, z.astype(np.float32), 2e-3)
    kept = np.minimum(found, cap)
    assert found[0] > cap and found[2] == 8
    assert pr["slot_ok"].sum(-1).tolist() == kept.tolist()
    snap = tracing.snapshot()
    assert snap["counters"]["aa.pairs_found"] == found.sum()
    assert snap["counters"]["aa.pairs_kept"] == kept.sum()
    got = _bench_reader("aa_dropped_pct.train")(
        {"entry": "train", "program_trace": snap})
    assert got == pytest.approx(100.0 * (found.sum() - kept.sum())
                                / found.sum())


def test_raw_ring_keeps_the_last_64_iterations():
    tracing.enable()
    for _ in range(70):
        with tracing.span("step"):
            with tracing.span("inner"):
                pass
    snap = tracing.snapshot()
    iterations = sorted({r["iteration"] for r in snap["ring"]})
    assert len(iterations) == tracing.RING == 64
    assert len(snap["ring"]) == 2 * 64
    assert snap["roots"] == 70 and snap["spans"]["a3d.step"]["calls"] == 70
    assert iterations[0] == max(r["iteration"] for r in snap["ring"]) \
        - 2 * 63


HAND = {"spans": {n: {"calls": c, "host_ms": h, "self_ms": 0.0,
                      "stream_ms": s, "stream_calls": c if s else 0}
                  for n, c, h, s in (
                      ("a3d.train_step", 4, 400.0, None),
                      ("a3d.disc_step", 4, 40.0, None),
                      ("a3d.netbase", 4, 40.0, None),
                      ("a3d.netinstance", 4, 80.0, None),
                      ("a3d.render", 8, 60.0, None),
                      ("a3d.backward", 4, 100.0, 120.0),
                      ("a3d.adam", 4, 20.0, 30.0),
                      ("a3d.reconstruct", 2, 300.0, None))},
        "counters": {"mesh.faces": 300, "mesh.face_slots": 1000,
                     "aa.pairs_found": 200, "aa.pairs_kept": 150,
                     "netinstance.graph_replays": 3,
                     "netinstance.graph_captures": 1},
        "roots": 10, "ring": [], "start_ns": 0}
WANT = {"host_step_ms.train": 110.0, "netbase_host_ms.train": 10.0,
        "netinstance_host_ms.train": 20.0, "render_host_ms.train": 15.0,
        "backward_host_ms": 25.0, "adam_host_ms": 5.0,
        "backward_stream_ms": 30.0, "adam_stream_ms": 7.5,
        "face_fill_pct.train": 30.0, "aa_dropped_pct.train": 25.0,
        "host_step_ms.recon": 150.0, "face_fill_pct.recon": 30.0,
        "aa_dropped_pct.recon": 25.0, "netinstance_graphed_pct.train": 75.0,
        "netinstance_graphed_pct.recon": 75.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_benchmark_reader_of_a_hand_made_snapshot(name):
    read = _bench_reader(name)
    entry = "recon" if name.endswith(".recon") else "train"
    assert read({"entry": entry, "program_trace": HAND}) == \
        pytest.approx(WANT[name])
    other = "train" if entry == "recon" else "recon"
    assert read({"entry": other, "program_trace": HAND}) is None
    assert read({"entry": entry, "program_trace": None}) is None


@pytest.mark.parametrize("entry", ["train", "recon"])
def test_graphed_share_without_the_counters_reads_none(entry):
    """A program that counts no netInstance call (one without the graphs)
    leaves the share out of the line."""
    counts = {k: v for k, v in HAND["counters"].items()
              if not k.startswith("netinstance.")}
    read = _bench_reader(f"netinstance_graphed_pct.{entry}")
    assert read({"entry": entry,
                 "program_trace": {**HAND, "counters": counts}}) is None
    counts["netinstance.eager_calls"] = 4
    assert read({"entry": entry,
                 "program_trace": {**HAND, "counters": counts}}) == 0.0


def test_dropped_share_of_no_pairs_reads_zero():
    """An empty mesh (3D-Fauna's random-weight prior on some seeds) gives
    no silhouette pair: none dropped."""
    snap = {**HAND, "counters": {**HAND["counters"], "aa.pairs_found": 0,
                                 "aa.pairs_kept": 0}}
    for name, entry in (("aa_dropped_pct.train", "train"),
                        ("aa_dropped_pct.recon", "recon")):
        assert _bench_reader(name)(
            {"entry": entry, "program_trace": snap}) == 0.0


def test_trace_file_of_the_training_loop(tmp_path):
    data = tmp_path / "synth"
    write_synth_dataset(str(data), n=4, size=64, dino_dim=4)
    path = str(tmp_path / "run" / "trace.json")
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trun.main(["--config-name", "train_magicpony_horse", "--device",
                   "cpu", *TINY_OVERRIDES,
                   f"dataset.train_data_dir={data}",
                   "dataset.val_data_dir=null", "dataset.test_data_dir=null",
                   f"checkpoint_dir={tmp_path / 'ckpt'}",
                   "dataset.num_workers=1", "num_iters=3",
                   "save_checkpoint_freq=2", "log_loss_freq=2",
                   "use_logger=false",
                   f"trace_file={path}"])
    finally:
        torch.set_num_threads(old)
    assert not tracing.on()
    with open(path) as f:
        trace = json.load(f)
    spans = trace["metadata"]["spans"]
    assert spans["a3d.train_step"]["calls"] == 3
    assert spans["a3d.load"]["calls"] == 3
    assert spans["a3d.log"]["calls"] == 2       # iterations 1 and 2
    assert trace["metadata"]["counters"]["mesh.face_slots"] > 0
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("a3d.adam") == 3
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert e["ts"] * 1e3 + trace["baseTimeNanoseconds"] >= \
            time.time_ns() - 600e9


def test_speed_meter_counts_the_images_between_updates(monkeypatch):
    """Ten images an iteration, 20 ms apart, logged every 5 iterations:
    500 images/s."""
    clock = [1000.0]
    monkeypatch.setattr(meters, "time",
                        types.SimpleNamespace(time=lambda: clock[0]))
    m = meters.StandardMetrics()
    for it in range(1, 51):
        clock[0] += 0.02
        m.add_images(10)
        if it % 5 == 0 or it == 1:
            m.update({"loss": 1.0}, 10)
    assert m.speed.get() == pytest.approx(500.0, rel=0.05)
