"""The `recon` entry: single-image reconstruction as the test path runs
it, `AnimalModel.reconstruct` (netBase -> netInstance -> the shaded
render of the input view) at the eval phase of a fixed iteration.

Set-up builds the model through the program's normal path, loads the
weights the benchmark made from the seed, makes a pool of distinct image
batches on the device and reconstructs twice to warm up. The window is a
closed loop, one client: a batch is done when its shaded RGBA is on the
host, and its latency runs from the call to then. The outputs of a
sample of the pool's batches, drawn from the seed, are kept from their
last pass through the window; the check reconstructs the same batches
with the reference and compares the RGBA, the pose and the posed mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import statistics
import time

import torch

from harness import bounds, trace, traffic, weights
from harness import sides as sidelib
from harness.entries import common


@dataclasses.dataclass
class State:
    cell: object
    side: object
    device: object
    cfg_name: str
    overrides: list
    model: object
    pool: list
    it: int
    init: dict
    sample: list          # pool indices whose outputs are compared
    kept: dict = dataclasses.field(default_factory=dict)
    k: int = 0
    window: dict = None
    setup_parts: dict = None


def _config(cell):
    w, c = cell.workload, cell.config
    return (c["port_configs"]["recon"],
            list(c.get("overrides", [])) + list(w.get("overrides", [])))


def setup(cell, seed: int, device, side=None) -> State:
    side = side or sidelib.program()
    w = cell.workload
    common.float32_numerics()
    parts, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        common.sync(device)
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    wseed, tseed, sseed = common.seeds(seed, 3)
    name, ov = _config(cell)
    cfg = side.load_config(name, ov)
    side.set_precision(cfg)
    model = side.build(cfg, device)
    lap("build")
    state = weights.make(sidelib.reference().load_config(name, ov), wseed,
                         device)
    model.load_state_dict(state)
    init = common.host_state(state)
    del state
    lap("weights")
    pool = traffic.image_pool(w["pool"], w["batch"], model.in_image_size,
                              model.num_frames, tseed, device)
    sample = sorted(random.Random(sseed).sample(range(w["pool"]),
                                                w["sample"]))
    st = State(cell, side, device, name, ov, model, pool, int(w["iteration"]),
               init, sample, setup_parts=parts)
    lap("traffic")
    for _ in range(int(w["warmup"])):
        _next(st)
    lap("warmup")
    st.kept = {}
    return st


def _next(st):
    i = st.k % len(st.pool)
    rgba, out = st.side.reconstruct(st.model, st.pool[i], st.it)
    host = rgba.cpu()
    st.k += 1
    if i in st.sample:
        shape, pose = out[0], out[2]
        st.kept[i] = (host, pose, shape.v_pos, shape.v_valid)
    return host


def window(st: State, seconds: float) -> dict:
    """Reconstruct batch after batch for `seconds` of the host's clock, and
    on until every sampled batch has passed through the window once."""
    w = st.cell.workload
    common.sync(st.device)
    common.reset_peak(st.device)
    lat = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        _next(st)
        lat.append(time.perf_counter() - ts)
        if time.perf_counter() - t0 >= seconds and \
                len(st.kept) == len(st.sample):
            break
    common.sync(st.device)
    dt = time.perf_counter() - t0
    st.window = {"steps": len(lat), "seconds": dt,
                 "peak_bytes": common.peak_bytes(st.device),
                 "median_ms": statistics.median(lat) * 1e3}
    p90 = statistics.quantiles(lat, n=10)[8] if len(lat) > 1 else lat[0]
    return {"recon_imgs_per_s": len(lat) * w["batch"] / dt,
            "recon_p90_ms": p90 * 1e3}


def traced(st: State) -> dict:
    steps = int(st.cell.workload["trace_steps"])

    def body():
        for _ in range(steps):
            with trace.rng("step"):
                _next(st)
    with trace.stage_ranges(st.model):
        ctx = trace.profile(body)
    ctx["steps"] = steps
    return ctx


def _moments(v_pos, v_valid):
    """Per image: the valid vertices' centroid (3,) and RMS radius."""
    m = v_valid.to(v_pos.dtype)[None, :, None]
    n = m.sum(1).clamp(min=1.0)
    c = (v_pos * m).sum(1) / n
    r = (((v_pos - c[:, None]) ** 2).sum(-1, keepdim=True) * m).sum(1) / n
    return c, r.sqrt()[:, 0]


def readings(prog: dict, ref: dict) -> tuple:
    """(readings, None) of the program's outputs `prog` against the
    reference's `ref["outs"]`, each pool index -> (rgba, pose, v_pos,
    v_valid): the RGBA's mean absolute gap; the pose's largest gap over
    the reference pose's largest magnitude; the posed mesh's centroid and
    RMS radius, their largest gap over the reference radius. (Where bf16
    moves an SDF sign the two vertex sets differ, so vertices are not
    paired.)"""
    ref = ref["outs"]
    rgba, pose, mesh = [], [], []
    for i in ref:
        a, p, v, vv = prog[i]
        ra, rp, rv, rvv = ref[i]
        rgba.append(float((a.float() - ra.float()).abs().mean()))
        pose.append(float((p.float() - rp.float()).abs().max()
                          / rp.float().abs().max().clamp(min=1e-12)))
        c, r = _moments(v.float(), vv)
        rc, rr = _moments(rv.float(), rvv)
        scale = rr.clamp(min=1e-12)
        mesh.append(float(torch.maximum((c - rc).norm(dim=-1) / scale,
                                        (r - rr).abs() / scale).max()))
    return {"rgba_gap": max(rgba), "pose_gap": max(pose),
            "mesh_gap": max(mesh)}, None


def outputs(st: State) -> dict:
    """What the check compares of the program's run, on the host."""
    return {i: tuple(t.cpu() for t in v) for i, v in st.kept.items()}


def reference(st: State, counting: bool = False) -> dict:
    """Free the program's state and reconstruct the sampled batches with
    the reference (at the configuration's precision, TF32 off); with
    `counting`, the first one's model FLOPs and the kernels' bounds from
    its shapes."""
    device = st.device
    images = {i: st.pool[i] for i in st.sample}
    st.model = st.pool = None
    st.kept = {}
    common.free(device)
    common.float32_numerics()
    ref = sidelib.reference(st.cell.config["precision"])
    cfg = ref.load_config(st.cfg_name, st.overrides)
    ref.set_precision(cfg)
    model = ref.build(cfg, device)
    model.load_state_dict({k: v.to(device) for k, v in st.init.items()})
    records = []
    outs = {}
    for j, i in enumerate(st.sample):
        with common.counting(records) if counting and j == 0 \
                else contextlib.nullcontext():
            rgba, out = ref.reconstruct(model, images[i], st.it)
        outs[i] = (rgba.cpu(), out[2].cpu(), out[0].v_pos.cpu(),
                   out[0].v_valid.cpu())
    result = {"outs": outs}
    if counting:
        result["flops"] = common.counted_flops(records)
        result["bounds"] = bounds.from_records(records)
    del model
    common.free(device)
    return result


def check(st: State, counting: bool = False) -> tuple:
    """The reference's run and the readings against it: (readings,
    counts), with `flops` and `bounds` where counting."""
    prog = outputs(st)
    ref = reference(st, counting)
    reads, _ = readings(prog, ref)
    return reads, {k: ref[k] for k in ("flops", "bounds") if k in ref}
