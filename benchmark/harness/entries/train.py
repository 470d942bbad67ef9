"""The `train` entry: the iteration that `Trainer.train` runs, at a fixed
training iteration of the schedule.

Set-up builds one model and its optimizers through the program's normal
path (`config.load_config` -> `models.build_model`), loads the weights
the benchmark made from the seed, makes the pool of distinct batches on
the device and drives the iteration through its first `ref_steps` steps
(which also warm up every shape), keeping what the check compares: each
step's loss, the first gradient as the optimizer got it (worked out from
its Adam state after one step) and the parameters' change after the last
of them. The window then goes on with the same objects: `train_step`,
then the discriminator's `disc_step` where the phase has one, dispatched
ahead as the Trainer dispatches them; the host reads the loss every
`log_loss_freq` steps, and the clock stops after a synchronize.

The check builds the reference (`refmodel`, at the precision the
configuration states: bf16 matmul operands, float32 elsewhere, TF32 off)
from the same weights and batches and follows the same first steps with
a generator seeded alike, so that both draw the same random numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time

import torch

from harness import bounds, compare, trace, traffic, weights
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
    opt: object
    pool: list
    gen: object
    phase: object
    it0: int
    noise_seed: int
    init: dict            # the weights, on the host, for the reference
    losses: list          # per step: the loss (and the discriminator's)
    grad1: dict           # leaf -> norm of the first gradient
    change: dict          # leaf -> norm of the change after ref_steps
    k: int = 0            # iterations run
    window: dict = None
    setup_parts: dict = None
    terms: dict = None    # the first step's loss terms


def _config(cell):
    w, c = cell.workload, cell.config
    return (c["port_configs"]["train"],
            list(c.get("overrides", [])) + list(w.get("overrides", [])))


def iteration(side, model, opt, batch, it, gen, phase, ranges=False):
    """One iteration as `Trainer.train` runs it: `train_step`, then the
    discriminator's step on the step's record where the phase has one."""
    m = side.train_step(model, opt, batch, it, gen, phase)
    rec = m.pop("_disc_record", None)
    if rec is not None and phase.disc_on and opt.disc is not None:
        with trace.rng("disc_step") if ranges else contextlib.nullcontext():
            m["discriminator_loss"] = side.disc_step(model, opt, rec)
    return m


def _leaves(model, opt) -> list:
    """(name, parameter) of every parameter an optimizer steps."""
    names = {p: n for n, p in model.named_parameters()}
    params = list(opt.trained())
    if opt.disc is not None:
        params += [p for g in opt.disc.param_groups for p in g["params"]]
    return [(names[p], p) for p in params]


def _optimizers(opt) -> list:
    return list(opt.optimizers.values()) + \
        ([opt.disc] if opt.disc is not None else [])


def _first_grads(opt, leaves) -> dict:
    """Each leaf's first gradient norm, from its Adam state after one
    step: exp_avg = (1 - beta1)·g."""
    beta1 = {}
    for o in _optimizers(opt):
        for g in o.param_groups:
            for p in g["params"]:
                beta1[p] = g["betas"][0]
    state = {}
    for o in _optimizers(opt):
        state.update(o.state)
    norms = torch.stack([state[p]["exp_avg"].norm() / (1.0 - beta1[p])
                         for _n, p in leaves])
    return dict(zip([n for n, _p in leaves], norms.tolist()))


def _changes(leaves, init, device) -> dict:
    norms = torch.stack([(p.detach() - init[n].to(device)).norm()
                         for n, p in leaves])
    return dict(zip([n for n, _p in leaves], norms.tolist()))


def _terms(m) -> dict:
    """The step's loss terms: every scalar metric named `*_loss`."""
    return {k: float(v) for k, v in m.items()
            if k.endswith("_loss") and getattr(v, "numel", lambda: 1)() == 1}


def _step_losses(m) -> list:
    out = [float(m["loss"])]
    if "discriminator_loss" in m:
        out.append(float(m["discriminator_loss"]))
    return out


def _follow(side, model, opt, pool, gen, phase, it0, steps, device, init,
            records=None):
    """Run the first `steps` iterations; returns (losses, first gradient
    norms, change norms, the first step's loss terms). With `records`, the
    first iteration is counted into it (`common.counting`)."""
    leaves = _leaves(model, opt)
    losses, grad1, terms = [], None, None
    for k in range(steps):
        batch = pool[k % len(pool)]
        with common.counting(records) if k == 0 and records is not None \
                else contextlib.nullcontext():
            m = iteration(side, model, opt, batch, it0 + k, gen, phase)
        losses.append(_step_losses(m))
        if k == 0:
            grad1 = _first_grads(opt, leaves)
            terms = _terms(m)
    return losses, grad1, _changes(leaves, init, device), terms


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
    wseed, tseed, nseed = common.seeds(seed, 3)
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
    opt = side.make_optimizer(model)
    lap("optimizer")
    pool = traffic.pool(w["pool"], w["batch"], model.in_image_size,
                        model.num_frames, model.dino_feature_dim, tseed,
                        device)
    gen = torch.Generator(device=device).manual_seed(nseed)
    it0 = int(w["iteration"])
    phase = model.phase_for_iter(it0)
    lap("traffic")
    losses, grad1, change, terms = _follow(side, model, opt, pool, gen,
                                           phase, it0, w["ref_steps"],
                                           device, init)
    lap("first_steps")
    return State(cell, side, device, name, ov, model, opt, pool, gen, phase,
                 it0, nseed, init, losses, grad1, change, k=w["ref_steps"],
                 setup_parts=parts, terms=terms)


def _next(st, ranges=False):
    m = iteration(st.side, st.model, st.opt, st.pool[st.k % len(st.pool)],
                  st.it0 + st.k, st.gen, st.phase, ranges=ranges)
    st.k += 1
    return m


def window(st: State, seconds: float) -> dict:
    """The measured window: iterations for `seconds` of the host's clock,
    the loss read every `log_loss_freq` steps, then a synchronize."""
    w = st.cell.workload
    freq = int(w["log_loss_freq"])
    common.sync(st.device)
    common.reset_peak(st.device)
    n = 0
    t0 = time.perf_counter()
    while True:
        m = _next(st)
        n += 1
        if n % freq == 0 and not math.isfinite(float(m["loss"])):
            raise FloatingPointError(f"non-finite loss at step {st.k}")
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(st.device)
    dt = time.perf_counter() - t0
    st.window = {"steps": n, "seconds": dt,
                 "peak_bytes": common.peak_bytes(st.device)}
    return {"train_imgs_per_s": n * w["batch"] / dt}


def traced(st: State) -> dict:
    """`trace_steps` iterations under the profiler, with the stage
    ranges and a range around each discriminator step."""
    steps = int(st.cell.workload["trace_steps"])

    def body():
        for _ in range(steps):
            with trace.rng("step"):
                _next(st, ranges=True)
    with trace.stage_ranges(st.model):
        ctx = trace.profile(body)
    ctx["steps"] = steps
    return ctx


def reference(st: State, counting: bool = False) -> dict:
    """Free the program's state and follow the first steps with the
    reference (at the configuration's precision, TF32 off) from the same
    weights, batches and random draws: each step's losses, the first
    gradient and the change norms; with `counting`, the first iteration's
    model FLOPs and the kernels' bounds from its shapes."""
    w = st.cell.workload
    device = st.device
    st.model = st.opt = st.gen = None
    pool = st.pool[:w["ref_steps"]]
    st.pool = None
    common.free(device)
    common.float32_numerics()
    ref = sidelib.reference(st.cell.config["precision"])
    cfg = ref.load_config(st.cfg_name, st.overrides)
    ref.set_precision(cfg)
    model = ref.build(cfg, device)
    model.load_state_dict({k: v.to(device) for k, v in st.init.items()})
    opt = ref.make_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(st.noise_seed)
    phase = model.phase_for_iter(st.it0)
    records = [] if counting else None
    losses, grad1, change, terms = _follow(ref, model, opt, pool, gen, phase,
                                    st.it0, w["ref_steps"], device, st.init,
                                    records=records)
    out = {"losses": losses, "grad1": grad1, "change": change,
           "terms": terms}
    if counting:
        out["flops"] = model_flops(common.counted_flops(records), records)
        out["bounds"] = bounds.from_records(
            records, 2 if st.cell.config["precision"] == "bf16" else 4)
    del model, opt
    common.free(device)
    return out


def readings(prog: dict, ref: dict) -> tuple:
    """(readings, detail) of the program's losses, first gradient and
    change norms (`prog`) against the reference's.

    Readings: the first step's losses' gap (the generator's and, where
    there is one, the discriminator's); the median leaf's gap of the
    first gradient over all leaves and over netSDF's (`grad_gap`,
    `sdf_grad_gap`); the median leaf's gap of the change over all leaves
    and the largest of the trained modules' own (`change_gap`,
    `module_change_gap`); the worst leaf's (`worst_grad_gap`,
    `worst_change_gap`); and the worst relative gap of the first step's
    regularizer terms (`reg_gap`: each `*_reg_loss`, the SDF's, the
    articulation's, the deformation's), which do not pass through the
    render. A cell's `limits` say which are compared. The
    later steps' losses and each module's median and worst leaf are in
    `detail`."""
    grad = compare.leaf_gaps(prog["grad1"], ref["grad1"])
    change = compare.leaf_gaps(prog["change"], ref["change"],
                               keep=compare.moving(ref["grad1"]))
    gs, cs = compare.summary(grad), compare.summary(change)
    gm, cm = compare.by_module(grad), compare.by_module(change)
    reads = {"loss_gap": compare.loss_gap(prog["losses"][0],
                                          ref["losses"][0]),
             "grad_gap": gs["median"], "change_gap": cs["median"],
             "module_change_gap": max(m["median"] for m in cm.values()),
             "worst_grad_gap": gs["worst"], "worst_change_gap": cs["worst"]}
    terms = {k: compare.loss_gap([prog["terms"][k]], [r])
             for k, r in ref["terms"].items()
             if k in prog["terms"] and r != 0}
    regs = [g for k, g in terms.items() if k.endswith("_reg_loss")]
    if regs:
        reads["reg_gap"] = max(regs)
    if compare.SDF in gm:
        reads["sdf_grad_gap"] = gm[compare.SDF]["median"]
    detail = {"grad": gs, "change": cs,
              "modules": {m: {"grad": gm[m]["median"],
                              "grad_worst": gm[m]["worst"],
                              "change": cm.get(m, {}).get("median"),
                              "change_worst": cm.get(m, {}).get("worst")}
                          for m in gm},
              "term_gaps": terms,
              "step_loss_gaps": [compare.loss_gap(p, r) for p, r in
                                 zip(prog["losses"], ref["losses"])],
              "losses": prog["losses"], "ref_losses": ref["losses"]}
    return reads, detail


def outputs(st: State) -> dict:
    """What the check compares of the program's run."""
    return {"losses": st.losses, "grad1": st.grad1, "change": st.change,
            "terms": st.terms}


def check(st: State, counting: bool = False) -> tuple:
    """The reference's run and the readings against it: (readings,
    counts), counts holding `detail` and, with `counting`, `flops` and
    `bounds`."""
    prog = outputs(st)
    ref = reference(st, counting)
    reads, detail = readings(prog, ref)
    counts = {"detail": detail}
    for k in ("flops", "bounds"):
        if k in ref:
            counts[k] = ref[k]
    return reads, counts


def model_flops(counted: int, records: list) -> int:
    """The counted FLOPs less the lattice sweep's recomputed forward in
    its backward and the zero padding of its input width (the model's
    work is at the embedding's own width), plus the two products of its
    backward that torch's counter does not see: the last layer's weight
    gradient (a matrix-vector product) and its cotangent (an outer
    product written elementwise)."""
    nf = bounds.NF
    for kind, f in records:
        N, d, dp, L = f.get("N"), f.get("d"), f.get("dp"), f.get("L")
        if kind == "sweep_fwd":
            counted -= 2 * N * (dp - d) * nf
        elif kind == "sweep_bwd":
            counted -= 2 * N * (dp * nf + (L - 1) * nf * nf)
            counted -= 2 * N * (dp - d) * nf
            counted += 2 * 2 * N * nf
    return counted
