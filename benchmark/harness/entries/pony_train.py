"""The `pony_train` entry: Ponymation's training iteration at a fixed
iteration of the schedule (stage 2: the motion VAE distilled from the
frozen articulation net over sequences of frames).

The program's side is the `train` entry's: one model and its optimizers
through the program's normal path (`config.load_config` ->
`models.build_model`), the weights the benchmark made from the seed, the
pool of distinct batches on the device, the first `ref_steps` steps kept
for the check (`train._follow`), and a window of `trainer.train_step`
calls back to back (`train.window`), traced as `train.traced` traces it.

The reference's `models.build_model` has no Ponymation, so this entry's
reference side (`Reference`) builds `refmodel.models.ponymation.Ponymation`
directly, and the weights are made from it as `weights.make` makes them
(`make_weights`). The float8 control and the bfloat16 reading are the same
side at a lower precision.

`train_imgs_per_s` counts frames: steps × sequences × frames over the
window's seconds, each frame one image of the batch, as in the other
training cells.

Readings: `train.readings`', with `step_loss_gap` (the worst gap of the
loss over all `ref_steps` steps, where `loss_gap` reads the first),
`arti_recon_gap` and `kld_gap` (the first step's `arti_recon_loss` and
`kld_loss` against the reference's), and `mesh_gap` (the first step's
posed meshes against the reference's, frame by frame; render is off, so
no loss reads them)."""
from __future__ import annotations

import contextlib
import math
import time

import torch

from harness import bounds, spans, traffic
from harness import sides as sidelib
from harness.entries import common, train

ENTRY = "pony_train"


class Reference(sidelib.Side):
    """`refmodel`'s Ponymation, built as the command line builds a model:
    the config's model section with its dataset section."""

    def build(self, cfg: dict, device):
        from refmodel.models.ponymation import Ponymation
        model_cfg = dict(cfg.get("model") or {})
        model_cfg["dataset"] = cfg.get("dataset")
        return Ponymation(model_cfg, device=device)


def reference_side(precision: str = "float32", name="reference"):
    return Reference("refmodel", precision=precision, name=name)


def make_weights(ref_cfg: dict, seed: int, device) -> dict:
    """The state dict of a fresh reference Ponymation of `ref_cfg`, every
    module's `init_weights` drawing from one generator on `device` seeded
    with `seed`, in module order (`weights.make`)."""
    model = reference_side().build(ref_cfg, device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for m in model.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    return state


def _moments(v_pos, v_valid) -> tuple:
    """Per frame of posed meshes: the valid vertices' centroid (N, 3) and
    their second central moments (N, 3, 3), in float64, on the host."""
    v = v_pos.double()
    m = v_valid.to(v.dtype)[None, :, None]
    n = m.sum(1).clamp(min=1.0)
    c = (v * m).sum(1) / n
    d = (v - c[:, None]) * m
    return c.cpu(), (d.transpose(1, 2) @ d / n[:, :, None]).cpu()


@contextlib.contextmanager
def _first_posed(model):
    """Within the block, the predictor's first `forward_articulation`
    call keeps its posed meshes; after it, the dict yielded holds their
    `_moments` under "posed" (taken outside the block, so that the
    reference's counted first step does not count them)."""
    net = model.netInstance
    kept = {}

    def keep(*args, **kwargs):
        out = type(net).forward_articulation(net, *args, **kwargs)
        kept.setdefault("mesh", (out[0].v_pos.detach(), out[0].v_valid))
        return out
    net.forward_articulation = keep
    try:
        yield kept
    finally:
        del net.forward_articulation
    kept["posed"] = _moments(*kept.pop("mesh"))


def mesh_gap(prog: tuple, ref: tuple) -> float:
    """The largest over frames of the centroid's gap over the reference
    mesh's RMS radius r and of the second moments' gap (Frobenius) over
    r²; infinite where the frame counts differ. (Where an SDF sign
    differs the two vertex sets differ, so vertices are not paired.)"""
    (c, s), (rc, rs) = prog, ref
    if c.shape != rc.shape:
        return math.inf
    r2 = rs.diagonal(dim1=1, dim2=2).sum(-1).clamp(min=1e-24)
    gap = torch.maximum((c - rc).norm(dim=-1) / r2.sqrt(),
                        (s - rs).flatten(1).norm(dim=-1) / r2)
    return float(gap.max())


def setup(cell, seed: int, device, side=None) -> train.State:
    """`train.setup` with the weights made from `Reference`."""
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
    name, ov = train._config(cell)
    cfg = side.load_config(name, ov)
    side.set_precision(cfg)
    model = side.build(cfg, device)
    lap("build")
    state = make_weights(reference_side().load_config(name, ov), wseed,
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
    with _first_posed(model) as kept:
        losses, grad1, change, terms = train._follow(
            side, model, opt, pool, gen, phase, it0, w["ref_steps"], device,
            init)
    lap("first_steps")
    st = train.State(cell, side, device, name, ov, model, opt, pool, gen,
                     phase, it0, nseed, init, losses, grad1, change,
                     k=w["ref_steps"], setup_parts=parts, terms=terms)
    st.posed = kept["posed"]
    return st


def window(st: train.State, seconds: float) -> dict:
    """`train.window`, its rate counted in frames."""
    frames = st.model.num_frames
    out = train.window(st, seconds)
    return {"train_imgs_per_s": out["train_imgs_per_s"] * frames}


traced = train.traced
model_flops = train.model_flops


def outputs(st: train.State) -> dict:
    """`train.outputs`, with the first step's posed meshes' moments."""
    return dict(train.outputs(st), posed=st.posed)


def reference(st: train.State, counting: bool = False) -> dict:
    """`train.reference` with `Reference`: free the program's state and
    follow the first steps with the reference Ponymation (at the
    configuration's precision, TF32 off) from the same weights, batches
    and draws."""
    w = st.cell.workload
    device = st.device
    st.model = st.opt = st.gen = None
    pool = st.pool[:w["ref_steps"]]
    st.pool = None
    common.free(device)
    common.float32_numerics()
    ref = reference_side(st.cell.config["precision"])
    cfg = ref.load_config(st.cfg_name, st.overrides)
    ref.set_precision(cfg)
    model = ref.build(cfg, device)
    model.load_state_dict({k: v.to(device) for k, v in st.init.items()})
    opt = ref.make_optimizer(model)
    gen = torch.Generator(device=device).manual_seed(st.noise_seed)
    phase = model.phase_for_iter(st.it0)
    records = [] if counting else None
    with _first_posed(model) as kept:
        losses, grad1, change, terms = train._follow(
            ref, model, opt, pool, gen, phase, st.it0, w["ref_steps"],
            device, st.init, records=records)
    out = {"losses": losses, "grad1": grad1, "change": change,
           "terms": terms, "posed": kept["posed"]}
    if counting:
        out["flops"] = model_flops(common.counted_flops(records), records)
        out["bounds"] = bounds.from_records(
            records, 2 if st.cell.config["precision"] == "bf16" else 4)
    del model, opt
    common.free(device)
    return out


def readings(prog: dict, ref: dict) -> tuple:
    """`train.readings`, with `step_loss_gap`, `arti_recon_gap` and
    `kld_gap` (None where the program or the reference has no such
    term) and `mesh_gap`."""
    reads, detail = train.readings(prog, ref)
    reads["step_loss_gap"] = max(detail["step_loss_gaps"])
    for term in ("arti_recon", "kld"):
        reads[term + "_gap"] = detail["term_gaps"].get(term + "_loss")
    reads["mesh_gap"] = mesh_gap(prog["posed"], ref["posed"])
    return reads, detail


def check(st: train.State, counting: bool = False) -> tuple:
    """`train.check` with this entry's reference and readings."""
    prog = outputs(st)
    ref = reference(st, counting)
    reads, detail = readings(prog, ref)
    counts = {"detail": detail}
    for k in ("flops", "bounds"):
        if k in ref:
            counts[k] = ref[k]
    return reads, counts


def span_ms(ctx, name: str, field: str = "stream_ms"):
    """A program span's `field` per iteration of a `pony_train` cell's
    traced window (`spans.per_iteration`, rooted at `a3d.train_step`);
    None in other cells, or where the program has no such span."""
    if ctx.get("entry") != ENTRY:
        return None
    spans.snapshot(ctx)          # kept in `ctx`, so the copy shares it
    return spans.per_iteration(dict(ctx, entry="train"), "train", [name],
                               field)
