#!/usr/bin/env python3
"""Where the time of the port's single-image reconstruction, or of its
training step, goes on one CUDA card.

    python3 scripts/torch_recon_profile.py [--train] [--runs N] [--out DIR]

Builds `train_magicpony_horse` at full width (iter-50000 phase: grid 128,
articulation on; batch 10 at 256², dino_vits8, bf16 compute, weights from
`init_params(0)`) and times, with CUDA events (median of N runs after a
warm-up), the three stages of `reconstruct`: netBase (SDF sweep + marching
tets), netInstance (ViT, pose, articulation, skinning) and the render of
the input view, and inside the render the visibility kernel. Then traces
N whole `reconstruct` runs with `torch.profiler` and prints the device's
busy share of the wall time and the CUDA kernels with the most device
time. Writes the chrome trace to DIR (default `results/torch_profile/`).

With `--train` it times instead the stages of `train_step` on
`fake_batch` at the iter-50000 training phase (forward, backward,
optimizer step; CUDA events around each, a synchronize between them) and
traces N whole steps the same way. `--raster-variant {3,4,6}` and
`--resolve-rows {gather,kernel}` select the render path (the model's
`raster_variant` and `resolve_rows`).
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the full-width setup and the timers)
from animals3d_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402
from animals3d_tpu_torch.render.camera import xfm_points  # noqa: E402


def timed(fn, runs):
    """fn's output and its median device time (ms) over `runs` runs."""
    return fn(), statistics.median(chip_smoke.cuda_ms(fn, runs))


def report(prof, wall_us, runs, what, card, out_dir, trace_name):
    """The device's busy share of the wall time (union of the device
    events' intervals) and the kernels with the most device time."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    print(f"profile: {runs} {what}, wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({busy / wall_us * 100:.1f}%), "
          f"{len(events)} device events; card {card}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    prof.export_chrome_trace(os.path.join(out_dir, trace_name))


def train_main(args, card) -> int:
    from torch.profiler import ProfilerActivity, profile
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    model, _images, _it, B, _H = chip_smoke.slice_phase(**render_args(args))
    it = chip_smoke.TRAIN_IT
    phase = model.phase_for_iter(it)
    batch = fake_batch(model, B, chip_smoke.SEED)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for _ in range(2):
        train_step(model, opt, batch, it, gen, phase)
    stages = {"forward": [], "backward": [], "optimizer": [], "step": []}

    def span(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        stages[name].append(start.elapsed_time(end))
        return out

    def opt_step():
        opt.step()
        opt.zero_grad(set_to_none=True)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.runs):
        loss, _ = span("forward",
                       lambda: model.forward(batch, it, gen, phase))
        span("backward", loss.backward)
        span("optimizer", opt_step)
        span("step", lambda: train_step(model, opt, batch, it, gen, phase))
    med = {k: statistics.median(v) for k, v in stages.items()}
    print(f"card: {card}; raster_variant {args.raster_variant}, "
          f"resolve_rows {args.resolve_rows}")
    print(f"train stages (median of {args.runs}, CUDA events, ms): forward "
          f"{med['forward']:.3f}, backward {med['backward']:.3f}, optimizer "
          f"{med['optimizer']:.3f}, train_step {med['step']:.3f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    os.makedirs(args.out, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.runs):
            train_step(model, opt, batch, it, gen, phase)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report(prof, wall_us, args.runs, "train steps", card, args.out,
           "train_trace.json")
    return 0


def render_args(args):
    return dict(raster_variant=args.raster_variant,
                resolve_rows=args.resolve_rows)


def visibility_call(prep, res, variant):
    """The visibility kernel of `variant` on a prep of `rc.prepare`."""
    common = (prep["table"], prep["orig"])
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    if variant == 3:
        return lambda: rc.visibility(*common, *lists, prep["fbox"], res,
                                     prep["nsub"])
    if variant == 4:
        return lambda: rc.visibility_v4(prep["table"], prep["bbase"], *lists,
                                        prep["fbox"], res, prep["nsub"])
    return lambda: rc.visibility_v6(*common, prep["units"], prep["counts6"],
                                    prep["zu"], prep["fbox"], prep["ubox"],
                                    res, prep["nsub"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train", action="store_true",
                    help="profile the training step instead of the recon")
    ap.add_argument("--raster-variant", type=int, default=3,
                    choices=(3, 4, 6))
    ap.add_argument("--resolve-rows", default="gather",
                    choices=("gather", "kernel"))
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", default="results/torch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    rc.build()
    if args.train:
        return train_main(args, card)
    model, images, it, _B, H = chip_smoke.slice_phase(**render_args(args))
    phase = model.phase_for_iter(it, is_training=False)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    with torch.no_grad():
        for _ in range(2):
            model.reconstruct(model, images, it)
        (prior, _sdf), base_ms = timed(
            lambda: model.forward_base(grid, v_cap, f_cap), args.runs)
        out, inst_ms = timed(
            lambda: model.instance_forward(images, prior, it, phase),
            args.runs)
        shape, mvp, w2c, campos = out[0], out[3], out[4], out[5]
        _r, render_ms = timed(lambda: model.render(
            ["shaded"], shape, mvp, w2c, campos, (H, H),
            im_features=out[6], light_params=out[10], prior_mesh=prior),
            args.runs)
        v_clip = xfm_points(shape.v_pos, mvp)
        prep, prep_ms = timed(lambda: rc.prepare(
            v_clip, shape.v_pos[0], shape.t_pos_idx, shape.f_valid, (H, H),
            variant=args.raster_variant), args.runs)
        _v, vis_ms = timed(visibility_call(prep, (H, H), args.raster_variant),
                           args.runs)
        _t, total_ms = timed(lambda: model.reconstruct(model, images, it),
                             args.runs)
    print(f"card: {card}; raster_variant {args.raster_variant}, "
          f"resolve_rows {args.resolve_rows}")
    print(f"stages (median of {args.runs}, CUDA events, ms): netBase "
          f"{base_ms:.3f}, netInstance {inst_ms:.3f}, render {render_ms:.3f}"
          f" (of which visibility prep {prep_ms:.3f}, visibility kernel "
          f"{vis_ms:.3f}), reconstruct {total_ms:.3f}")

    from torch.profiler import ProfilerActivity, profile
    os.makedirs(args.out, exist_ok=True)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.runs):
            model.reconstruct(model, images, it)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report(prof, wall_us, args.runs, "runs", card, args.out,
           "recon_trace.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
