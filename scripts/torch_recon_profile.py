#!/usr/bin/env python3
"""Where the time of the port's single-image reconstruction goes, on one
CUDA card.

    python3 scripts/torch_recon_profile.py [--runs N] [--out DIR]

Builds `train_magicpony_horse` at full width (iter-50000 phase: grid 128,
articulation on; batch 10 at 256², dino_vits8, bf16 compute, weights from
`init_params(0)`) and times, with CUDA events (median of N runs after a
warm-up), the three stages of `reconstruct`: netBase (SDF sweep + marching
tets), netInstance (ViT, pose, articulation, skinning) and the render of
the input view, and inside the render the visibility kernel. Then traces
N whole `reconstruct` runs with `torch.profiler` and prints the device's
busy share of the wall time and the CUDA kernels with the most device
time. Writes the chrome trace to DIR (default `results/torch_profile/`).
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


def main() -> int:
    ap = argparse.ArgumentParser()
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
    model, images, it, _B, H = chip_smoke.slice_phase()
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
            v_clip, shape.v_pos[0], shape.t_pos_idx, shape.f_valid, (H, H)),
            args.runs)
        vis_args = (prep["table"], prep["orig"], prep["order"],
                    prep["counts"], prep["masks"], prep["zlo"], (H, H),
                    prep["nsub"])
        _v, vis_ms = timed(lambda: rc.visibility(*vis_args), args.runs)
        _t, total_ms = timed(lambda: model.reconstruct(model, images, it),
                             args.runs)
    print(f"card: {card}")
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
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:                  # union of the kernels' intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    print(f"profile: {args.runs} runs, wall {wall_us / 1e3:.3f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({busy / wall_us * 100:.1f}%), "
          f"{len(events)} device events; card {card}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    prof.export_chrome_trace(os.path.join(args.out, "recon_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
