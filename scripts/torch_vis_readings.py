#!/usr/bin/env python3
"""What the tile visibility function asks of a kernel on the full-width
model's own posed meshes, on one CUDA card.

    python3 scripts/torch_vis_readings.py [--runs N] [--k1-smem B1,B2,...]

Builds `train_magicpony_horse` at full width as `chip_smoke.py` does and,
for the meshes `reconstruct` rasterizes (`chip_smoke.recon_scene`) and
those of one training forward (`chip_smoke.train_pose_scene`), prints:

  * chunks per (image, 16x32 tile): max and mean of `counts`, and the
    chunks walked live (not skipped by the occlusion test);
  * live sub-block visits (`visibility_reference(stats=)`), in all and
    on the tile with the most;
  * cull-box pairs: over the live visits, the (face, pixel) pairs of each
    face's cull box (`cull_boxes`) clipped to the tile, the work of a
    kernel that tests each face on its box alone; in all, on the tile with
    the most, and the mean per tile;
  * K1's and K2's times (CUDA events: median of N single calls, and per
    call over 20 calls back to back), beside the function's bound (`chip_smoke.visibility_bound`), and with `--k1-smem`
    K1's at other shared-memory targets a block (`rasterize_cuda.K1_SMEM`,
    which sets the depth of its ring of staged sub-blocks);
  * the peak device memory of `prepare` for variants 3 and 4, above what
    was allocated before the call.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402  (the full-width setup and the timers)
from animals3d_tpu_torch.data.synth import fake_batch  # noqa: E402
from animals3d_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402


def back_to_back_ms(fn, n=20):
    """Device time per call of `fn` launched n times back to back (CUDA
    events around the loop): the host's wrapper time hides behind the
    card's work where the card is the slower."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def readings(name, scene, runs, card, k1_smem):
    v_clip, _v_pos0, faces, _f_valid, res, _chunk = scene
    p3, peak3 = chip_smoke.prepare_peak(scene, 3)
    p4, peak4 = chip_smoke.prepare_peak(scene, 4)
    nsub = p3["nsub"]
    lists = (p3["table"], p3["orig"], p3["order"], p3["counts"],
             p3["masks"], p3["zlo"])
    # a tree whose `prepare` gives variant 3 no boxes has a K1 that takes
    # none
    box = (p3["fbox"],) if "fbox" in p3 else ()
    stats = {}
    out = rc.visibility_reference(*lists, res, nsub, stats=stats)
    chip_smoke.walk_readings(name, p3, stats["visits"], res)
    k1 = chip_smoke.median_ms(lambda: rc.visibility(*lists, *box, res, nsub),
                              runs)
    for smem in k1_smem:
        # K1 with another shared-memory target, so another ring depth
        default, rc.K1_SMEM = rc.K1_SMEM, smem
        try:
            ms = chip_smoke.median_ms(
                lambda: rc.visibility(*lists, *box, res, nsub), runs)
        finally:
            rc.K1_SMEM = default
        print(f"{name}: K1 with {smem} bytes of shared memory a block "
              f"{ms:.4f} ms")
    k2 = chip_smoke.median_ms(
        lambda: rc.visibility_v4(*lists, p4["fbox"], res, p4["nsub"]), runs)
    k1_b2b = back_to_back_ms(lambda: rc.visibility(*lists, *box, res, nsub))
    k2_b2b = back_to_back_ms(
        lambda: rc.visibility_v4(*lists, p4["fbox"], res, p4["nsub"]))
    bytes_ms, ops_ms, _nbytes, _pairs = chip_smoke.visibility_bound(
        v_clip, faces, p3, res, stats["visits"], out)
    print(f"{name}: K1 {k1:.4f} ms, K2 {k2:.4f} ms (median of {runs}; "
          f"back to back {k1_b2b:.4f} and {k2_b2b:.4f} ms a call); "
          f"bound {max(bytes_ms, ops_ms):.4f} ms; prepare peak variant 3 "
          f"{peak3 / 2**30:.3f} GiB, variant 4 {peak4 / 2**30:.3f} GiB; "
          f"card {card}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--k1-smem", default="",
                    help="comma-separated shared-memory targets (bytes) at "
                         "which K1 is timed too")
    args = ap.parse_args()
    k1_smem = [int(x) for x in args.k1_smem.split(",") if x]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    rc.build()
    model, images, it, B, _H = chip_smoke.slice_phase()
    scenes = {"recon": chip_smoke.recon_scene(model, images, it),
              "train": chip_smoke.train_pose_scene(
                  model, fake_batch(model, B, chip_smoke.SEED))}
    with torch.no_grad():
        for name, scene in scenes.items():
            readings(name, scene, args.runs, card, k1_smem)
    return 0


if __name__ == "__main__":
    sys.exit(main())
