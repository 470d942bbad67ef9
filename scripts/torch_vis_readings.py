#!/usr/bin/env python3
"""What the tile visibility function asks of a kernel on the full-width
model's own posed meshes, on one CUDA card.

    python3 scripts/torch_vis_readings.py [--runs N] [--k1-smem B1,B2,...]
    python3 scripts/torch_vis_readings.py --v6 [--runs N]
        [--k3-split P1,P2,...] [--k3-smem B1,B2,...]
    python3 scripts/torch_vis_readings.py --k5 [--runs N]

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
  * the copy requests K1 (rows, ids, boxes) and K2 (rows, boxes) issue
    for the live sub-blocks;
  * K1's and K2's times (CUDA events: median of N single calls, and per
    call over 20 calls back to back), beside the function's bound
    (`chip_smoke.visibility_bound`), and with `--k1-smem`
    K1's at other shared-memory targets a block (`rasterize_cuda.K1_SMEM`,
    which sets the depth of its ring of staged sub-blocks);
  * the peak device memory of `prepare` for variants 3 and 4, above what
    was allocated before the call.

With `--v6` it reads variant 6's unit lists (`prepare(variant=6)`) and
K3 instead:

  * units per tile (`counts6`): max and mean, and the tiles with more than
    S (the overflow tiles, which K3 scans without skip or flags);
  * units per overflow tile: by vertex bbox (`counts6`) and by the union
    of their faces' cull boxes (`unit_boxes`), mean and max;
  * the dense tiles' live unit visits
    (`visibility_v6_reference(stats=)`), in all and on the busiest tile;
  * cull-box pairs on the dense tiles' live units and on the overflow
    tiles (every face's box clipped to the tile), in all and on the
    busiest tile;
  * the units K3 stages (the dense tiles' live units and the overflow
    tiles' units whose box meets the tile) and their bytes;
  * K3's time (median of N single calls; on all tiles also per call over
    20 calls back to back) on all tiles, on the dense tiles alone and on
    the overflow tiles alone (a copy of `counts6` with the other tiles'
    counts set to 0: a reading, never a path), beside the function's
    bound; with `--k3-split` and `--k3-smem`, both ways at other splits
    of an overflow tile over a cluster of blocks
    (`rasterize_cuda.K3_SPLIT`) and shared-memory targets
    (`rasterize_cuda.K3_SMEM`);
  * the peak device memory of `prepare` for variant 6.

With `--k5` it times the resolve-rows forward K5 instead, on the training
forward's own winner ids (`chip_smoke.train_scene`) with random float32
rows (10, F, 42), as `chip_smoke.py` holds it: single calls and back to
back, beside `torch.gather` with the permute to tile order and beside
`fill_` of a tensor of the output's size (the card's write rate). It uses
only `resolve_cuda.resolve_fwd`'s contract, so it also times a tree whose
K5 has another design.
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
from animals3d_tpu_torch.ops import kernels  # noqa: E402
from animals3d_tpu_torch.ops import rasterize_cuda as rc  # noqa: E402


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
    lists4 = (p4["table"], p4["bbase"], *lists[2:], p4["fbox"])
    k2 = chip_smoke.median_ms(
        lambda: rc.visibility_v4(*lists4, res, p4["nsub"]), runs)
    k1_b2b = chip_smoke.back_to_back_ms(
        lambda: rc.visibility(*lists, *box, res, nsub))
    k2_b2b = chip_smoke.back_to_back_ms(
        lambda: rc.visibility_v4(*lists4, res, p4["nsub"]))
    bytes_ms, ops_ms, _nbytes, _pairs = chip_smoke.visibility_bound(
        v_clip, faces, p3, res, stats["visits"], out)
    bytes4_ms, _o, _n, _p = chip_smoke.visibility_bound(
        v_clip, faces, p3, res, stats["visits"], out, run_ids=True)
    live = stats["visits"].shape[0]
    print(f"{name}: copy requests per render for the live sub-blocks "
          f"({live}): K1 {3 * live} (rows, ids, boxes), K2 {2 * live} "
          "(rows, boxes); loads of chunks skipped after staging add to "
          "both")
    print(f"{name}: K1 {k1:.4f} ms, K2 {k2:.4f} ms (median of {runs}; "
          f"back to back {k1_b2b:.4f} and {k2_b2b:.4f} ms a call); "
          f"bound {max(bytes_ms, ops_ms):.4f} ms (K2's, run bases for ids: "
          f"{max(bytes4_ms, ops_ms):.4f} ms); prepare peak variant 3 "
          f"{peak3 / 2**30:.3f} GiB, variant 4 {peak4 / 2**30:.3f} GiB; "
          f"card {card}")


def clipped_area(bx, tx0, ty0):
    """Pixels of each int64 box [x0, x1, y0, y1] (..., 4) inside the tile
    at (tx0, ty0), broadcast."""
    w = (torch.minimum(bx[..., 1], tx0 + rc.TILE_W - 1)
         - torch.maximum(bx[..., 0], tx0) + 1).clamp(min=0)
    h = (torch.minimum(bx[..., 3], ty0 + rc.TILE_H - 1)
         - torch.maximum(bx[..., 2], ty0) + 1).clamp(min=0)
    return w * h


def timed_with(name, value, fn, runs):
    """`fn`'s median time over single calls and its time per call back to
    back, with `rc.<name>` set to `value`."""
    default = getattr(rc, name)
    setattr(rc, name, value)
    try:
        return chip_smoke.median_ms(fn, runs), chip_smoke.back_to_back_ms(fn)
    finally:
        setattr(rc, name, default)


def v6_readings(name, scene, runs, card, k3_split, k3_smem):
    v_clip, _v_pos0, faces, _f_valid, res, _chunk = scene
    p6, peak6 = chip_smoke.prepare_peak(scene, 6)
    table, nsub, S = p6["table"], p6["nsub"], p6["S"]
    B, nch, _rows, chunk = table.shape
    sub = chunk // nsub
    height, width = res
    ntx = width // rc.TILE_W
    T = (height // rc.TILE_H) * ntx
    dev = table.device
    fbox = rc.cull_boxes(table, res)
    ubox = rc.unit_boxes(fbox, sub, res).long()
    fbox = fbox.long()
    tid = torch.arange(T, device=dev)
    tx0, ty0 = (tid % ntx) * rc.TILE_W, (tid // ntx) * rc.TILE_H
    counts6 = p6["counts6"]
    over = counts6 > S
    n_over = int(over.sum())
    # units whose cull-box union meets each tile, (B, T)
    by_box = (clipped_area(ubox[:, None], tx0[None, :, None],
                           ty0[None, :, None]) > 0).sum(-1)
    args6 = (table, p6["orig"], p6["units"], counts6, p6["zu"], res, nsub)
    stats = {}
    out = rc.visibility_v6_reference(*args6, stats=stats)
    visits = stats["visits"]
    b, t, u = visits.unbind(1)
    slots = (u * sub)[:, None] + torch.arange(sub, device=dev)
    area = clipped_area(fbox[b[:, None], slots], tx0[t][:, None],
                        ty0[t][:, None])
    dense_pairs = torch.zeros(B * T, dtype=torch.int64, device=dev)
    dense_pairs.index_add_(0, b * T + t, area.sum(1))
    dense_visits = torch.bincount(b * T + t, minlength=B * T)
    ob, ot = torch.nonzero(over, as_tuple=True)
    over_pairs = []
    for i in range(0, ob.numel(), 16):      # every face's box, 16 tiles a pass
        bo, to = ob[i:i + 16], ot[i:i + 16]
        over_pairs.append(clipped_area(fbox[bo], tx0[to][:, None],
                                       ty0[to][:, None]).sum(1))
    over_pairs = torch.cat(over_pairs) if over_pairs else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    # the units K3 stages: the dense tiles' live units whose box meets the
    # tile, and the overflow tiles' units by box; each a slot of the rows,
    # ids and face boxes
    staged = int(by_box[over].sum()) + int((clipped_area(
        ubox[b, u], tx0[t], ty0[t]) > 0).sum())
    slot_bytes = sub * (12 * 4 + 4 + 8)

    def mean_max(x):
        return (f"mean {float(x.float().mean()):.1f} max {int(x.max())}"
                if x.numel() else "none")
    print(f"v6[{name}]: S {S}, U {nch * nsub}; units per tile max "
          f"{int(counts6.max())} mean {float(counts6.float().mean()):.2f}; "
          f"overflow tiles {n_over} of {counts6.numel()}; units per "
          f"overflow tile by vertex bbox {mean_max(counts6[over])}, by "
          f"cull-box union {mean_max(by_box[over])}; dense tiles: live unit "
          f"visits {visits.shape[0]} (busiest tile "
          f"{int(dense_visits.max())}), cull-box pairs "
          f"{int(dense_pairs.sum())} (busiest tile "
          f"{int(dense_pairs.max())}); overflow tiles: cull-box pairs "
          f"{int(over_pairs.sum())} (busiest tile "
          f"{int(over_pairs.max()) if n_over else 0}); units staged "
          f"{staged} ({staged * slot_bytes / 1e6:.1f} MB of rows, ids and "
          "boxes)")
    def k3(c6):
        return lambda: rc.visibility_v6(*args6[:3], c6, args6[4], p6["fbox"],
                                        p6["ubox"], res, nsub)
    ms = chip_smoke.median_ms(k3(counts6), runs)
    ms_dense = chip_smoke.median_ms(
        k3(torch.where(over, 0, counts6).contiguous()), runs)
    ms_over = chip_smoke.median_ms(
        k3(torch.where(over, counts6, 0).contiguous()), runs)
    p3 = rc.prepare(*scene[:5], scene[5])
    stats3 = {}
    out3 = rc.visibility_reference(p3["table"], p3["orig"], p3["order"],
                                   p3["counts"], p3["masks"], p3["zlo"], res,
                                   p3["nsub"], stats=stats3)
    bytes_ms, ops_ms, _nbytes, _pairs = chip_smoke.visibility_bound(
        v_clip, faces, p3, res, stats3["visits"], out3)
    b2b = chip_smoke.back_to_back_ms(k3(counts6))
    print(f"v6[{name}]: K3 {ms:.4f} ms ({b2b:.4f} a call back to back), "
          f"dense tiles alone {ms_dense:.4f} "
          f"ms, overflow tiles alone {ms_over:.4f} ms (median of {runs}); "
          f"bound {max(bytes_ms, ops_ms):.4f} ms (K1's: the same function); "
          f"prepare peak variant 6 {peak6 / 2**30:.3f} GiB; outputs "
          f"{int((out[1] > 0).sum())} covered pixels; card {card}")
    for split in k3_split:
        one, many = timed_with("K3_SPLIT", split, k3(counts6), runs)
        print(f"v6[{name}]: K3 with overflow tiles split over {split} "
              f"block(s) {one:.4f} ms ({many:.4f} back to back)")
    for smem in k3_smem:
        one, many = timed_with("K3_SMEM", smem, k3(counts6), runs)
        print(f"v6[{name}]: K3 with {smem} bytes of shared memory a block "
              f"{one:.4f} ms ({many:.4f} back to back)")


def k5_readings(model, batch, runs, card):
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    fid, n_faces = chip_smoke.train_scene(model, batch)
    B, P = fid.shape
    H = model.out_image_size
    R = 3 * (4 + 9) + 3
    gen = torch.Generator(device=fid.device).manual_seed(chip_smoke.SEED)
    pf = torch.randn((B, n_faces, R), generator=gen, device=fid.device)
    sel = torch.clamp(fid.long() - 1, min=0)[..., None].expand(B, P, R)
    out = torch.empty((B, R, P), device=fid.device)
    calls = {"K5": lambda: rv.resolve_fwd(pf, fid, (H, H)),
             "torch.gather + permute": lambda: rv.to_tile_order(
                 torch.gather(pf, 1, sel), (H, H)).contiguous(),
             "fill_ of the output": lambda: out.fill_(0.0)}
    print("k5: " + ", ".join(
        f"{name} {chip_smoke.median_ms(fn, runs):.4f} ms single, "
        f"{chip_smoke.back_to_back_ms(fn):.4f} back to back"
        for name, fn in calls.items()) + f"; card {card}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--k1-smem", default="",
                    help="comma-separated shared-memory targets (bytes) at "
                         "which K1 is timed too")
    ap.add_argument("--v6", action="store_true",
                    help="read variant 6's unit lists and K3 instead")
    ap.add_argument("--k5", action="store_true",
                    help="time the resolve-rows forward K5 instead")
    ap.add_argument("--k3-split", default="",
                    help="comma-separated splits of an overflow tile at "
                         "which K3 is timed too (with --v6)")
    ap.add_argument("--k3-smem", default="",
                    help="comma-separated shared-memory targets (bytes) at "
                         "which K3 is timed too (with --v6)")
    args = ap.parse_args()
    k1_smem = [int(x) for x in args.k1_smem.split(",") if x]
    k3_split = [int(x) for x in args.k3_split.split(",") if x]
    k3_smem = [int(x) for x in args.k3_smem.split(",") if x]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    kernels.build()
    model, images, it, B, _H = chip_smoke.slice_phase()
    if args.k5:
        k5_readings(model, fake_batch(model, B, chip_smoke.SEED), args.runs,
                    card)
        return 0
    scenes = {"recon": chip_smoke.recon_scene(model, images, it),
              "train": chip_smoke.train_pose_scene(
                  model, fake_batch(model, B, chip_smoke.SEED))}
    with torch.no_grad():
        for name, scene in scenes.items():
            if args.v6:
                v6_readings(name, scene, args.runs, card, k3_split, k3_smem)
            else:
                readings(name, scene, args.runs, card, k1_smem)
    return 0


if __name__ == "__main__":
    sys.exit(main())
