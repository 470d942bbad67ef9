#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`animals3d_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in this order, each fatal on failure:
  1. build: compile the hand-written CUDA kernels from `csrc/` with one
     nvcc call and print the compiler's register / shared-memory report;
  2. reference: single-image reconstruction of a small float32 model on
     the card against the same model on the CPU (where the kernels run
     their plain versions), then one training step of a small float32
     model (netSDF 256 wide, so the fused sweep is the path compared) on
     the card against the CPU from the same weights, batch and noise:
     loss, every parameter's gradient and the parameters after the step —
     once on the default render path and once on `raster_variant=6,
     resolve_rows="kernel"` (K3 and K5 on the card);
  3. kernels: run each kernel against its plain PyTorch version on the
     card — the tile visibility kernels K1, K2 (variant 4) and K3 (variant
     6) on a random scene, the exact-z depth-stack scene, the prior mesh of
     the full-width model posed by 10 cameras at 256² (face capacity
     196,608), the full-width recon's own posed meshes (the inputs
     `reconstruct` rasterizes) and the training forward's own posed
     meshes: K1 and K2 against `visibility_reference` and K2 against K1
     (z, face_id and chunk flags bit for bit), K3 against
     `visibility_v6_reference` (z, face_id, slot flags) and its z and
     face_id against K1's, also with the unit lists capped at 2 (most
     tiles overflow), and the cull kernel's face boxes (both its
     instantiations: the face boxes alone, and with the unit boxes of
     variant 6 in the same launch) against `cull_boxes` and its unit boxes
     against `unit_boxes` (bit for bit). Times the
     three and their plain versions (CUDA events, medians) on the last
     three scenes, K1 and K2 also back to back in turns, computes the
     bound from this run's inputs, and reads the walk's work (chunks per
     tile, live sub-block visits and the copy requests K1 and K2 issue
     for them, cull-box pairs) and the peak memory of `prepare` for
     variants 3, 4 and 6 there; times both instantiations of the cull
     kernel and their plain versions on the recon scene, single calls and
     20 calls in a CUDA graph (the device's time alone); the `kernels`
     line reports the recon scene. Then
     the fused netSDF sweep, forward and backward, against its plain
     versions at the full-width shape (the embedded jittered 129³ lattice,
     weights of `init_params(0)`) and at a ragged small N, in bf16 and
     float32, both bit-identical across two calls, the bf16 forward also
     launched alone with a prebuilt weight stream (its rate, its share of
     the bound, the stream's build time), the bf16 backward's three passes
     (chain, weight-gradient, reduce) timed one at a time with its chunk
     rows, scratch bytes and device launches per call, and the unfused
     `get_sdf` forward and forward + backward for orientation; the resolve
     backward against its plain version on the
     training step's own winner ids with a random cotangent (10, 65,536,
     42) and on the depth-stack scene, where one face collects hundreds of
     pixels; and the resolve-rows forward K5 against its plain version and
     `torch.gather` on the training step's own winner ids (with the rows
     it reads, one per run of a tile row's pixels with one winner, and
     its time back to back); each with its
     time, its plain version's, its bound and, where one exists, a library
     call's;
  4. paths, at the full width of `train_magicpony_horse` (iter-50000
     phase: grid 128, articulation on; batch 10 at 256², dino_vits8, bf16
     compute; random weights from `init_params(0)`), each with the launch
     counters set to 0 just before it and read just after it (each kernel
     of the path once per step or render, no other kernel):
     `train_step` on the default path (1 warm-up and 5 timed steps: the
     cull kernel, K1, K6, K7, K4) and on `raster_variant=6,
     resolve_rows="kernel"` (1 + 3: the cull kernel with the unit boxes,
     K3, K5, K4, K6, K7), the loss on the
     batch with fixed draws falling; `reconstruct` on the default path
     (1 + 5: the cull kernel, K1), with `raster_variant=4` (1 + 3: the
     cull kernel, K2; every render's z and face_id equal to K1's on the
     same posed meshes) and with `raster_variant=6, resolve_rows="kernel"`
     (1 + 3: the cull kernel with the unit boxes, K3, K5; the images equal
     to the default path's within 1e-6).

Prints a `kernels` JSON line (all nine kernel entries, each with its
status: ported, redesigned or fused, and in which PR; `unit_boxes` is the
cull kernel's instantiation that also writes the unit boxes; `launches`
is the count on the path that drives the kernel — `recon_v4` for K2,
`train_v6_kernel_rows` for the unit boxes, K3 and K5, the default
training path for the others — and `launches_by_path` the counts on
every path), the card's name
and power limit, and as the last line `{"ok": true, "device": {...}}`.
Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

F32_PEAK_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
F64_PEAK_FLOPS = 34e12        # H100 SXM float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_PEAK_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
SEED = 0
TIMED_RUNS = 5
WARMUP_RUNS = 1
KERNEL_RUNS = 10
TRAIN_IT = 50000
SMALL_OVERRIDES = [
    "dataset.in_image_size=64",
    "dataset.out_image_size=64",
    "model.cfg_predictor_base.cfg_shape.grid_res=16",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=16",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=32",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
]


# the reference model for training: the netSDF at the width the fused
# sweep covers, two layers deep, on a grid of 16
TRAIN_SMALL_OVERRIDES = [o for o in SMALL_OVERRIDES
                         if "cfg_shape.hidden_size" not in o] + [
    "model.cfg_predictor_base.cfg_shape.hidden_size=256",
    "model.cfg_predictor_base.cfg_dino.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "dataset.dino_feature_dim=4",
]


# the training reference's gradient bounds, |gpu - cpu| over the leaf's norm
REF_GRAD_TOL = 2e-3
REF_NOISY_TOL = 2e-2
REF_NOISY_LEAVES = ("netInstance.netTexture.", "netBase.netDINO.in_layer.",
                    "netBase.netDINO.mlp.layer_0.")

# |recon image of variant 6 + kernel rows - default| away from the pixels
# whose winner differs: the two paths compute the same function, and the
# default path run twice differs by 1.2e-7 to 1.8e-7 on an H100
IMAGE_TOL = 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, runs: int) -> list:
    """Per-run device times (ms) of `fn()` with CUDA events."""
    import torch
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


# ---------------------------------------------------------------------------
# scenes for the visibility kernel
# ---------------------------------------------------------------------------

def random_scene(rng):
    """4 images of 6,000 small random triangles at 128², chunk 256."""
    B, Fn, res = 4, 6000, (128, 128)
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = (ctr + rng.uniform(-0.08, 0.08, (B, Fn, 3, 3))).reshape(B, 3 * Fn, 3)
    w = rng.uniform(2, 4, (B, 3 * Fn, 1))
    v_clip = np.concatenate([v * w, w], -1).astype(np.float32)
    v_pos0 = rng.normal(size=(3 * Fn, 3)).astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    f_valid = rng.uniform(size=Fn) > 0.05
    return v_clip, v_pos0, faces, f_valid, res, 256


def depth_stack_scene():
    """8 full-screen quads stacked in z plus an exact-z duplicate of the
    front quad (`tests/test_rasterize_pallas.py:250`): every chunk behind
    the front one is skippable, and the tie goes to the smallest id."""
    quads, faces = [], []
    depths = [1.0, 1.0] + [1.0 + 0.2 * i for i in range(1, 8)]
    for qi, z in enumerate(depths):
        i0 = 4 * qi
        s = 1.0 if qi != 3 else 0.3
        quads += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        faces += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    v = np.asarray(quads, np.float32)
    v_clip = np.concatenate([v * 2.0, np.full((len(v), 1), 2.0)], -1)[None]
    return (v_clip.astype(np.float32), v, np.asarray(faces),
            np.ones(len(faces), bool), (32, 32), 2)


def depth_stack_copies_scene():
    """The depth stack with each face repeated 16 times in a row, for
    variant 4 (sub-blocks of a multiple of 32 faces): chunks of 32 faces
    hold one quad each (nsub 1), and the copies tie exactly in z."""
    v_clip, v, faces, f_valid, res, _chunk = depth_stack_scene()
    faces = np.repeat(faces.reshape(-1, 2, 3), 16, 0).reshape(9, 16, 2, 3) \
        .transpose(0, 2, 1, 3).reshape(-1, 3)
    return v_clip, v, faces, np.ones(len(faces), bool), res, 32


def posed_prior_scene(model, n_views: int = 10, res: int = 256):
    """The model's prior mesh seen by `n_views` cameras on a circle around
    it, at the model's camera distance and field of view."""
    import torch
    from animals3d_tpu_torch.render.camera import xfm_points
    phase = model.phase_for_iter(50000, is_training=False)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    with torch.no_grad():
        prior, _sdf = model.forward_base(grid, v_cap, f_cap)
    ang = torch.arange(n_views, dtype=torch.float32) * (2 * np.pi / n_views)
    c, s, o, z = torch.cos(ang), torch.sin(ang), torch.ones_like(ang), \
        torch.zeros_like(ang)
    rot = torch.stack([c, z, s, z, o, z, -s, z, c], -1)
    pose = torch.cat([rot, torch.zeros((n_views, 3))], -1).to(model.device)
    mvp, _w2c, _campos = model.netInstance.get_camera_extrinsics_from_pose(
        pose)
    v_pos = prior.v_pos.expand(n_views, *prior.v_pos.shape[1:])
    v_clip = xfm_points(v_pos, mvp).contiguous()
    return (v_clip, prior.v_pos[0], prior.t_pos_idx, prior.f_valid,
            (res, res), 1024)


def recon_scene(model, images, it):
    """The posed meshes the full-width `reconstruct` rasterizes: the
    instance predictor's output seen by its own cameras."""
    import torch
    from animals3d_tpu_torch.render.camera import xfm_points
    phase = model.phase_for_iter(it, is_training=False)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    with torch.no_grad():
        prior, _sdf = model.forward_base(grid, v_cap, f_cap)
        out = model.instance_forward(images, prior, it, phase)
    shape, mvp = out[0], out[3]
    v_clip = xfm_points(shape.v_pos, mvp).contiguous()
    H = images.shape[-1]
    return (v_clip, shape.v_pos[0], shape.t_pos_idx, shape.f_valid,
            (H, H), 1024)


def visibility_bound(v_clip, faces, prep, res, visits, outputs,
                     run_ids=False):
    """Least time (ms) the H100 needs for the visibility function on these
    inputs: (bytes ms, operations ms, bytes, live pairs).

    Operations: 12 float32 operations (3 edge functions) per live
    (face, pixel) pair, a pixel centre inside the screen bbox of a valid
    face of a live (tile, chunk) pair — one the occlusion skip keeps, as
    `visits` from the plain version records. Bytes: the coefficients and
    original ids of the live sub-blocks, each read once, the tiles' chunk
    counts and z-mins, the list entries each tile walks, and the outputs
    written once. With `run_ids` (K2) the ids are the live sub-blocks' run
    bases, one int32 a run of 32 faces, in place of one a face."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    height, width = res
    table, orig = prep["table"], prep["orig"].long()
    B, nch, _rows, chunk = table.shape
    sub = chunk // prep["nsub"]
    Fn = faces.shape[0]
    valid = (table[:, :, :7] != 0).any(2).reshape(B, -1) \
        & (orig < Fn)[None]                              # (B, Fp)
    fv = v_clip[:, faces.long()[orig.clamp(max=Fn - 1)]]  # (B, Fp, 3, 4)
    sx = (fv[..., 0] / fv[..., 3] + 1.0) * (0.5 * width)
    sy = (fv[..., 1] / fv[..., 3] + 1.0) * (0.5 * height)
    b, t, cid, g = visits.unbind(1)
    slots = (cid * chunk + g * sub)[:, None] + torch.arange(
        sub, device=visits.device)                       # (n, sub)
    th, tw = rc.TILE_H, rc.TILE_W
    ntx = width // tw

    def centres(lo, hi, origin, size):
        # pixel centres origin + j + 0.5, 0 <= j < size, inside [lo, hi]
        j0 = torch.clamp(torch.ceil(lo - origin - 0.5), min=0)
        j1 = torch.clamp(torch.floor(hi - origin - 0.5), max=size - 1)
        return torch.clamp(j1 - j0 + 1, min=0)
    bb = b[:, None]
    nx = centres(sx.amin(-1)[bb, slots], sx.amax(-1)[bb, slots],
                 ((t % ntx) * tw).float()[:, None], tw)
    ny = centres(sy.amin(-1)[bb, slots], sy.amax(-1)[bb, slots],
                 ((t // ntx) * th).float()[:, None], th)
    pairs = int((nx * ny * valid[bb, slots]).sum())
    live = torch.unique(visits[:, [0, 2, 3]], dim=0)      # (image, chunk, g)
    ids = torch.unique(live[:, 1:], dim=0)                # (chunk, g)
    walked = int(prep["counts"].sum())
    id_words = sub // 32 if run_ids else sub
    nbytes = (live.shape[0] * sub * 12 * 4 + ids.shape[0] * id_words * 4
              + walked * 2 * 4
              + sum(prep[k].numel() * 4 for k in ("counts", "zlo"))
              + sum(a.numel() * a.element_size() for a in outputs))
    return (nbytes / HBM_BYTES_PER_S * 1e3, 12 * pairs / F32_PEAK_FLOPS * 1e3,
            nbytes, pairs)


# The arithmetic per face that `cull_boxes`' boxes need, counted from the
# function, not from a compiler's output: 102 float64 products, sums,
# minima and maxima (7 an edge for its padded constant; 23 a corner for
# its determinant, x, y, both pads and the four bounds; 8 for the minima
# and maxima over the corners; 4 for the half-pixel shifts) and 3
# correctly rounded reciprocals, one a corner, each at the length of its
# fast path (5 DFMA after a seed, the sequence of `__drcp_rn`); and 9
# float32-to-float64 conversions, 4 float64-to-integer ones and the 3
# reciprocal seeds (MUFU.RCP64H). Compares and tests are left out. An
# H100 SM completes 64 float64 instructions a clock (an FMA is two of
# F64_PEAK_FLOPS' operations) and 16 conversions or seeds.
CULL_F64_PER_FACE = 102 + 3 * 5
CULL_CONV_PER_FACE = 9 + 4 + 3
F64_INSTR_PER_S = F64_PEAK_FLOPS / 2
CONV64_PER_S = F64_INSTR_PER_S / 4


def walk_readings(name, prep, visits, res):
    """What the tile walk asks of a kernel on a prep and the live visits of
    `visibility_reference(stats=)`: chunks per (image, tile), the (tile,
    chunk) pairs walked and live (not skipped by the occlusion test), live
    sub-block visits, and cull-box pairs — over the live visits, the
    (face, pixel) pairs of each face's cull box clipped to the tile, the
    work of a kernel that tests each face on its box alone — in all, on
    the busiest tile and per tile on average; prints them."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    height, width = res
    ntx = width // rc.TILE_W
    T = (height // rc.TILE_H) * ntx
    chunk = prep["table"].shape[-1]
    sub = chunk // prep["nsub"]
    B = prep["table"].shape[0]
    fbox = rc.cull_boxes(prep["table"], res).long()
    b, t, cid, g = visits.unbind(1)
    slots = (cid * chunk + g * sub)[:, None] + torch.arange(
        sub, device=visits.device)
    bx = fbox[b[:, None], slots]                          # (n, sub, 4)
    tx0 = ((t % ntx) * rc.TILE_W)[:, None]
    ty0 = ((t // ntx) * rc.TILE_H)[:, None]
    w = (torch.minimum(bx[..., 1], tx0 + rc.TILE_W - 1)
         - torch.maximum(bx[..., 0], tx0) + 1).clamp(min=0)
    h = (torch.minimum(bx[..., 3], ty0 + rc.TILE_H - 1)
         - torch.maximum(bx[..., 2], ty0) + 1).clamp(min=0)
    area = w * h
    pairs = area.sum(1)                                   # (n,)
    tile = b * T + t
    per_tile = torch.zeros(B * T, dtype=torch.int64, device=visits.device)
    per_tile.index_add_(0, tile, pairs)
    visits_tile = torch.bincount(tile, minlength=B * T)
    live = torch.unique(visits[:, :3], dim=0)
    live_tile = torch.bincount(live[:, 0] * T + live[:, 1], minlength=B * T)
    counts = prep["counts"]
    print(f"walk[{name}]: chunks per tile max {int(counts.max())} mean "
          f"{float(counts.float().mean()):.2f}; (tile, chunk) pairs walked "
          f"{int(counts.sum())}, live {live.shape[0]} (busiest tile "
          f"{int(live_tile.max())}); live sub-block visits "
          f"{visits.shape[0]} (busiest tile {int(visits_tile.max())}, mean "
          f"{visits.shape[0] / (B * T):.2f}); cull-box pairs "
          f"{int(pairs.sum())} (busiest tile {int(per_tile.max())}, mean "
          f"{float(per_tile.float().mean()):.1f}) from "
          f"{int((area > 0).sum())} faces whose box meets the tile (over 32 "
          f"pixels {int((area > 32).sum())}, over 128 "
          f"{int((area > 128).sum())}), of {visits.shape[0] * sub} faces "
          "visited")


def prepare_peak(scene, variant):
    """`rc.prepare` of `scene` for `variant` and its peak device memory
    (bytes) above what was allocated before the call."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    v_clip, v_pos0, faces, f_valid, res, chunk = scene
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prep = rc.prepare(v_clip, v_pos0, faces, f_valid, res, chunk,
                      variant=variant)
    torch.cuda.synchronize()
    return prep, torch.cuda.max_memory_allocated() - base


def cull_bound(table, fbox, ubox=None):
    """(bytes ms, operations ms, bytes) of the cull kernel on `table`: the
    9 edge rows read once, the face boxes (and the unit boxes) written
    once; the float64 instructions and the 64-bit conversions per face
    (`CULL_F64_PER_FACE`, `CULL_CONV_PER_FACE`) at the card's rates for
    them, the two added."""
    faces = fbox.shape[0] * fbox.shape[1]
    nbytes = table.numel() // 12 * 9 * 4 + fbox.numel() * 2 \
        + (ubox.numel() * 2 if ubox is not None else 0)
    ops_ms = (CULL_F64_PER_FACE * faces / F64_INSTR_PER_S
              + CULL_CONV_PER_FACE * faces / CONV64_PER_S) * 1e3
    return nbytes / HBM_BYTES_PER_S * 1e3, ops_ms, nbytes


def cull_entry(prep, res, units=False, scene="recon"):
    """The cull kernel on a prep's table against its plain versions (bit
    for bit), timed beside them: a single call, and the device's time alone
    (20 calls in a CUDA graph); prints them under `scene` and returns its
    `kernels` entry. units: the fused launch (`cull_units`: the face boxes
    and variant 6's unit boxes) against `cull_boxes` and `unit_boxes`, else
    the face boxes alone (`cull`) against `cull_boxes`."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    table = prep["table"]
    sub = table.shape[-1] // prep["nsub"]

    def plain():
        boxes = rc.cull_boxes(table, res)
        return (boxes, rc.unit_boxes(boxes, sub, res)) if units else (boxes,)
    kernel = (lambda: rc.cull_units(table, res, sub)) if units \
        else (lambda: (rc.cull(table, res),))
    got = kernel()
    torch.cuda.synchronize()
    same_outputs("cull kernel", got, plain(), ("boxes", "units"))
    ms = median_ms(kernel)
    dev_ms = graph_ms(kernel)
    plain_ms = median_ms(plain, 3)
    bytes_ms, ops_ms, nbytes = cull_bound(table, *got)
    bound = max(bytes_ms, ops_ms)
    name = "unit_boxes" if units else "cull_boxes"
    counts = " and ".join(str(b.shape[0] * b.shape[1]) for b in got)
    print(f"{name}[{scene}]: {counts} (image, face or unit) boxes identical "
          f"to the plain versions; kernel {ms:.4f} ms "
          f"single, {dev_ms:.4f} ms device alone, plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms (bytes {nbytes} -> {bytes_ms:.4f} ms; "
          f"float64 instructions and conversions -> {ops_ms:.4f} ms), "
          f"device/bound {dev_ms / bound:.1f}x")
    e = kernel_entry(
        name, "cull_boxes.cu",
        "rasterize_pallas.py:837" if units else "rasterize_pallas.py:960",
        "fused into the cull kernel, PR 10 (new, PR 8)" if units
        else "redesigned, PR 10 (new, PR 7)", 0.0, ms, plain_ms, bytes_ms,
        ops_ms)
    e["graph_ms"] = dev_ms
    return e


def kernel_entry(name, source, replaces, status, err, ms, plain_ms,
                 bytes_ms, ops_ms, library_ms=None):
    return {"name": name, "route": "cuda",
            "source": "animals3d_tpu_torch/csrc/" + source,
            "replaces": "animals3d_tpu/ops/" + replaces,
            "status": status, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
            "library_ms": library_ms}


def same_outputs(name, got, want, what=("z", "face_id", "flags")):
    """Each output of `got` equal to `want`'s (face_id and flags bit for
    bit, z as float32 values); returns max |z - z_want|."""
    import torch
    for label, a, b in zip(what, got, want):
        if not torch.equal(a, b):
            diff = int((a != b).sum())
            raise AssertionError(f"{name}: {label} differs at {diff} "
                                 "entries")
    return float((got[0] - want[0]).abs().max())


def v6_against_k1(name, got, k1, prep):
    """Variant 6's z and face_id against K1's on the same inputs: identical
    but at pixels where the nearer of the two winners (lexicographic in
    (z, id), background last) is a face that the other kernel could not
    reach, for one of two reasons of the float32 formulation:
      * skip: its quantized depth lies below the quantized z-min of its
        unit. The z-min is the least vertex depth of the unit's faces; the
        plane equation's rounding can put a face's depth at a pixel below
        it, and then the occlusion skip is not conservative for that face
        (K1 skips per chunk, variant 6 per unit: they may skip different
        faces there);
      * scan: the tile has more units than list slots, so variant 6 scans
        every sub-block with no bbox mask, and the face's sub-block bbox
        misses the tile: the face's rounded edge functions accept a pixel
        its vertex bbox leaves out (a face a fraction of a pixel across),
        which K1's sub-block masks never offer it.
    The JAX package's kernels share both (its v6 and its v3's list-overflow
    scan run without masks). Returns (pixels by reason, mask of them)."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    (za, fa), (zb, fb) = got[:2], k1[:2]
    diff = (fa != fb) | (za != zb)
    if not bool(diff.any()):
        return {"skip": 0, "scan": 0}, diff
    b, y, x = torch.nonzero(diff).unbind(1)
    inf = torch.full_like(za[diff], float("inf"))
    ea = torch.where(fa[diff] > 0, za[diff], inf)
    eb = torch.where(fb[diff] > 0, zb[diff], inf)
    a_first = (ea < eb) | ((ea == eb) & (fa[diff] < fb[diff]))
    z = torch.where(a_first, ea, eb)
    f = torch.where(a_first, fa[diff], fb[diff]).long()
    orig = prep["orig"].long()
    slot = torch.empty_like(orig)
    slot[orig] = torch.arange(orig.numel(), device=orig.device)
    nsub = prep["nsub"]
    unit = slot[(f - 1).clamp(min=0)] // (prep["table"].shape[-1] // nsub)
    skip = (f > 0) & (rc._zq(z) < prep["zu"][b, unit])
    t = (y // rc.TILE_H) * (za.shape[-1] // rc.TILE_W) + x // rc.TILE_W
    bit = (prep["masks"][b, t, unit // nsub] >> (unit % nsub)) & 1
    scan = (f > 0) & (prep["counts6"][b, t] > prep["S"]) & (bit == 0)
    if not bool((skip | scan).all()):
        bad = torch.nonzero(~(skip | scan))[:, 0]
        for i in bad[:8].tolist():
            print(f"{name}: pixel {(int(b[i]), int(y[i]), int(x[i]))}: "
                  f"variant 6 ({float(za[diff][i])!r}, {int(fa[diff][i])}), "
                  f"K1 ({float(zb[diff][i])!r}, {int(fb[diff][i])}), unit "
                  f"{int(unit[i])} z-min {int(prep['zu'][b[i], unit[i]])}, "
                  f"zq {int(rc._zq(z[i:i + 1]))}, tile {int(t[i])} units "
                  f"{int(prep['counts6'][b[i], t[i]])}, mask bit "
                  f"{int(bit[i])}")
        raise AssertionError(f"{name}: {int((~(skip | scan)).sum())} of "
                             f"{int(diff.sum())} pixels differ from K1 for "
                             "another reason")
    return {"skip": int(skip.sum()), "scan": int((scan & ~skip).sum())}, diff


def visibility_phase(model, images, it, device, batch):
    """K1 against its plain version on the five scenes, K2 against the same
    plain version and against K1, K3 against its plain version (and its z
    and face_id against K1's), each bit for bit; a second K3 pass with the
    unit lists capped at 2 runs its overflow walk on most tiles; the face
    boxes of every scene (from both instantiations of the cull kernel)
    against `cull_boxes`, the unit boxes against `unit_boxes`. On the
    three full-width scenes the kernels are timed and bounded, with the
    work the walk offers (chunks per tile, live sub-block visits, the
    faces' cull-box pairs) and the peak memory of `prepare` for variants
    3, 4 and 6. Returns the `kernels` entries of the cull kernel's two
    instantiations (`cull_boxes`, and `unit_boxes` for the one that also
    writes the unit boxes), K1, K2 and K3, timed and bounded on the recon
    scene (K2's and K3's bound is K1's: the same function on the same
    inputs), K1's, K2's and K3's with their time on the training poses."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    rng = np.random.default_rng(SEED)
    scenes = {"random": random_scene(rng),
              "depth_stack": depth_stack_scene(),
              "posed_prior": posed_prior_scene(model),
              "recon": recon_scene(model, images, it),
              "train": train_pose_scene(model, batch)}
    full_width = ("posed_prior", "recon", "train")
    # (chunk, nsub) of variants 4 and 6 where a scene's own do not run them
    v4_scene = {"depth_stack": depth_stack_copies_scene()}
    v6_nsub = {"depth_stack": 2}
    entries = {}
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)

    def prep_of(scene, **kw):
        v_clip, v_pos0, faces, f_valid, res, chunk = scene
        return rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                          t(f_valid, torch.bool), res, chunk, **kw)

    def k1(p, res):
        return rc.visibility(p["table"], p["orig"], p["order"], p["counts"],
                             p["masks"], p["zlo"], p["fbox"], res, p["nsub"])

    def k2(p, res):
        return rc.visibility_v4(p["table"], p["bbase"], p["order"],
                                p["counts"], p["masks"], p["zlo"], p["fbox"],
                                res, p["nsub"])

    for name, scene in scenes.items():
        v_clip, v_pos0, faces, f_valid, res, chunk = scene
        v_clip, faces = t(v_clip), t(faces, torch.int64)
        prep = prep_of(scene)
        same_outputs(f"cull kernel {name}", (prep["fbox"],),
                     (rc.cull_boxes(prep["table"], res),), ("boxes",))
        args = (prep["table"], prep["orig"], prep["order"], prep["counts"],
                prep["masks"], prep["zlo"], res, prep["nsub"])
        out1 = k1(prep, res)
        torch.cuda.synchronize()
        stats = {}
        ref1 = rc.visibility_reference(*args, stats=stats)
        err = same_outputs(f"K1 {name}", out1, ref1)
        z, fid, flags = out1
        covered = int((fid > 0).sum())
        visits = stats["visits"]
        print(f"visibility[{name}]: B={fid.shape[0]} res={res} "
              f"faces={faces.shape[0]} chunk={chunk} covered_px={covered} "
              f"live_subblock_visits={visits.shape[0]}: K1's z, face_id and "
              "flags identical to the plain version; cull boxes identical "
              "to `cull_boxes`")
        if name in full_width and covered == 0:
            raise AssertionError(f"{name}: the mesh covers no pixel")

        # K2: its plain version is K1's; held to both on the same inputs
        p4 = prep_of(v4_scene.get(name, scene), nsub=1 if name in v4_scene
                     else rc.NSUB, variant=4)
        args4 = (p4["table"], p4["orig"], p4["order"], p4["counts"],
                 p4["masks"], p4["zlo"], res, p4["nsub"])
        out2 = k2(p4, res)
        torch.cuda.synchronize()
        err2 = same_outputs(f"K2 {name}", out2, rc.visibility_reference(*args4))
        same_outputs(f"K2 vs K1 {name}", out2, k1(p4, res))
        print(f"raster_vis_v4[{name}]: chunk {p4['table'].shape[-1]} nsub "
              f"{p4['nsub']}: z, face_id and flags identical to the plain "
              "version and to K1")

        # K3 at the cap of 128 and at 2 (most tiles overflow)
        for cap in (128, 2):
            p6 = prep_of(scene, nsub=v6_nsub.get(name, rc.NSUB), variant=6,
                         v6_cap=cap)
            sub6 = p6["table"].shape[-1] // p6["nsub"]
            want6 = rc.cull_boxes(p6["table"], res)
            same_outputs(f"fused cull kernel {name}",
                         (p6["fbox"], p6["ubox"]),
                         (want6, rc.unit_boxes(want6, sub6, res)),
                         ("boxes", "units"))
            args6 = (p6["table"], p6["orig"], p6["units"], p6["counts6"],
                     p6["zu"], res, p6["nsub"])
            out3 = rc.visibility_v6(*args6[:5], p6["fbox"], p6["ubox"], res,
                                    p6["nsub"])
            torch.cuda.synchronize()
            ref3 = rc.visibility_v6_reference(*args6)
            err3 = same_outputs(f"K3 {name} cap {cap}", out3, ref3,
                                ("z", "face_id", "slot flags"))
            cf = rc.chunk_flags_v6(out3[2], p6["units"], p6["counts6"],
                                   p6["masks"], p6["nsub"])
            if not torch.equal(cf, rc.chunk_flags_v6(
                    ref3[2], p6["units"], p6["counts6"], p6["masks"],
                    p6["nsub"])):
                raise AssertionError(f"K3 {name} cap {cap}: chunk flags")
            out1_6 = k1(p6, res)
            n_k1, _d = v6_against_k1(f"K3 vs K1 {name} cap {cap}", out3,
                                     out1_6, p6)
            n_k1 = f"{n_k1['skip']} (skip) + {n_k1['scan']} (scan)"
            over = int((p6["counts6"] > p6["S"]).sum())
            print(f"raster_vis_v6[{name}, cap {cap}]: S {p6['S']}, units per "
                  f"tile max {int(p6['counts6'].max())} mean "
                  f"{float(p6['counts6'].float().mean()):.1f}, overflow tiles "
                  f"{over} of {p6['counts6'].numel()}; z, face_id and slot "
                  "flags identical to the plain version, unit boxes to "
                  "`unit_boxes`; z and face_id identical to K1's but at "
                  f"{n_k1} of {fid.numel()} pixels (`v6_against_k1`)")
        if name not in full_width:
            continue
        ms = median_ms(lambda: k1(prep, res), TIMED_RUNS)
        ms4 = median_ms(lambda: k2(p4, res), TIMED_RUNS)
        # back to back, each twice in turns (K1, K2, K2, K1): the host's
        # wrapper time hides behind the card's work
        b2b = [back_to_back_ms(lambda: k1(prep, res)),
               back_to_back_ms(lambda: k2(p4, res)),
               back_to_back_ms(lambda: k2(p4, res)),
               back_to_back_ms(lambda: k1(prep, res))]
        p6 = prep_of(scene, variant=6)
        args6 = (p6["table"], p6["orig"], p6["units"], p6["counts6"],
                 p6["zu"], res, p6["nsub"])
        ms6 = median_ms(lambda: rc.visibility_v6(
            *args6[:5], p6["fbox"], p6["ubox"], res, p6["nsub"]), TIMED_RUNS)
        plain_ms = statistics.median(
            cuda_ms(lambda: rc.visibility_reference(*args), 3))
        plain6_ms = statistics.median(
            cuda_ms(lambda: rc.visibility_v6_reference(*args6), 3))
        bytes_ms, ops_ms, nbytes, pairs = visibility_bound(
            v_clip, faces, prep, res, visits, (z, fid, flags))
        bound = max(bytes_ms, ops_ms)
        bytes4_ms, _o, nbytes4, _p = visibility_bound(
            v_clip, faces, prep, res, visits, (z, fid, flags), run_ids=True)
        bound4 = max(bytes4_ms, ops_ms)
        walk_readings(name, prep, visits, res)
        live = visits.shape[0]
        print(f"visibility[{name}]: copy requests per render for the "
              f"{live} live sub-blocks: K1 {3 * live} (rows, ids, boxes), K2 "
              f"{2 * live} (rows, boxes; ids rebuilt from run bases); loads "
              "of chunks skipped after staging add to both. Back to back, "
              f"ms a call: K1 {b2b[0]:.4f} / {b2b[3]:.4f}, K2 {b2b[1]:.4f} / "
              f"{b2b[2]:.4f}")
        _p, peak3 = prepare_peak(scene, 3)
        _p, peak4 = prepare_peak(scene, 4)
        _p, peak6 = prepare_peak(scene, 6)
        print(f"visibility[{name}]: prepare peak memory variant 3 "
              f"{peak3 / 2**30:.3f} GiB, variant 4 {peak4 / 2**30:.3f} GiB, "
              f"variant 6 {peak6 / 2**30:.3f} GiB")
        print(f"visibility[{name}]: K1 {ms:.4f} ms, K2 {ms4:.4f} ms, K3 "
              f"{ms6:.4f} ms; plain {plain_ms:.4f} ms (K1's and K2's), "
              f"{plain6_ms:.4f} ms (K3's); bound {bound:.4f} ms (live bytes "
              f"{nbytes} -> {bytes_ms:.4f} ms; live bbox pairs {pairs} -> "
              f"{ops_ms:.4f} ms), K2's {bound4:.4f} ms (run bases for ids: "
              f"live bytes {nbytes4}); kernel/bound K1 {ms / bound:.1f}x, K2 "
              f"{ms4 / bound4:.1f}x, K3 {ms6 / bound:.1f}x")
        if name == "train":
            train_ms = {"raster_vis": ms, "raster_vis_v4": ms4,
                        "raster_vis_v6": ms6}
            train_b2b = {"raster_vis": (b2b[0] + b2b[3]) / 2,
                         "raster_vis_v4": (b2b[1] + b2b[2]) / 2}
        if name == "recon":
            recon_b2b = {"raster_vis": (b2b[0] + b2b[3]) / 2,
                         "raster_vis_v4": (b2b[1] + b2b[2]) / 2}
        if name != "recon":
            continue
        entries = {
            "cull_boxes": cull_entry(prep, res),
            "unit_boxes": cull_entry(p6, res, units=True),
            "raster_vis": kernel_entry(
                "raster_vis", "raster_vis.cu", "rasterize_pallas.py:153",
                "redesigned, PR 7 (ported, PR 1)", err, ms, plain_ms,
                bytes_ms, ops_ms),
            "raster_vis_v4": kernel_entry(
                "raster_vis_v4", "raster_vis_v4.cu",
                "rasterize_pallas.py:286", "redesigned, PR 9 (ported, PR 3)",
                err2, ms4, plain_ms, bytes4_ms, ops_ms),
            "raster_vis_v6": kernel_entry(
                "raster_vis_v6", "raster_vis_v6.cu",
                "rasterize_pallas.py:513", "redesigned, PR 8 (ported, PR 3)",
                err3, ms6, plain6_ms, bytes_ms, ops_ms)}
    # K1, K2 and K3 on the training forward's own posed meshes too; K1 and
    # K2 back to back on both
    for name, ms in train_ms.items():
        entries[name]["ms_train_poses"] = ms
    for name in recon_b2b:
        entries[name]["ms_back_to_back"] = recon_b2b[name]
        entries[name]["ms_back_to_back_train_poses"] = train_b2b[name]
    return entries


# ---------------------------------------------------------------------------
# fused netSDF sweep and resolve backward against their plain versions
# ---------------------------------------------------------------------------

def median_ms(fn, runs=KERNEL_RUNS):
    fn()                                    # warm-up
    return statistics.median(cuda_ms(fn, runs))


def back_to_back_ms(fn, n=20):
    """Device time per call of `fn` launched n times back to back (CUDA
    events around the loop): the host's wrapper time hides behind the
    card's work where the card is the slower."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=20, runs=5):
    """Device time per call of `fn`: n calls captured in one CUDA graph
    (the wrapper launches on the current stream, so the capture takes its
    kernels and none of its host work), the graph replayed `runs` times
    (CUDA events, median) and divided by n."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(graph.replay, runs)) / n
    del graph
    return ms


def sweep_operands(model, cd, n_rows=None):
    """The fused sweep's operands as the training forward makes them: the
    harmonic embedding of the jittered lattice of the model's training
    grid (or its first `n_rows` rows), zero-padded, and netSDF's weights,
    in compute type `cd`; plus a random output cotangent."""
    import torch
    from animals3d_tpu_torch.ops import fused_mlp as fm
    net, shape = model.netBase.netSDF, model.netBase.cfg.cfg_shape
    phase = model.phase_for_iter(TRAIN_IT)
    grid, _v, _f = model.grid_for_phase(phase)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        pos = grid.verts * shape.spatial_scale \
            + (torch.rand((), generator=gen, device="cuda") * 2 - 1) \
            * shape.jitter_grid * shape.spatial_scale
        pts = torch.cat([pos[..., :1].abs(), pos[..., 1:]], -1)
        e = net.embed(pts if n_rows is None else pts[:n_rows])
        d = e.shape[1]
        dp = -(-d // fm.KPAD) * fm.KPAD
        ep = torch.zeros((e.shape[0], dp), dtype=cd, device="cuda")
        ep[:, :d] = e
        win = torch.zeros((dp, fm.NF), dtype=cd, device="cuda")
        win[:d] = net.in_layer.weight.T
        L = shape.num_layers
        ws = torch.stack([getattr(net.mlp, f"layer_{i}").weight.T
                          for i in range(L - 1)]).to(cd).contiguous()
        wlast = getattr(net.mlp, f"layer_{L - 1}").weight[0].to(cd) \
            .contiguous()
        b = net.in_layer.bias.detach().float().contiguous()
        g = torch.randn((e.shape[0],), generator=gen, device="cuda")
    return (ep, win, b, ws, wlast), g


def sweep_phase(model):
    """K6/K7 against their plain versions; returns their `kernels`
    entries (bf16 at full width, the main path's type and shape).

    Tolerances. float32: forward 2e-5 of the output's magnitude, each
    gradient 1e-4 of its norm (only the summation order differs). bf16:
    the output is a bf16 value of a 256-long float32 sum taken in another
    order than the library's, after four layers rounded the same way: the
    bound is 2 bf16 ulps (2^-8 relative each) of the output's magnitude,
    where this check observes 0.62, and 2e-3 of each gradient's norm,
    where it observes 2.2e-4 to 3.6e-4 (a rounded activation that lands
    on the other side of a bf16 step). Two calls of either direction give
    the same bits. At N = 4097 the last row is a tile
    of its own: its output is held on its own, and a cotangent that is
    non-zero on that row alone must give the plain version's gradients,
    so a dropped or mis-masked ragged row cannot hide in a norm over all
    rows.

    Bounds count what the function needs at the embedding's own width d
    (51; the wrapper pads it to a multiple of 64 for the kernel): the
    forward 2·N·(d·256 + (L-1)·256² + 256) operations; the backward the
    recomputed forward, every weight gradient and the cotangent's way
    back through the last and the hidden layers, three times the forward
    less 2·N·d·256 (the input has no cotangent)."""
    import torch
    from animals3d_tpu_torch.ops import fused_mlp as fm
    entries = {}
    full = None
    for cd, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        f32 = cd == torch.float32
        for n_rows in (4097, None):
            ops_, g = sweep_operands(model, cd, n_rows)
            out = fm.fused_mlp_fwd(*ops_)
            grads = fm.fused_mlp_bwd(ops_[0], g, *ops_[1:])
            torch.cuda.synchronize()
            want = fm.fused_mlp_fwd_reference(*ops_)
            wgrads = fm.fused_mlp_bwd_reference(ops_[0], g, *ops_[1:])
            scale = float(want.abs().max())
            err = float((out - want).abs().max())
            tol = (2e-5 if f32 else 2 * 2.0 ** -8) * scale
            gerr = max(float((a - w).norm() / w.norm())
                       for a, w in zip(grads, wgrads))
            N = ops_[0].shape[0]
            print(f"fused_mlp[{name}, N={N}]: fwd max|err| {err:.3g} (scale "
                  f"{scale:.3g}, {err / (2.0 ** -8 * scale):.2f} bf16 ulps), "
                  f"worst grad |err|/norm {gerr:.3g}")
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"fused_mlp_fwd[{name}, N={N}] differs "
                                     f"by {err} > {tol}")
            gtol = 1e-4 if f32 else 2e-3
            if not gerr <= gtol:
                raise AssertionError(f"fused_mlp_bwd[{name}, N={N}] grads "
                                     f"differ by {gerr} of their norm")
            if not torch.equal(out, fm.fused_mlp_fwd(*ops_)):
                raise AssertionError(f"fused_mlp_fwd[{name}, N={N}]: two "
                                     "calls give different outputs")
            again = fm.fused_mlp_bwd(ops_[0], g, *ops_[1:])
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"fused_mlp_bwd[{name}, N={N}]: two "
                                     "calls give different gradients")
            if n_rows is not None:
                ragged_row_check(fm, ops_, out, want, tol, gtol, name)
                continue
            ep, win, b, ws, wlast = ops_
            d = model.netBase.netSDF.in_layer.weight.shape[1]
            L, size = ws.shape[0] + 1, ep.element_size()
            flops = 2.0 * N * (d * fm.NF + (L - 1) * fm.NF ** 2 + fm.NF)
            ebytes = N * d * size
            wbytes = (d * fm.NF + ws.numel() + wlast.numel()) * size \
                + b.numel() * 4
            gbytes = 4 * (d * fm.NF + b.numel() + ws.numel() + wlast.numel())
            peak = F32_PEAK_FLOPS if f32 else BF16_PEAK_FLOPS
            rows = []
            for kname, fn, plain, k_flops, nbytes, kerr in (
                    ("fused_mlp_fwd", lambda: fm.fused_mlp_fwd(*ops_),
                     lambda: fm.fused_mlp_fwd_reference(*ops_), flops,
                     ebytes + 4 * N + wbytes, err),
                    ("fused_mlp_bwd",
                     lambda: fm.fused_mlp_bwd(ep, g, *ops_[1:]),
                     lambda: fm.fused_mlp_bwd_reference(ep, g, *ops_[1:]),
                     3 * flops - 2.0 * N * d * fm.NF,
                     ebytes + 4 * N + wbytes + gbytes, gerr)):
                ms = median_ms(fn)
                plain_ms = median_ms(plain, 3)
                ops_ms = k_flops / peak * 1e3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                bound = max(ops_ms, bytes_ms)
                print(f"{kname}[{name}, N={N}]: kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound:.4f} ms (operations "
                      f"{k_flops:.4g} -> {ops_ms:.4f} ms; bytes {nbytes} -> "
                      f"{bytes_ms:.4f} ms), kernel/bound {ms / bound:.1f}x")
                fwd = kname.endswith("fwd")
                rows.append(kernel_entry(
                    kname, "fused_mlp.cu", "fused_mlp.py:"
                    + ("59" if fwd else "76"), "redesigned, PR "
                    + ("6" if fwd else "5") + " (ported, PR 2)", kerr, ms,
                    plain_ms, bytes_ms, ops_ms))
            if not f32:
                entries = {r["name"]: r for r in rows}
                fwd_alone(fm, ops_, flops, entries["fused_mlp_fwd"])
                bwd_passes(fm, ops_, g)
            full = N
    unfused_sweep_line(model, full)
    return entries["fused_mlp_fwd"], entries["fused_mlp_bwd"]


def fwd_alone(fm, ops_, flops, entry):
    """K6 (bf16) launched alone with a prebuilt weight stream, beside the
    wrapper call of the `kernels` line and the stream's build (CUDA events,
    medians); its rate and its share of the bound."""
    ep, win, b, ws, wlast = ops_
    wstream = fm.weight_stream(win, ws)
    stream_ms = median_ms(lambda: fm.weight_stream(win, ws))
    alone = median_ms(lambda: fm.fused_mlp_fwd(*ops_, wstream))
    print(f"fused_mlp_fwd[bf16, N={ep.shape[0]}]: launch with a prebuilt "
          f"stream {alone:.4f} ms ({flops / alone / 1e9:.1f} TFLOP/s, "
          f"{entry['bound_ms'] / alone * 100:.1f}% of the bound "
          f"{entry['bound_ms']:.4f} ms); wrapper call {entry['ms']:.4f} ms; "
          f"weight stream build {stream_ms:.4f} ms "
          f"({wstream.numel() * wstream.element_size()} bytes, "
          f"{fm.stream_slices(ep.shape[1], ws.shape[0] + 1)[0]} of "
          f"{wstream.shape[0]} slices read by the forward); card "
          f"{card_line()}")


def bwd_passes(fm, ops_, g):
    """K7's passes timed one at a time over all chunks of the default plan
    (CUDA events, medians), with the plan's chunk rows C, its scratch and
    partial bytes and the device launches of one call."""
    import torch
    ep = ops_[0]
    N = ep.shape[0]
    plan = fm.bwd_plan(N, ops_[3].shape[0] + 1, ep.shape[1])
    run = fm.BwdRun(ep, g, *ops_[1:], plan)
    nc = len(plan.chunks)
    chain = median_ms(lambda: [run.chain(i) for i in range(nc)])
    wgrad = median_ms(lambda: [run.wgrad(i) for i in range(nc)])
    reduce = median_ms(run.reduce)
    part = (run.part.numel() + run.part2.numel()) * 4
    print(f"fused_mlp_bwd[bf16, N={N}] passes: chain {chain:.4f} ms, "
          f"weight-gradient {wgrad:.4f} ms, reduce {reduce:.4f} ms (each "
          f"over all {nc} chunks); C {plan.C} rows, scratch "
          f"{plan.scratch_elems * ep.element_size()} bytes "
          f"({plan.scratch_elems * ep.element_size() / 2**20:.1f} MiB), "
          f"partials {part} bytes, weight stream "
          f"{run.wstream.numel() * ep.element_size()} bytes, device launches "
          f"per call {run.launches()} ({nc} chain, {nc} weight-gradient, 1 "
          f"reduce); card {card_line()}")
    torch.cuda.synchronize()


def ragged_row_check(fm, ops_, out, want, tol, gtol, name):
    """The last row of a ragged N, alone in its tile: its output within
    `tol` of the plain version's and not left at zero, and the gradients
    of a cotangent that is non-zero on that row alone within `gtol` of
    the plain version's norms."""
    import torch
    N = ops_[0].shape[0]
    last = float((out[-1] - want[-1]).abs())
    g = torch.zeros((N,), device="cuda")
    g[-1] = 1.0
    grads = fm.fused_mlp_bwd(ops_[0], g, *ops_[1:])
    wgrads = fm.fused_mlp_bwd_reference(ops_[0], g, *ops_[1:])
    if not all(float(w.norm()) > 0 for w in wgrads):
        raise AssertionError(f"fused_mlp[{name}, N={N}]: the last row gives "
                             "a zero gradient; pick another row count")
    gerr = max(float((a - w).norm() / w.norm())
               for a, w in zip(grads, wgrads))
    print(f"fused_mlp[{name}, N={N}]: last row out {float(out[-1]):.6g} "
          f"(plain {float(want[-1]):.6g}, |err| {last:.3g}); grads of a "
          f"cotangent on that row alone |err|/norm {gerr:.3g}")
    if not (last <= tol and float(out[-1]) != 0.0):
        raise AssertionError(f"fused_mlp_fwd[{name}, N={N}]: last row "
                             f"differs by {last} > {tol}")
    if not gerr <= gtol:
        raise AssertionError(f"fused_mlp_bwd[{name}, N={N}]: the last row's "
                             f"grads differ by {gerr} of their norm")


def unfused_sweep_line(model, N):
    """For orientation only: the unfused path (`get_sdf` over the lattice,
    bf16: a chain of library matrix products) forward alone under
    `torch.no_grad()`, the yardstick K6 must beat, and forward and
    backward under autograd with its peak memory."""
    import torch
    from animals3d_tpu_torch.precision import (compute_dtype,
                                               set_mixed_precision)
    was = compute_dtype()
    set_mixed_precision("bf16")
    shape = model.netBase.cfg.cfg_shape
    grid, _v, _f = model.grid_for_phase(model.phase_for_iter(TRAIN_IT))
    pos = grid.verts * shape.spatial_scale

    def fwd():
        with torch.no_grad():
            model.netBase.get_sdf(pos)

    def run():
        model.netBase.get_sdf(pos)[..., 0].sum().backward()
        model.zero_grad(set_to_none=True)
    fwd_ms = median_ms(fwd, 5)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = statistics.median(cuda_ms(run, 5))
    peak = torch.cuda.max_memory_allocated() - base
    set_mixed_precision(None if was == torch.float32 else "bf16")
    print(f"unfused sweep (get_sdf, bf16, N={N}; not a kernel of the port, "
          f"for orientation): forward alone under no_grad {fwd_ms:.3f} ms; "
          f"forward + backward under autograd {ms:.3f} ms, peak memory "
          f"above the model {peak / 2**30:.2f} GiB; card {card_line()}")


def train_pose_scene(model, batch):
    """The posed meshes the full-width training forward rasterizes (grid
    jitter and pose draws from SEED)."""
    import torch
    from animals3d_tpu_torch.render.camera import xfm_points
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    with torch.no_grad():
        _loss, (_m, aux) = model.forward(batch, TRAIN_IT, gen)
    shape = aux["shape"]
    H = model.out_image_size
    v_clip = xfm_points(shape.v_pos, aux["mvp"]).contiguous()
    return (v_clip, shape.v_pos[0], shape.t_pos_idx, shape.f_valid, (H, H),
            1024)


def train_scene(model, batch):
    """Winner ids of the training forward's own render: (B, H·W) int32."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    v_clip, v_pos0, faces, f_valid, res, _chunk = train_pose_scene(model,
                                                                   batch)
    with torch.no_grad():
        rast = rc.rasterize_cuda(v_clip, faces, f_valid, res, v_pos0=v_pos0)
    fid = rast.face_id.reshape(rast.face_id.shape[0], -1).contiguous()
    return fid, faces.shape[0]


def resolve_phase(model, batch):
    """K4 against its plain version; returns its `kernels` entry (the
    training step's own winner ids, bf16 cotangent: the main path's).

    Tolerance: exact where every face has at most one pixel; else rtol
    1e-5 of the largest entry (the order of the float32 atomics changes
    from run to run)."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # depth stack: 2 faces cover the whole 32x32 image
    v_clip, v_pos0, faces, f_valid, res, chunk = depth_stack_scene()
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device="cuda")
    rast = rc.rasterize_cuda(t(v_clip), t(faces, torch.int64),
                             t(f_valid, torch.bool), res, t(v_pos0), chunk)
    fid_stack = rast.face_id.reshape(1, -1).contiguous()
    fid_train, n_faces = train_scene(model, batch)
    R = 3 * (4 + 9) + 3
    entry = None
    for name, fid, Fn in (("depth_stack", fid_stack, len(faces)),
                          ("train_step", fid_train, n_faces)):
        B, P = fid.shape
        per_face = torch.bincount(fid[fid > 0].long())
        for cd in (torch.float32, torch.bfloat16):
            g = torch.randn((B, P, R), generator=gen, device="cuda").to(cd)
            got = rv.resolve_bwd(g, fid, Fn)
            torch.cuda.synchronize()
            want = rv.resolve_bwd_reference(g, fid, Fn)
            err = float((got - want).abs().max())
            tol = 0.0 if int(per_face.max()) <= 1 \
                else 1e-5 * float(want.abs().max())
            print(f"resolve_bwd[{name}, {str(cd)[6:]}]: B={B} P={P} R={R} "
                  f"F={Fn} foreground px {int((fid > 0).sum())}, live faces "
                  f"{int((per_face > 0).sum())}, most pixels on one face "
                  f"{int(per_face.max())}, max|err| {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"resolve_bwd[{name}] differs by {err}")
            bg = g.clone()
            bg[fid == 0] = 0
            if not torch.equal(rv.resolve_bwd(bg, fid, Fn) != 0, got != 0):
                raise AssertionError(f"resolve_bwd[{name}]: a background "
                                     "cotangent reached a face")
        if name != "train_step":
            continue
        # timed in bf16, the type the bf16 training step hands the kernel
        ms = median_ms(lambda: rv.resolve_bwd(g, fid, Fn))
        plain_ms = median_ms(lambda: rv.resolve_bwd_reference(g, fid, Fn), 3)
        sel = torch.clamp(fid.long() - 1, min=0)
        rows = torch.where((fid > 0)[..., None], g.float(),
                           torch.zeros((), device="cuda"))

        def library():
            out = torch.zeros((B, Fn, R), device="cuda")
            for i in range(B):
                out[i].index_add_(0, sel[i], rows[i])
            return out
        library_ms = median_ms(library)
        nbytes = g.numel() * g.element_size() + fid.numel() * 4 \
            + B * Fn * R * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = int((fid > 0).sum()) * R / F32_PEAK_FLOPS * 1e3
        bound = max(bytes_ms, ops_ms)
        print(f"resolve_bwd[{name}, bfloat16]: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
              f"{bound:.4f} ms (bytes {nbytes} -> {bytes_ms:.4f} ms; "
              f"additions -> {ops_ms:.5f} ms), kernel/bound "
              f"{ms / bound:.1f}x")
        entry = kernel_entry("resolve_bwd", "resolve_bwd.cu",
                             "rasterize_pallas.py:1097", "ported, PR 2", err,
                             ms, plain_ms, bytes_ms, ops_ms, library_ms)
    return entry


def resolve_fwd_phase(model, batch):
    """K5 against its plain version on the training step's own winner ids
    with random float32 rows (10, F, 42): exact equality (a copy of a
    float), zero on background; timed beside its plain version and beside
    `torch.gather` with the permute to tile order. Returns its `kernels`
    entry. Bound: bytes — face_id read once, the row of each winning
    (image, face) read once, the (B, R, T·TP) rows written once."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    fid, n_faces = train_scene(model, batch)
    B, P = fid.shape
    H = model.out_image_size
    R = 3 * (4 + 9) + 3
    gen = torch.Generator(device=fid.device).manual_seed(SEED)
    pf = torch.randn((B, n_faces, R), generator=gen, device=fid.device)
    got = rv.resolve_fwd(pf, fid, (H, H))
    torch.cuda.synchronize()
    want = rv.resolve_fwd_reference(pf, fid, (H, H))
    if not torch.equal(got, want):
        raise AssertionError(f"resolve_fwd differs at {int((got != want).sum())}"
                             " entries")
    bg = rv.to_tile_order((fid == 0)[..., None], (H, H))[:, 0]
    if got[bg[:, None].expand_as(got)].any():
        raise AssertionError("resolve_fwd: a background row is not zero")
    sel = torch.clamp(fid.long() - 1, min=0)[..., None].expand(B, P, R)

    def library():
        rows = torch.gather(pf, 1, sel)
        return rv.to_tile_order(rows, (H, H)).contiguous()
    lib = library()
    fg = (fid > 0)
    fgt = rv.to_tile_order(fg[..., None], (H, H))[:, 0][:, None]
    if not torch.equal(torch.where(fgt, lib, 0.0), got):
        raise AssertionError("resolve_fwd: differs from torch.gather")
    ms = median_ms(lambda: rv.resolve_fwd(pf, fid, (H, H)))
    plain_ms = median_ms(lambda: rv.resolve_fwd_reference(pf, fid, (H, H)),
                         3)
    library_ms = median_ms(library)
    # back to back, where the wrapper's host time hides behind the card's
    b2b = back_to_back_ms(lambda: rv.resolve_fwd(pf, fid, (H, H)))
    lib_b2b = back_to_back_ms(library)
    # the rows K5 reads: one per run of pixels of a tile row (32 pixels)
    # with one winner; the other foreground pixels share their left
    # neighbour's
    img = fid.reshape(B, H, H)
    fgi = img > 0
    left = torch.nn.functional.pad(img, (1, 0))[..., :-1]
    col = torch.arange(H, device=fid.device) % rc.TILE_W
    heads = fgi & ((col == 0) | (img != left))
    n_heads = int(heads.sum())
    n_fg = int(fg.sum())
    # each winning face's row is read once, however many pixels it won
    key = fid.long() + torch.arange(B, device=fid.device)[:, None] \
        * (n_faces + 1)
    n_rows = int(torch.unique(key[fg]).numel())
    nbytes = fid.numel() * 4 + n_rows * R * 4 + B * R * P * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"resolve_fwd[train_step]: rows read (runs of one winner in a "
          f"tile row) {n_heads}, foreground pixels that share their left "
          f"neighbour's winner {n_fg - n_heads}; back to back "
          f"{b2b:.4f} ms a call, torch.gather + permute {lib_b2b:.4f}")
    print(f"resolve_fwd[train_step]: B={B} P={P} R={R} F={n_faces} "
          f"foreground px {n_fg}, winning (image, face) rows {n_rows}: "
          f"identical to the plain version and to "
          f"torch.gather, background zero; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.gather + permute {library_ms:.4f} ms, "
          f"bound {bytes_ms:.4f} ms (bytes {nbytes}), kernel/bound "
          f"{ms / bytes_ms:.1f}x")
    entry = kernel_entry("resolve_fwd", "resolve_fwd.cu",
                         "rasterize_pallas.py:1269",
                         "redesigned, PR 9 (ported, PR 3)", 0.0, ms, plain_ms,
                         bytes_ms, 0.0, library_ms)
    entry["ms_back_to_back"] = b2b
    return entry


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def build(overrides, device, **render):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    cfg = cfglib.load_config("train_magicpony_horse", overrides=overrides)
    model_cfg = dict(cfg["model"])
    model_cfg["dataset"] = cfg["dataset"]
    return cfg, build_model(model_cfg, device=device, **render)


# the render selectors of each path the script drives, and the kernels each
# path launches once per render (the forward) or per step; "unit_boxes" is
# the cull kernel's launch that also writes variant 6's unit boxes
PATHS = {
    "train": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                   "fused_mlp_bwd", "resolve_bwd")),
    "train_v6_kernel_rows": (
        dict(raster_variant=6, resolve_rows="kernel"),
        ("unit_boxes", "raster_vis_v6", "resolve_fwd", "resolve_bwd",
         "fused_mlp_fwd", "fused_mlp_bwd")),
    "recon": ({}, ("cull_boxes", "raster_vis")),
    "recon_v4": (dict(raster_variant=4), ("cull_boxes", "raster_vis_v4")),
    "recon_v6_kernel_rows": (dict(raster_variant=6, resolve_rows="kernel"),
                             ("unit_boxes", "raster_vis_v6", "resolve_fwd")),
}


def counters():
    """The launch counter of every kernel wrapper, by kernel name."""
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    return {"cull_boxes": rc.cull, "unit_boxes": rc.cull_units,
            "raster_vis": rc.visibility,
            "raster_vis_v4": rc.visibility_v4,
            "raster_vis_v6": rc.visibility_v6,
            "fused_mlp_fwd": fm.fused_mlp_fwd,
            "fused_mlp_bwd": fm.fused_mlp_bwd, "resolve_bwd": rv.resolve_bwd,
            "resolve_fwd": rv.resolve_fwd}


def reset_counts():
    for k in counters().values():
        k.launches = 0


def check_counts(path, runs):
    """Every kernel of `path` launched `runs` times since `reset_counts`,
    every other kernel not at all; returns the counts."""
    launches = {name: k.launches for name, k in counters().items()}
    want = PATHS[path][1]
    for name, n in launches.items():
        if n != (runs if name in want else 0):
            raise AssertionError(f"{path}: {name} launched {n} times in "
                                 f"{runs} runs")
    return launches


def reference_phase():
    """A small float32 model on the card against the same weights on the
    CPU: cameras, articulation and light agree to 1e-4; the shaded RGBA
    agrees to 1e-3 on all but silhouette pixels whose winning face flips on
    rounding (at most 0.2% of the pixels; 0.09% are seen on an H100)."""
    import torch
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(False)
    _cfg, gpu = build(SMALL_OVERRIDES, "cuda")
    gpu.init_params(SEED)
    _cfg, cpu = build(SMALL_OVERRIDES, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(SEED)
    images = rng.uniform(0, 1, (2, 1, 3, 64, 64)).astype(np.float32)
    s_gpu, o_gpu = gpu.reconstruct(gpu, torch.from_numpy(images).cuda(),
                                   50000)
    s_cpu, o_cpu = cpu.reconstruct(cpu, torch.from_numpy(images), 50000)
    for name, i in (("mvp", 3), ("arti_params", 9), ("light_params", 10)):
        err = float((o_gpu[i].cpu() - o_cpu[i]).abs().max())
        print(f"reference: {name} max |gpu - cpu| = {err:.3g}")
        if not err <= 1e-4:
            raise AssertionError(f"reference: {name} differs by {err}")
    d = (s_gpu.cpu() - s_cpu).abs().amax(1)
    bad = float((d > 1e-3).float().mean())
    print(f"reference: shaded max |gpu - cpu| = {float(d.max()):.3g}, "
          f"share of pixels above 1e-3 = {bad:.4f}")
    if not bad <= 0.002:
        raise AssertionError(f"reference: {bad:.4f} of the pixels differ")


def draw_noise(model, gen, n_images):
    """One training forward's draws, on the CPU, so that two devices can
    be handed the same ones."""
    import torch
    from animals3d_tpu_torch.noise import Noise
    K = model.netInstance.num_pose_hypos
    u = lambda *shape: torch.rand(shape, generator=gen)
    return Noise(jitter_u=u(), rand_idx=torch.floor(u(n_images) * K).long(),
                 best_u=u(n_images), rand_pts_u=u(5000, 3),
                 surf_idx=None, surf_u=u(5000, 3))


def train_reference_phase(path="train"):
    """One training step of a small float32 model on the card against the
    same step on the CPU, from the same weights, batch and noise, on the
    render path `path` of `PATHS` (the card's kernels against their plain
    versions on the CPU): loss to
    1e-4 relative (7e-7 seen), every parameter's gradient to
    `REF_GRAD_TOL` of its norm (2e-3; 9.1e-4 seen on the articulation
    leaves, 6.2e-4 on the encoder's, 4.0e-4 on netSDF's), `REF_NOISY_TOL`
    on netTexture and on the first two layers of netDINO (2e-2; 9.0e-3
    seen on netTexture's in-layer, 2.4e-3 on its later layers, 3e-5 on
    netDINO's), no NaN or inf, a gradient for every trainable parameter
    the phase uses and none for the ViT.

    The batch is `fake_batch` with its images and feature targets scaled
    by 0.1. Under uniform-noise targets the residuals of the rgb and
    feature losses have random signs and a leaf's gradient is the small
    remainder of per-pixel terms that cancel; one ReLU unit of a field
    sampled through a harmonic embedding that switches at one pixel then
    moves the leaf by 1e-2 of its norm (1.05e-2 was seen here on
    netTexture's in-layer). Dark targets keep most residuals of one sign.
    The bounds are the float32 formulation's, not the kernels':
    `tests/torch_grad_noise.py` shows on the CPU that either package's
    own gradient moves as far when its parameters are nudged by one ulp.
    The wide bound sits on leaves that are no stop-gradient's only
    witness: each stop-gradient of the training forward, when removed,
    moves an articulation, encoder or netSDF leaf by at least 5.6e-3
    (`tests/test_torch_train.py`).

    The two devices round differently, and two discrete decisions hang on
    the last bit. Which vertex is a leg's foot (the lowest of a quadrant,
    among marching-tets vertices that share their height up to rounding):
    the phase draws noise from seeds 0, 1, ... until the articulation
    agrees within 1e-4, at most 8 seeds. And which face wins a pixel on a
    shared edge: a first pass without gradients finds the pixels whose
    rendered mask, image or features differ by more than 1e-3 or whose
    mask is positive on one device only (at most 0.5% of them), and the
    compared step takes those pixels and their neighbours within two
    pixels (the antialias pass blends across neighbours, the rgb loss
    erodes its mask by one pixel) out of the per-pixel losses on both
    devices through the batch itself: `mask_valid` 0 there (no mask, rgb
    or feature term) and `mask_dt` 0 there (no distance-transform
    term)."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.trainer import make_optimizer
    set_mixed_precision(False)
    render, kernels = PATHS[path]
    _cfg, gpu = build(TRAIN_SMALL_OVERRIDES, "cuda", **render)
    state = {k: v.detach().cpu().clone()
             for k, v in gpu.init_params(SEED).items()}
    _cfg, cpu = build(TRAIN_SMALL_OVERRIDES, "cpu", **render)
    cpu.load_state_dict(state)
    phase = gpu.phase_for_iter(TRAIN_IT)
    if not gpu.netBase._use_fused_sweep(training=True):
        raise AssertionError(f"train reference [{path}]: the fused sweep is off")
    B = 2
    batches = {"gpu": fake_batch(gpu, B, SEED),
               "cpu": fake_batch(cpu, B, SEED)}
    for batch in batches.values():
        for k in ("images", "dino_features"):
            batch[k] = batch[k] * 0.1
    models = {"gpu": gpu, "cpu": cpu}
    reset_counts()

    def both(noise, grad):
        out = {}
        for name, model in models.items():
            model.zero_grad(set_to_none=True)
            with torch.set_grad_enabled(grad):
                loss, (_met, aux) = model.forward(batches[name], TRAIN_IT,
                                                  None, phase, noise=noise)
                if grad:
                    loss.backward()
            out[name] = (loss.detach().cpu(), aux)
        return out

    for seed in range(8):
        gen = torch.Generator().manual_seed(seed)
        noise = draw_noise(cpu, gen, B)
        grid, v_cap, f_cap = cpu.grid_for_phase(phase)
        with torch.no_grad():
            prior, _ = cpu.forward_base(grid, v_cap, f_cap,
                                        jitter=noise.jitter_u)
        noise = dataclasses.replace(noise, surf_idx=torch.floor(
            torch.rand(5000, generator=gen)
            * max(int(prior.num_verts), 1)).long())
        out = both(noise, grad=False)
        a_gpu, a_cpu = out["gpu"][1], out["cpu"][1]
        d = lambda k: (a_gpu[k].detach().cpu() - a_cpu[k].detach()).abs()
        arti = float(d("arti_params").max())
        differ = (d("mask_pred") > 1e-3) | (d("image_pred").amax(2) > 1e-3) \
            | (d("dino_pred").amax(2) > 1e-3) \
            | ((a_gpu["mask_pred"].cpu() > 0) != (a_cpu["mask_pred"] > 0))
        share = float(differ.float().mean())
        print(f"train reference [{path}]: seed {seed}: articulation |gpu - cpu| "
              f"{arti:.3g}, share of pixels that differ {share:.4f}")
        if arti <= 1e-4:
            break
    else:
        raise AssertionError(f"train reference [{path}]: no seed of 8 on which the "
                             "card and the CPU pick the same feet")
    if not share <= 0.005:
        raise AssertionError(f"train reference [{path}]: {share:.4f} of the pixels "
                             "differ between the card and the CPU")
    near = F.max_pool2d(differ.float().flatten(0, 1)[:, None], 5, stride=1,
                        padding=2)[:, 0].reshape(differ.shape)
    for name, model in models.items():
        keep = (1.0 - near).to(model.device)
        batches[name]["mask_valid"] = batches[name]["mask_valid"] * keep
        batches[name]["mask_dt"] = batches[name]["mask_dt"] \
            * keep[:, :, None]
    out = both(noise, grad=True)
    (l_gpu, _), (l_cpu, _) = out["gpu"], out["cpu"]
    now = {k: c.launches for k, c in counters().items()}
    if any(now[k] == 0 for k in kernels) or any(
            now[k] for k in now if k not in kernels):
        raise AssertionError(f"train reference [{path}]: kernel launches "
                             f"{now}: the card did not go through its path")
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    print(f"train reference [{path}]: loss gpu {float(l_gpu):.6f} cpu "
          f"{float(l_cpu):.6f} (rel {rel:.3g})")
    if not rel <= 1e-4:
        raise AssertionError(f"train reference [{path}]: loss differs by {rel}")
    worst, bad, gap, by_net = (0.0, ""), [], {}, {}
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        q = cpu_params[name]
        if ".ViT." in name:
            if p.grad is not None or q.grad is not None:
                raise AssertionError(f"train reference [{path}]: {name} has a grad")
            continue
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"train reference [{path}]: {name}: grad on one "
                                 "device only")
        if p.grad is None:
            if not name.startswith("netInstance.netDeform."):
                raise AssertionError(f"train reference [{path}]: {name} has no grad")
            continue
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"train reference [{path}]: {name}: non-finite grad")
        err = float((p.grad.cpu() - q.grad).norm() / q.grad.norm())
        gap[name] = float((p.grad.cpu() - q.grad).abs().max())
        noisy = name.startswith(REF_NOISY_LEAVES)
        if not err <= (REF_NOISY_TOL if noisy else REF_GRAD_TOL):
            bad.append(f"{name}: {err:.3g}")
        worst = max(worst, (err, name))
        net = ".".join(name.split(".")[:2]) + (" (wide bound)" if noisy
                                               else "")
        by_net[net] = max(by_net.get(net, 0.0), err)
    print(f"train reference [{path}]: worst grad |gpu - cpu| / norm = {worst[0]:.3g} "
          f"({worst[1]}); by network "
          + ", ".join(f"{k} {v:.3g}" for k, v in by_net.items()))
    if bad:
        raise AssertionError(f"train reference [{path}]: grads differ by more than "
                             "the bound: " + "; ".join(bad))
    # the optimizer step on both devices. Adam's first update is
    # lr·g/(|g| + 1e-8): ±lr wherever |g| is well above eps and above the
    # two devices' difference in that gradient, whatever its rounding; any
    # other entry may land anywhere within one update on either device
    clear = {name: q.grad.abs() > max(1e-6, 10 * gap[name])
             for name, q in cpu.named_parameters() if q.grad is not None}
    moved = 0.0
    for model in (gpu, cpu):
        opt = make_optimizer(model)
        opt.step()
        opt.zero_grad(set_to_none=True)
    lr = max(gpu.cfg_optim_base.lr, gpu.cfg_optim_instance.lr)
    for (name, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        diff = (p.detach().cpu() - q.detach()).abs()
        if name not in clear:
            if float(diff.max()) != 0.0:
                raise AssertionError(f"train reference [{path}]: {name} moved "
                                     "without a gradient")
            continue
        if float(diff.max()) > 2.1 * lr or \
                float((diff * clear[name]).max()) > 0.02 * lr:
            raise AssertionError(f"train reference [{path}]: {name} differs after the "
                                 f"step by {float(diff.max())}")
        moved = max(moved, float((q.detach() - state[name]).abs().max()))
    if not moved > 0:
        raise AssertionError(f"train reference [{path}]: the step moved no parameter")
    print(f"train reference [{path}]: parameters agree after one Adam step (largest "
          f"move {moved:.3g})")


def train_slice_phase(model, B, path="train", timed=TIMED_RUNS):
    """Full-width training steps on `path` of `PATHS`: 1 warm-up and
    `timed` timed steps, the launch counters set to 0 just before and read
    just after (each kernel of the path once per step, no other); the loss
    on the batch with fixed draws must fall. Restores the initial weights.
    Returns (launches, median ms, peak bytes)."""
    import torch
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    batch = fake_batch(model, B, SEED)
    phase = model.phase_for_iter(TRAIN_IT)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    if not model.netBase._use_fused_sweep(training=True):
        raise AssertionError(f"{path}: the fused sweep is off")
    print(f"{path}: iter {TRAIN_IT} phase {phase} grid {grid.res} v_cap "
          f"{v_cap} f_cap {f_cap} batch {B} raster_variant "
          f"{model.raster_variant} resolve_rows {model.resolve_rows}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model)
    gen = torch.Generator(device=model.device).manual_seed(SEED)
    fixed = draw_noise(model, torch.Generator().manual_seed(SEED), B)

    def fixed_loss():
        # the loss on the same batch with the same draws, without a step
        g = torch.Generator(device=model.device).manual_seed(SEED + 1)
        with torch.no_grad():
            loss, _ = model.forward(batch, TRAIN_IT, g, phase, noise=fixed)
        return float(loss)
    first = fixed_loss()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    steps = WARMUP_RUNS + timed
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(model, opt, batch, TRAIN_IT, gen, phase)
        torch.cuda.synchronize()
        if i >= WARMUP_RUNS:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    launches = check_counts(path, steps)
    peak = torch.cuda.max_memory_allocated()
    last = fixed_loss()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: non-finite loss in {losses}")
    if not last < first:
        raise AssertionError(f"{path}: the loss on the trained batch (same "
                             f"draws) went {first} -> {last}")
    after = model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    finite = all(bool(torch.isfinite(v).all()) for v in after.values()
                 if v.is_floating_point())
    vit_same = all(torch.equal(before[k], after[k]) for k in before
                   if ".ViT." in k)
    if not (changed > 40 and finite and vit_same):
        raise AssertionError(f"{path}: {changed} tensors changed, finite "
                             f"{finite}, ViT untouched {vit_same}")
    med = statistics.median(times)
    print(f"{path}: losses per step {[round(x, 4) for x in losses]}; loss on "
          f"the batch with fixed draws {first:.4f} -> {last:.4f}")
    print(f"{path}: train_step median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} steps (spread "
          f"{(max(times) - min(times)) / med * 100:.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB, launches in {steps} steps "
          f"{ {k: v for k, v in launches.items() if v} }, {changed} "
          f"parameter tensors changed; card {card_line()}")
    model.load_state_dict(before)
    return launches, med, peak


def slice_phase(**render):
    """The full-width model (with the render selectors `render`), its
    images and sizes: (model, images, it, B, H)."""
    import torch
    from animals3d_tpu_torch.precision import set_mixed_precision
    cfg, model = build([], "cuda", **render)
    set_mixed_precision(cfg.get("mixed_precision"))
    model.init_params(SEED)
    B = cfg["dataset"]["batch_size"]
    H = model.in_image_size
    rng = np.random.default_rng(SEED)
    images = torch.as_tensor(
        rng.uniform(0, 1, (B, 1, 3, H, H)).astype(np.float32), device="cuda")
    it = 50000
    phase = model.phase_for_iter(it, is_training=False)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    vit = cfg["model"]["cfg_predictor_instance"]["cfg_encoder"]["which_vit"]
    print(f"slice: {cfg['model']['name']} iter {it} phase {phase} "
          f"grid {grid.res} v_cap {v_cap} f_cap {f_cap} batch {B} {H}x{H} "
          f"{vit} compute {cfg.get('mixed_precision')}")
    return model, images, it, B, H


def drive(model, images, it, timed=TIMED_RUNS):
    """Warm-up and timed `reconstruct` runs."""
    import torch
    times = []
    shaded = out = None
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_RUNS + timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shaded, out = model.reconstruct(model, images, it)
        torch.cuda.synchronize()
        if i >= WARMUP_RUNS:
            times.append((time.perf_counter() - t0) * 1e3)
    return shaded, out, times, WARMUP_RUNS + timed


def recon_path(model, images, it, B, H, path, timed=TIMED_RUNS):
    """`reconstruct` on `path` of `PATHS`, its launches counted from 0 (each
    kernel of the path once per render, no other). Returns (shaded,
    launches, median ms, peak bytes)."""
    import torch
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    reset_counts()
    shaded, out, times, renders = drive(model, images, it, timed)
    launches = check_counts(path, renders)
    alpha = check_slice(shaded, out, B, H)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"{path}: reconstruct median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} runs (spread "
          f"{(max(times) - min(times)) / med * 100:.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} GiB allocated "
          f"before the path: the models built so far), mask px per image "
          f"{alpha.tolist()}, "
          f"launches in {renders} renders "
          f"{ {k: v for k, v in launches.items() if v} }; card {card_line()}")
    return shaded, launches, med, peak


def renders_against_k1(model, images, it):
    """One more `reconstruct` of `model` with every render's rasterization
    recorded, and each render's z and face_id against K1's on the same
    posed meshes: identical for variant 4; for variant 6 identical but at
    the pixels `v6_against_k1` allows. Returns (renders, pixels that
    differ, (B, H, W) mask of them)."""
    import torch
    import animals3d_tpu_torch.render.render as rr
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    real, calls = rr.rasterize_cuda, []

    def recording(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out
    rr.rasterize_cuda = recording
    try:
        model.reconstruct(model, images, it)
    finally:
        rr.rasterize_cuda = real
    n, mask = 0, None
    for args, kw, out in calls:
        variant = kw.get("variant", 3)
        k1 = real(*args, **dict(kw, variant=3))
        got = (out.z, out.face_id)
        if variant == 6:
            prep = rc.prepare(args[0], kw["v_pos0"], args[1], args[2],
                              args[3], variant=6)
            m, diff = v6_against_k1("render with variant 6", got,
                                    (k1.z, k1.face_id), prep)
            n += m["skip"] + m["scan"]
            mask = diff if mask is None else mask | diff
        else:
            same_outputs(f"render with variant {variant}", got,
                         (k1.z, k1.face_id), ("z", "face_id"))
    torch.cuda.synchronize()
    return len(calls), n, mask


def check_slice(shaded, out, B, H):
    import torch
    if tuple(shaded.shape) != (B, 4, H, H):
        raise AssertionError(f"shaded shape {tuple(shaded.shape)}")
    if not bool(torch.isfinite(shaded).all()):
        raise AssertionError("shaded has non-finite values")
    for name, i in (("mvp", 3), ("arti_params", 9), ("light_params", 10)):
        if out[i] is None or not bool(torch.isfinite(out[i]).all()):
            raise AssertionError(f"{name} missing or non-finite")
    if not bool(torch.isfinite(out[0].v_pos).all()):
        raise AssertionError("posed vertices are non-finite")
    alpha = (shaded[:, 3] > 0).flatten(1).sum(1)
    if not bool((alpha > 0).all()):
        raise AssertionError(f"empty mask in an image: {alpha.tolist()}")
    return alpha


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 off")

    t0 = time.perf_counter()
    print(rc.build())
    print(f"build: {time.perf_counter() - t0:.1f} s")

    reference_phase()
    train_reference_phase("train")
    train_reference_phase("train_v6_kernel_rows")

    model, images, it, B, H = slice_phase()
    from animals3d_tpu_torch.data.synth import fake_batch
    batch = fake_batch(model, B, SEED)
    entries = visibility_phase(model, images, it, torch.device("cuda"), batch)
    entries["fused_mlp_fwd"], entries["fused_mlp_bwd"] = sweep_phase(model)
    entries["resolve_bwd"] = resolve_phase(model, batch)
    entries["resolve_fwd"] = resolve_fwd_phase(model, batch)

    # the paths, each with the launch counters set to 0 just before it
    state = model.state_dict()
    by_path, summary = {}, {}
    by_path["train"], *summary["train"] = train_slice_phase(model, B)
    _cfg, m6 = build([], "cuda", **PATHS["train_v6_kernel_rows"][0])
    m6.load_state_dict(state)
    by_path["train_v6_kernel_rows"], *summary["train_v6_kernel_rows"] = \
        train_slice_phase(m6, B, "train_v6_kernel_rows", timed=3)
    shaded, by_path["recon"], *summary["recon"] = recon_path(
        model, images, it, B, H, "recon")
    again, _out = model.reconstruct(model, images, it)
    _cfg, m4 = build([], "cuda", **PATHS["recon_v4"][0])
    m4.load_state_dict(state)
    _s4, by_path["recon_v4"], *summary["recon_v4"] = recon_path(
        m4, images, it, B, H, "recon_v4", timed=3)
    n, _px, _m = renders_against_k1(m4, images, it)
    print(f"recon_v4: z and face_id of {n} render(s) identical to K1's on "
          "the same posed meshes")
    s6, by_path["recon_v6_kernel_rows"], *summary["recon_v6_kernel_rows"] = \
        recon_path(m6, images, it, B, H, "recon_v6_kernel_rows", timed=3)
    n, px, mask = renders_against_k1(m6, images, it)
    # the antialias pass blends a pixel with its neighbours: leave out the
    # pixels within 2 of one whose winner differs from K1's
    keep = torch.ones_like(shaded[:, :1], dtype=torch.bool)
    if mask is not None:
        near = torch.nn.functional.max_pool2d(
            mask.float()[:, None], 5, stride=1, padding=2) > 0
        keep = ~near
    own = float((again - shaded).abs().max())
    gap = float(((s6 - shaded).abs() * keep).max())
    print(f"recon_v6_kernel_rows: z and face_id of {n} render(s) identical "
          f"to K1's but at {px} pixels (`v6_against_k1`); shaded max "
          f"|v6 + kernel rows - default| = {gap:.3g} "
          f"away from those ({int((~keep).sum())} pixels left out; the "
          f"default path against itself: {own:.3g}; tolerance "
          f"{IMAGE_TOL:g})")
    if not gap <= IMAGE_TOL:
        raise AssertionError(f"recon_v6_kernel_rows: images differ by {gap}")
    print("paths (ms, peak GiB): " + ", ".join(
        f"{k} {ms:.2f} ms {peak / 2**30:.2f} GiB"
        for k, (ms, peak) in summary.items()) + f"; card {card}")

    # `launches`: the count on the path that drives the kernel's slice
    own_path = {"raster_vis_v4": "recon_v4",
                "unit_boxes": "train_v6_kernel_rows",
                "raster_vis_v6": "train_v6_kernel_rows",
                "resolve_fwd": "train_v6_kernel_rows"}
    order = ("cull_boxes", "unit_boxes", "raster_vis", "raster_vis_v4",
             "raster_vis_v6",
             "resolve_bwd", "resolve_fwd", "fused_mlp_fwd", "fused_mlp_bwd")
    kernels = []
    for name in order:
        e = entries[name]
        e["launches"] = by_path[own_path.get(name, "train")][name]
        e["launches_train"] = by_path["train"][name]
        e["launches_recon"] = by_path["recon"][name]
        e["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        kernels.append(e)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
