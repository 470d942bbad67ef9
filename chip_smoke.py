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
     resolve_rows="kernel"` (K3 and K5 on the card); then one step of a
     small float32 3D-Fauna model (`train_fauna` at the parity tests'
     widths, grid 8, iteration 100,000: the memory bank, the modulated
     SDF, the random view and the mask discriminator) the same way, on a
     seed where the random view's mask agrees within 1e-3;
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
     to the default path's within 1e-6);
  5. the port's CLI (`animals3d_tpu_torch.run.main`) at the same widths on
     synthetic folders of 20 train and 10 test images (`cli_phase`):
     `cli_train` — 3 iterations from 0 (a checkpoint every 2, the eval
     forward's files at 3) and a resume to 4 from the saved Adam state,
     checked bit for bit; `cli_train_fine` — 2 steps from a checkpoint of
     the init weights at iteration 100,000 (grid 256, deformation,
     attached legs), with each step's time and the peak memory;
     `cli_test_fine` — the test config at grid 256 writing mesh, image
     and pose files; then K1 and the cull kernel against their plain
     versions on the fine step's own posed meshes, bit for bit;
  6. 3D-Fauna at the full width of `train_fauna` (batch 6 at 256²,
     dino_vits8 random, bf16, DINO features of 16, bank 60 × 128 with top
     10, grid 128, `v_cap` 98,304, `f_cap` 196,608, iteration 100,000:
     the discriminator window, articulation on, legs attached, no
     deformation): `fauna_train` — 1 + 3 steps of `train_step` and the
     discriminator's `disc_step` (the cull kernel and K1 twice a step, K4
     once, K6 and K7 never), each step's and the discriminator step's
     time, the peak memory, one step's device busy time (torch.profiler)
     and the plain modulated sweep's time alone, then K1, the cull kernel
     and K4 against their plain versions on one step's own calls, the
     random view's meshes among them; `fauna_recon` — `reconstruct`
     through the bank (1 + 5; the cull kernel and K1 once a recon);
     `cli_train_fauna` — `python -m animals3d_tpu_torch.run --config-name
     train_fauna` on a synthetic category tree (2 categories of 9 images),
     2 steps from a checkpoint of the init weights at 100,000, its
     checkpoint holding `netDisc` and the `disc` Adam's state, and a
     resume one step further with that state restored bit for bit;
  7. Ponymation at the widths of `train_ponymation_horse_stage{1,2}`
     (256², dino_vits8 random, bf16, DINO features of 16, grid 128,
     iteration 100,000: deformation, articulation, attached legs; netBase
     frozen, so K6 runs and K7 never), after a small float32 step of each
     stage against the CPU in phase 2 (grid 8, spp 2, 3 frames):
     `pony_stage1_train` — 1 + 3 steps on 1 × 10 frames at spp 4 (the
     cull kernel and K1 at 10 × 1024², K4 at 256² on the subsampled rast,
     K6; only netArticulation moves), one step's device busy time, the
     busiest image's silhouette pairs against the antialias cap (a
     warning where it overflows: both packages drop the pairs beyond it),
     K1 and the cull kernel against their plain versions bit for bit on
     frames 0 and 9 of one step's render and timed at 1024² (K1's bound
     there), K4 on the step's own call; `pony_stage1_fine` — 2 steps at
     150,000 (grid 256, `f_cap` 786,432), the same checks;
     `pony_stage2_train` — 1 + 3 steps on 20 × 10 frames with the render
     off (K6 alone; only netVAE moves); `pony_generate` — stage 2's eval
     forward (1 of the 200 frames, 10 generated frames from the default
     camera; the cull kernel and K1 once); `cli_train_pony` — the CLI on
     a synthetic tree of 2 sequences of 10 frames with flows: stage 1
     resumed at 100,000 from a MagicPony checkpoint, stage 2 from stage
     1's, a resume of stage 2 with its Adam state restored bit for bit,
     and stage 1's test with flows writing the flow files;
  8. the offline tools (`vis_slice`), after a small float32 Visualizer
     run on the card against the CPU in phase 2 (`vis_reference`: grid 16,
     64², spp 2, every mode, cv2 hidden so that every video frame is
     compared): the Visualizer (`python -m animals3d_tpu_torch.
     visualization`, in-process) at resolution 256, spp 4 and the fine
     grid 256 on one image with the checkpoints the CLI phases of 5–7
     kept — `vis_magicpony` (every mode, two keyframe files, the texture
     finetune in MagicPony's loss), `vis_fauna` and `vis_pony` (their
     configs' modes; Fauna's finetune in its L1) — each with the keypoint
     artifacts and `animals3d_tpu_torch.evaluation` over them, the wall
     time by mode, a rotation render's, the peak, the launches (one cull
     and one K1 a render, K6 once a MagicPony finetune step, K7 and K4
     never) and the antialias cap's dropped share; `cli_test_fauna` and
     `cli_test_pony` — the test configs through the CLI on a synthetic
     sequence; `log_visuals` — 2 steps of `train_magicpony_horse` with
     the visuals and turntables logged after each (to a tag recorder) and
     one `_log_visuals` call's time.

Prints a `kernels` JSON line (all nine kernel entries, each with its
status: ported, redesigned or fused, and in which PR; `unit_boxes` is the
cull kernel's instantiation that also writes the unit boxes; `launches`
is the count on the path that drives the kernel — `recon_v4` for K2,
`train_v6_kernel_rows` for the unit boxes, K3 and K5, the default
training path for the others — and `launches_by_path` the counts on
every path, the CLI's included; K1's and the cull kernel's also carry
`pony_1024`, their times at 1024² on the Ponymation steps), the card's name
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
        prior, _sdf, *_ = model.forward_base(grid, v_cap, f_cap)
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
        prior, _sdf, *_ = model.forward_base(grid, v_cap, f_cap)
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

def build(overrides, device, config="train_magicpony_horse", **render):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    cfg = cfglib.load_config(config, overrides=overrides)
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
    # the port's CLI (`animals3d_tpu_torch.run`): the coarse loop from
    # iteration 0 and its resume, two steps at the fine grid, and the test
    # config's eval forward at the fine grid
    "cli_train": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                       "fused_mlp_bwd", "resolve_bwd")),
    "cli_train_fine": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                            "fused_mlp_bwd", "resolve_bwd")),
    "cli_test_fine": ({}, ("cull_boxes", "raster_vis")),
    # 3D-Fauna (`train_fauna`): the step renders the input view and, inside
    # the discriminator window, a random view (the cull kernel and K1
    # twice); K4 runs once, on the input view's backward: the random
    # view's render is untextured and unlit, so only its antialiased mask
    # reaches a loss. The modulated SDF keeps the fused sweep off
    "fauna_train": ({}, ("cull_boxes", "raster_vis", "resolve_bwd")),
    "fauna_recon": ({}, ("cull_boxes", "raster_vis")),
    "cli_train_fauna": ({}, ("cull_boxes", "raster_vis", "resolve_bwd")),
    # Ponymation: stage 1 renders at spp 4 (the cull kernel and K1 at
    # 1024², K4 at 256² on the subsampled rast), netBase sweeps through K6
    # but is frozen, so K7 never runs; stage 2 renders nothing (K6 alone);
    # `generate` renders the generated frames at spp 1 without a sweep
    "pony_stage1_train": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                               "resolve_bwd")),
    "pony_stage1_fine": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                              "resolve_bwd")),
    "pony_stage2_train": ({}, ("fused_mlp_fwd",)),
    "pony_generate": ({}, ("cull_boxes", "raster_vis")),
    "cli_train_pony": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                            "resolve_bwd")),
    # the Visualizer (`animals3d_tpu_torch.visualization`) at the fine grid,
    # spp 4: one cull and one K1 a render; MagicPony's texture finetune
    # steps at the training phase sweep through K6, and their backward
    # reaches netTexture alone: no K7, and no K4 (no vertex takes a
    # gradient). Fauna's finetune is on the eval-phase nets (the plain
    # modulated sweep), Ponymation's Visualizer does not finetune
    "vis_magicpony": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd")),
    "vis_fauna": ({}, ("cull_boxes", "raster_vis")),
    "vis_pony": ({}, ("cull_boxes", "raster_vis")),
    # the test configs through the CLI: eval forwards at the fine grid
    "cli_test_fauna": ({}, ("cull_boxes", "raster_vis")),
    "cli_test_pony": ({}, ("cull_boxes", "raster_vis")),
    # two training steps with the visuals and turntables logged after each
    "log_visuals": ({}, ("cull_boxes", "raster_vis", "fused_mlp_fwd",
                         "fused_mlp_bwd", "resolve_bwd")),
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
    """Every kernel of `path` launched `runs` times (a number, or one by
    kernel name) since `reset_counts`, every other kernel not at all;
    returns the counts."""
    launches = {name: k.launches for name, k in counters().items()}
    want = PATHS[path][1]
    for name, n in launches.items():
        runs_k = runs.get(name, 0) if isinstance(runs, dict) else runs
        if n != (runs_k if name in want else 0):
            raise AssertionError(f"{path}: {name} launched {n} times in "
                                 f"{runs_k} runs")
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


def draw_noise(model, gen, B):
    """One training forward's draws for a batch of B sequences, on the
    CPU, so that two devices can be handed the same ones (Ponymation's
    VAE ε where the model has the VAE)."""
    import torch
    from animals3d_tpu_torch.noise import Noise
    K = model.netInstance.num_pose_hypos
    n_images = B * model.num_frames
    u = lambda *shape: torch.rand(shape, generator=gen)
    vae = None
    if getattr(model.netInstance, "enable_motion_vae", False):
        c = model.cfg_motion_vae
        vae = torch.randn((c.z_token_num, B, c.latent_dim), generator=gen)
    return Noise(jitter_u=u(), rand_idx=torch.floor(u(n_images) * K).long(),
                 best_u=u(n_images), rand_pts_u=u(5000, 3),
                 surf_idx=None, surf_u=u(5000, 3),
                 rv_deg=torch.floor(u(n_images) * 360).long(),
                 vae_normal=vae)


def train_reference_phase(path="train", config="train_magicpony_horse",
                          overrides=None, it=TRAIN_IT):
    """One training step of a small float32 model of `config` (with
    `overrides`, by default `TRAIN_SMALL_OVERRIDES`) at iteration `it` on
    the card against the same step on the CPU, from the same weights,
    batch and noise, on the render path `path` of `PATHS` (the card's
    kernels against their plain versions on the CPU): loss to
    1e-4 relative (7e-7 seen), every parameter's gradient to
    `REF_GRAD_TOL` of its norm (2e-3; 9.1e-4 seen on the articulation
    leaves, 6.2e-4 on the encoder's, 4.0e-4 on netSDF's), `REF_NOISY_TOL`
    on netTexture and on the first two layers of netDINO (2e-2; 9.0e-3
    seen on netTexture's in-layer, 2.4e-3 on its later layers, 3e-5 on
    netDINO's), no NaN or inf, a gradient for every trainable parameter
    the phase uses and none for the ViT (nor for Ponymation's frozen
    nets). A leaf whose CPU gradient is under 1e-6 of the largest leaf's
    norm is zero in exact arithmetic (the VAE's attention key biases) and
    is held to stay under 1e-5 of it on the card.

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
    agrees within 1e-4 (and, for Fauna, the random view's mask, the
    discriminator's input, within 1e-3 on every pixel), at most 16 seeds.
    And which face wins a pixel on a
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
    overrides = TRAIN_SMALL_OVERRIDES if overrides is None else overrides
    _cfg, gpu = build(overrides, "cuda", config, **render)
    state = {k: v.detach().cpu().clone()
             for k, v in gpu.init_params(SEED).items()}
    _cfg, cpu = build(overrides, "cpu", config, **render)
    cpu.load_state_dict(state)
    phase = gpu.phase_for_iter(it)
    # the fused sweep: on for MagicPony's netSDF, off for the modulated one
    if gpu.netBase._use_fused_sweep(training=True) != \
            (gpu.netBase.condition_choice != "mod"):
        raise AssertionError(f"train reference [{path}]: the fused sweep's "
                             "gate is wrong")
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
                loss, (met, aux) = model.forward(batches[name], it,
                                                 None, phase, noise=noise)
                if grad:
                    loss.backward()
            out[name] = (loss.detach().cpu(), aux, met)
        return out

    for seed in range(16):
        gen = torch.Generator().manual_seed(seed)
        noise = draw_noise(cpu, gen, B)
        grid, v_cap, f_cap = cpu.grid_for_phase(phase)
        with torch.no_grad():
            prior, _sdf, *_ = cpu.forward_base(
                grid, v_cap, f_cap, jitter=noise.jitter_u,
                batch=batches["cpu"])
        noise = dataclasses.replace(noise, surf_idx=torch.floor(
            torch.rand(5000, generator=gen)
            * max(int(prior.num_verts), 1)).long())
        out = both(noise, grad=False)
        a_gpu, a_cpu = out["gpu"][1], out["cpu"][1]
        d = lambda k: (a_gpu[k].detach().cpu() - a_cpu[k].detach()).abs()
        arti = float(d("arti_params").max())
        # Fauna's random view: its mask is the discriminator's input, and no
        # pixel of it can be taken out through the batch
        rv = 0.0
        if "_disc_record" in out["cpu"][2]:
            rv = float((out["gpu"][2]["_disc_record"]["mask_rv"][:, 0].cpu()
                        - out["cpu"][2]["_disc_record"]["mask_rv"][:, 0])
                       .abs().max())
        if a_cpu["mask_pred"] is None:          # a step that renders nothing
            differ = torch.zeros(batches["cpu"]["mask_valid"].shape,
                                 dtype=torch.bool)
        else:
            differ = (d("mask_pred") > 1e-3) \
                | (d("image_pred").amax(2) > 1e-3) \
                | (d("dino_pred").amax(2) > 1e-3) \
                | ((a_gpu["mask_pred"].cpu() > 0) != (a_cpu["mask_pred"] > 0))
        share = float(differ.float().mean())
        print(f"train reference [{path}]: seed {seed}: articulation |gpu - cpu| "
              f"{arti:.3g}, share of pixels that differ {share:.4f}"
              + (f", random view's mask max |gpu - cpu| {rv:.3g}"
                 if "_disc_record" in out["cpu"][2] else ""))
        if arti <= 1e-4 and rv <= 1e-3:
            break
    else:
        raise AssertionError(f"train reference [{path}]: no seed of 16 on which "
                             "the card and the CPU pick the same feet (and "
                             "the same random view's mask)")
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
    l_gpu, l_cpu = out["gpu"][0], out["cpu"][0]
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
    top = max(float(q.grad.norm()) for q in cpu.parameters()
              if q.grad is not None)
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
            # unused in the phase (netDeform), or frozen (Ponymation)
            if not (name.startswith("netInstance.netDeform.")
                    or not q.requires_grad):
                raise AssertionError(f"train reference [{path}]: {name} has no grad")
            continue
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"train reference [{path}]: {name}: non-finite grad")
        gap[name] = float((p.grad.cpu() - q.grad).abs().max())
        if float(q.grad.norm()) <= 1e-6 * top:
            # zero in exact arithmetic (an attention's key bias), rounding
            # noise on either device: both must stay at that size
            if not float(p.grad.norm()) <= 1e-5 * top:
                bad.append(f"{name}: {float(p.grad.norm()):.3g} (zero leaf)")
            continue
        err = float((p.grad.cpu() - q.grad).norm() / q.grad.norm())
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


# ---------------------------------------------------------------------------
# 3D-Fauna at the full width of `train_fauna`
# ---------------------------------------------------------------------------

FAUNA_IT = 100000       # disc window, articulation on, legs attached
FAUNA_TIMED = 3
# the reference model: `tests/test_fauna.py`'s widths and grid (8: at 16
# the random view's mask differs between the card and the CPU by a flipped
# face on each of the first 16 seeds, and the discriminator's gradient
# follows its input)
FAUNA_SMALL_OVERRIDES = [
    "dataset.in_image_size=64",
    "dataset.out_image_size=64",
    "dataset.batch_size=2",
    "dataset.dino_feature_dim=4",
    "model.cfg_predictor_base.cfg_shape.grid_res=8",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=8",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_base.cfg_bank.memory_bank_size=14",
    "+model.cfg_predictor_base.cfg_bank.memory_bank_topk=3",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.num_layers=2",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.num_layers=1",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.num_layers=2",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
]
CLI_FAUNA_CATEGORIES, CLI_FAUNA_IMAGES = ("bear", "horse"), 9


def fauna_batch(model, B):
    """`fake_batch` with the Fauna dataset's 9-column boxes."""
    import torch
    from animals3d_tpu_torch.data.synth import fake_batch
    batch = fake_batch(model, B, SEED)
    batch["bboxs"] = torch.zeros((B, 1, 9), device=model.device)
    return batch


def recorded_calls(every: int = 1):
    """A context in which every render's `rasterize_cuda` call (every
    `every`-th, counting from the first) keeps a copy of its inputs (a
    visibility scene) and every `resolve_bwd` call its cotangent and
    winner ids; yields ({"scenes", "k4"} lists)."""
    import contextlib
    import animals3d_tpu_torch.ops.rasterize as ro
    import animals3d_tpu_torch.render.render as rr

    @contextlib.contextmanager
    def ctx():
        rec = {"scenes": [], "k4": []}
        real_r, real_b = rr.rasterize_cuda, ro.resolve_bwd
        seen = [0]

        def rast(v_clip, faces, f_valid, res, **kw):
            if seen[0] % every == 0:
                rec["scenes"].append((v_clip.detach().clone(),
                                      kw["v_pos0"].detach().clone(),
                                      faces.clone(), f_valid.clone(),
                                      tuple(res), 1024))
            seen[0] += 1
            return real_r(v_clip, faces, f_valid, res, **kw)

        def bwd(g, face_id, num_faces):
            rec["k4"].append((g.detach().clone(), face_id.clone(),
                              num_faces))
            return real_b(g, face_id, num_faces)
        rr.rasterize_cuda, ro.resolve_bwd = rast, bwd
        try:
            yield rec
        finally:
            rr.rasterize_cuda, ro.resolve_bwd = real_r, real_b
    return ctx()


def k4_call_check(name, call):
    """K4 against its plain version on one recorded call: exact where no
    face collects two pixels, else within 1e-5 of the largest entry (the
    order of the float32 atomics changes from run to run)."""
    import torch
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    g, fid, Fn = call
    got = rv.resolve_bwd(g, fid, Fn)
    torch.cuda.synchronize()
    want = rv.resolve_bwd_reference(g, fid, Fn)
    per_face = torch.bincount(fid[fid > 0].long())
    err = float((got - want).abs().max())
    tol = 0.0 if int(per_face.max()) <= 1 else 1e-5 * float(want.abs().max())
    print(f"resolve_bwd[{name}]: {tuple(g.shape)} {str(g.dtype)[6:]} F={Fn} "
          f"foreground px {int((fid > 0).sum())}, nonzero cotangent rows "
          f"{int((g != 0).any(-1).sum())}, max|err| {err:.3g} (tol "
          f"{tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"resolve_bwd[{name}] differs by {err}")


def device_busy_ms(fn):
    """The device's busy time (ms) of one `fn()`: the union of the CUDA
    events' intervals that `torch.profiler` records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for s_, e_ in spans:
        if e_ > end:
            busy += e_ - max(s_, end)
            end = e_
    return busy / 1e3, len(spans)


def fauna_slice():
    """The full-width Fauna model (`train_fauna`: batch 6 at 256²,
    dino_vits8 with random weights, bf16, DINO features of 16, bank 60 ×
    128 with top 10, grid 128), its init state and sizes."""
    from animals3d_tpu_torch.precision import set_mixed_precision
    cfg, model = build([], "cuda", "train_fauna")
    set_mixed_precision(cfg.get("mixed_precision"))
    state = {k: v.clone() for k, v in model.init_params(SEED).items()}
    B = cfg["dataset"]["batch_size"]
    phase = model.phase_for_iter(FAUNA_IT)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    bank = model.cfg_bank
    vit = cfg["model"]["cfg_predictor_instance"]["cfg_encoder"]["which_vit"]
    print(f"fauna: iter {FAUNA_IT} phase {phase} grid {grid.res} v_cap "
          f"{v_cap} f_cap {f_cap} batch {B} {model.in_image_size}² {vit} "
          f"compute {cfg.get('mixed_precision')} DINO features "
          f"{model.dino_feature_dim} bank {bank.memory_bank_size} x "
          f"{bank.memory_bank_dim} top {bank.memory_bank_topk}")
    if not (phase.disc_on and phase.articulation_on and phase.attach_legs
            and not phase.deform_on):
        raise AssertionError(f"fauna: phase {phase}")
    if model.netBase._use_fused_sweep(training=True):
        raise AssertionError("fauna: the fused sweep is on for the "
                             "modulated SDF")
    if (v_cap, f_cap, grid.res) != (98304, 196608, 128):
        raise AssertionError(f"fauna: caps {v_cap} {f_cap} grid {grid.res}")
    return model, state, B


def fauna_train_phase(model, state, B, card):
    """Full-width Fauna steps at `FAUNA_IT`: `train_step` then the
    discriminator's `disc_step` on the recorded masks, 1 warm-up and
    `FAUNA_TIMED` timed, the launch counters set to 0 just before and read
    just after (per step: the cull kernel and K1 twice, K4 once, K6 and K7
    never); every loss finite (the loss on the batch with fixed draws is
    printed before and after: Adam's first steps at netBase's lr 1e-3 from
    random weights need not lower it); `netDisc` moved by its own Adam. Then, outside the counted run: one step's
    device busy time, the plain modulated sweep alone (forward, and
    forward + backward, over the jittered 129³ lattice), and K1, the cull
    kernel and K4 against their plain versions on one step's own calls
    (the input view's and the random view's meshes). Returns (launches,
    summary)."""
    import torch
    from animals3d_tpu_torch.trainer import (disc_step, make_optimizer,
                                             train_step)
    model.load_state_dict(state)
    batch = fauna_batch(model, B)
    phase = model.phase_for_iter(FAUNA_IT)
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fixed = draw_noise(model, torch.Generator().manual_seed(SEED), B)

    def fixed_loss():
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        with torch.no_grad():
            loss, _ = model.forward(batch, FAUNA_IT, g, phase, noise=fixed)
        return float(loss)

    def step():
        met = train_step(model, opt, batch, FAUNA_IT, gen, phase)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dl = disc_step(model, opt, met.pop("_disc_record"))
        return met, dl, t1
    first = fixed_loss()
    disc0 = {k: v.clone() for k, v in model.netDisc.state_dict().items()}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, gen_ms, disc_ms, losses, dlosses = [], [], [], [], []
    steps = WARMUP_RUNS + FAUNA_TIMED
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met, dl, t1 = step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= WARMUP_RUNS:
            times.append((t2 - t0) * 1e3)
            gen_ms.append((t1 - t0) * 1e3)
            disc_ms.append((t2 - t1) * 1e3)
        losses.append(float(met["loss"]))
        dlosses.append(float(dl))
    launches = check_counts("fauna_train", {
        "cull_boxes": 2 * steps, "raster_vis": 2 * steps,
        "resolve_bwd": steps})
    peak = torch.cuda.max_memory_allocated()
    last = fixed_loss()
    if not (all(np.isfinite(losses)) and all(np.isfinite(dlosses))):
        raise AssertionError(f"fauna_train: losses {losses} {dlosses}")
    if not np.isfinite(last):
        raise AssertionError(f"fauna_train: the loss on the trained batch "
                             f"(same draws) went {first} -> {last}")
    moved = sum(not torch.equal(disc0[k], v)
                for k, v in model.netDisc.state_dict().items())
    if moved != len(disc0) or len(opt.disc.state) != len(disc0):
        raise AssertionError(f"fauna_train: {moved} of {len(disc0)} netDisc "
                             "tensors moved")
    med = statistics.median(times)
    print(f"fauna_train: losses per step {[round(x, 4) for x in losses]}, "
          f"discriminator {[round(x, 4) for x in dlosses]}; loss on the "
          f"batch with fixed draws {first:.4f} -> {last:.4f}")
    print(f"fauna_train: step (train_step + disc_step) median {med:.2f} ms "
          f"per batch of {B} ({B / med * 1e3:.2f} imgs/s), min "
          f"{min(times):.2f} max {max(times):.2f} ms over {len(times)} steps "
          f"(spread {(max(times) - min(times)) / med * 100:.1f}%); "
          f"train_step median {statistics.median(gen_ms):.2f} ms, disc_step "
          f"median {statistics.median(disc_ms):.2f} ms; peak memory "
          f"{peak / 2**30:.2f} GiB; launches in {steps} steps "
          f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    busy, n_events = device_busy_ms(step)
    print(f"fauna_train: one step's device busy time {busy:.3f} ms "
          f"({n_events} device events); card {card}")

    # the plain modulated sweep alone, at the step's grid and condition
    grid, _v, _f = model.grid_for_phase(phase)
    shape_cfg = model.cfg_predictor_base.cfg_shape
    pos = grid.verts * shape_cfg.spatial_scale
    with torch.no_grad():
        cls_tok = model.netInstance.frozen_vit_class_token(batch["images"])
        feats = model.netBase.retrieve_memory_bank(cls_tok)[0][None]

    def sweep_fwd():
        with torch.no_grad():
            return model.netBase.get_sdf(pos, feats)

    def sweep_fwd_bwd():
        model.netBase.get_sdf(pos, feats)[..., 0].sum().backward()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sweep_fwd_bwd()
    sweep_peak = torch.cuda.max_memory_allocated() - base
    fwd_ms = statistics.median(cuda_ms(sweep_fwd, 3))
    fb_ms = statistics.median(cuda_ms(sweep_fwd_bwd, 3))
    model.zero_grad(set_to_none=True)
    print(f"fauna_train: the plain modulated sweep over {pos.shape[0]} "
          f"lattice rows (CoordMLPMod, {shape_cfg.num_layers} x "
          f"{shape_cfg.hidden_size}, float32 LinearMod): forward "
          f"{fwd_ms:.2f} ms, forward + backward {fb_ms:.2f} ms "
          + (f"({fb_ms / busy * 100:.1f}% of the step's device busy time), "
             if busy > 0 else "(the profiler saw no device time), ")
          + f"its own peak above the resident {sweep_peak / 2**30:.2f} GiB; "
          f"card {card}")

    # the kernels on one step's own calls, against their plain versions
    with recorded_calls() as rec:
        step()
    torch.cuda.synchronize()
    if len(rec["scenes"]) != 2 or len(rec["k4"]) != 1:
        raise AssertionError(f"fauna_train: {len(rec['scenes'])} renders, "
                             f"{len(rec['k4'])} resolve backwards")
    for name, scene in zip(("fauna_input_view", "fauna_random_view"),
                           rec["scenes"]):
        k1_scene_check(name, scene)
    k4_call_check("fauna_input_view", rec["k4"][0])
    model.load_state_dict(state)
    return launches, {"fauna_train": (med, peak),
                      "fauna_train_disc_step": (statistics.median(disc_ms),
                                                peak)}


def fauna_recon_path(model, state, B, card):
    """`reconstruct` of batch 6 through the bank (class tokens → the bank →
    the conditioned prior → the instance forward → the input view), 1
    warm-up and 5 timed, each kernel once a recon. Returns (launches,
    median ms, peak bytes)."""
    import torch
    model.load_state_dict(state)
    H = model.in_image_size
    rng = np.random.default_rng(SEED)
    images = torch.as_tensor(
        rng.uniform(0, 1, (B, 1, 3, H, H)).astype(np.float32), device="cuda")
    reset_counts()
    shaded, out, times, renders = drive(model, images, FAUNA_IT)
    launches = check_counts("fauna_recon", renders)
    alpha = check_slice(shaded, out, B, H)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"fauna_recon: reconstruct median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} runs, peak memory "
          f"{peak / 2**30:.2f} GiB, mask px per image {alpha.tolist()}, "
          f"launches in {renders} renders "
          f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    return launches, med, peak


def cli_fauna_phase(card, keep=None):
    """`python -m animals3d_tpu_torch.run --config-name train_fauna` at full
    width on a synthetic category tree (`large_scale/<category>`, 2
    categories of `CLI_FAUNA_IMAGES` images at 256², DINO features of 16):
    2 steps from a checkpoint of the init weights at `FAUNA_IT` (its
    `disc` Adam state empty), whose checkpoint must hold `netDisc` and the
    `disc` Adam's state; then a resume one step further, whose restored
    `disc` Adam state must equal the saved one bit for bit. Returns
    (launches, (median step ms, peak bytes)). With `keep` (a directory),
    the last checkpoint is moved there as `fauna.pth`."""
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.trainer import make_optimizer
    root = tempfile.mkdtemp(prefix="chip_smoke_fauna_")
    try:
        data = os.path.join(root, "data")
        for i, cat in enumerate(CLI_FAUNA_CATEGORIES):
            write_synth_dataset(os.path.join(data, "large_scale", cat),
                                n=CLI_FAUNA_IMAGES, size=CLI_SIZE,
                                dino_dim=CLI_DINO, seed=10 + i)
        out = os.path.join(root, "exp")
        common = ["--config-name", "train_fauna",
                  f"dataset.train_data_dir={data}",
                  "dataset.val_data_dir=null", "dataset.test_data_dir=null",
                  "log_loss_freq=1", "use_logger=false",
                  f"checkpoint_dir={out}", "save_checkpoint_freq=5000"]
        _cfg, model, trainer = run.build(common + [
            f"num_iters={FAUNA_IT + 2}"])
        model.init_params(SEED)
        ckpt.save_checkpoint(out, FAUNA_IT, {
            "model": model.state_dict(), **make_optimizer(model).state_dict()})
        times = []
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with timed_steps(times):
            trainer.train()
        launches = check_counts("cli_train_fauna", {
            "cull_boxes": 4, "raster_vis": 4, "resolve_bwd": 2})
        peak = torch.cuda.max_memory_allocated()
        metrics = trainer.metrics_trace.data["train"]
        if trainer.start_iter != FAUNA_IT or len(metrics) != 2 or not all(
                np.isfinite([m["loss"], m["discriminator_loss"],
                             m["mask_disc_loss"]]).all() for m in metrics):
            raise AssertionError(f"cli_train_fauna: start "
                                 f"{trainer.start_iter}, metrics {metrics}")
        saved = ckpt.read_checkpoint(os.path.join(
            out, f"checkpoint{FAUNA_IT + 2:07d}.pth"))
        disc_state = saved["optimizer"]["disc"]["state"]
        if not any(k.startswith("netDisc.") for k in saved["model"]) or \
                len(disc_state) != len(list(model.netDisc.parameters())):
            raise AssertionError("cli_train_fauna: the checkpoint lacks "
                                 "netDisc or the disc Adam's state")
        del model, trainer
        torch.cuda.empty_cache()
        _cfg, m2, tr2 = run.build(common + [f"num_iters={FAUNA_IT + 3}"])
        opt, start = tr2.restore()
        n_equal = 0
        for i, st in disc_state.items():
            for k, v in st.items():
                if not torch.equal(opt.disc.state_dict()["state"][i][k]
                                   .cpu(), v):
                    raise AssertionError(f"cli_train_fauna: disc Adam "
                                         f"state {i}/{k} differs")
                n_equal += 1
        if start != FAUNA_IT + 2:
            raise AssertionError(f"cli_train_fauna: resume at {start}")
        del m2, tr2, opt
        with timed_steps(times):
            resumed = run.main(common + [f"num_iters={FAUNA_IT + 3}"])
        if resumed.start_iter != FAUNA_IT + 2 or not os.path.isfile(
                os.path.join(out, f"checkpoint{FAUNA_IT + 3:07d}.pth")):
            raise AssertionError("cli_train_fauna: the resume did not run")
        losses = [m["loss"] for m in metrics] + \
            [m["loss"] for m in resumed.metrics_trace.data["train"]]
        print(f"cli_train_fauna: train_fauna on {len(CLI_FAUNA_CATEGORIES)} "
              f"categories of {CLI_FAUNA_IMAGES} images at {CLI_SIZE}²: 2 "
              f"steps from {FAUNA_IT} and a resume {FAUNA_IT + 2} -> "
              f"{FAUNA_IT + 3} (restored disc Adam state equal to the saved "
              f"one in all {n_equal} tensors); losses "
              f"{[round(x, 4) for x in losses]}; discriminator losses "
              f"{[round(m['discriminator_loss'], 4) for m in metrics]}; step "
              f"ms {[round(x, 1) for x in times]}; peak memory "
              f"{peak / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in launches.items() if v} }; card {card}")
        del resumed
        torch.cuda.empty_cache()
        if keep is not None:
            shutil.move(os.path.join(out,
                                     f"checkpoint{FAUNA_IT + 3:07d}.pth"),
                        os.path.join(keep, "fauna.pth"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, (statistics.median(times), peak)


# ---------------------------------------------------------------------------
# the port's CLI at full width: train, resume, the fine grid, the test path
# ---------------------------------------------------------------------------

CLI_TRAIN_IMAGES, CLI_TEST_IMAGES, CLI_SIZE, CLI_DINO = 20, 10, 256, 16
FINE_IT = 100000


def cli_data(root):
    """(train dir, test dir): synthetic folders of `write_synth_dataset`,
    which the CLI's loaders decode with PIL."""
    import os
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    write_synth_dataset(train, n=CLI_TRAIN_IMAGES, size=CLI_SIZE,
                        dino_dim=CLI_DINO, seed=0)
    write_synth_dataset(test, n=CLI_TEST_IMAGES, size=CLI_SIZE,
                        dino_dim=CLI_DINO, seed=1)
    print(f"cli: synthetic folders of {CLI_TRAIN_IMAGES} train and "
          f"{CLI_TEST_IMAGES} test images at {CLI_SIZE}², dino_dim "
          f"{CLI_DINO}, decoded by PIL")
    return train, test


def timed_steps(times):
    """A context in which `trainer.train_step` (the loop's step) records
    its wall time (ms, synchronized) into `times`."""
    import contextlib
    import torch
    from animals3d_tpu_torch import trainer as trainer_mod

    @contextlib.contextmanager
    def ctx():
        real = trainer_mod.train_step

        def step(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kw)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            return out
        trainer_mod.train_step = step
        try:
            yield
        finally:
            trainer_mod.train_step = real
    return ctx()


def k1_scene_check(name, scene):
    """The cull kernel's boxes and K1's z, face_id and flags against their
    plain versions, bit for bit, on one scene; returns the plain version's
    ms."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    v_clip, v_pos0, faces, f_valid, res, chunk = scene
    prep = rc.prepare(v_clip, v_pos0, faces, f_valid, res, chunk)
    same_outputs(f"cull kernel {name}", (prep["fbox"],),
                 (rc.cull_boxes(prep["table"], res),), ("boxes",))
    out = rc.visibility(prep["table"], prep["orig"], prep["order"],
                        prep["counts"], prep["masks"], prep["zlo"],
                        prep["fbox"], res, prep["nsub"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rc.visibility_reference(prep["table"], prep["orig"], prep["order"],
                                  prep["counts"], prep["masks"], prep["zlo"],
                                  res, prep["nsub"])
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    same_outputs(f"K1 {name}", out, ref)
    covered = int((out[1] > 0).sum())
    if covered == 0:
        raise AssertionError(f"{name}: the mesh covers no pixel")
    print(f"visibility[{name}]: B={out[1].shape[0]} res={res} faces="
          f"{faces.shape[0]} covered_px={covered}: K1's z, face_id and flags "
          f"identical to the plain version ({plain_s:.2f} s); cull boxes "
          "identical to `cull_boxes`")


def cli_phase(card, keep=None):
    """The port's entry point at the full width of `train_magicpony_horse`
    (batch 10, 256², dino_vits8 with random weights, bf16, DINO features
    of 16): the coarse loop from iteration 0 (3 iterations, a checkpoint
    every 2, eval artifacts at 3), a resume to 4 (from iteration 3, with
    the saved Adam state bit for bit), two steps from a checkpoint of the
    init weights at iteration 100,000 (the fine grid 256, deformation,
    attached legs, articulation), and the test config's eval forward over
    the test images at that grid. Each run's launches are counted from 0;
    returns ({path: launches}, {path: (ms, peak bytes)}). With `keep` (a
    directory), the fine checkpoint is moved there as
    `magicpony.pth` for the Visualizer."""
    import json as _json
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch.data import util as dutil
    from animals3d_tpu_torch.trainer import make_optimizer
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    by_path, summary = {}, {}
    try:
        train_dir, test_dir = cli_data(root)
        print(f"cli: distance transforms by the {dutil.distance_transform_backend()} "
              "path")
        coarse = os.path.join(root, "coarse")
        common = ["--config-name", "train_magicpony_horse",
                  f"dataset.train_data_dir={train_dir}",
                  "dataset.val_data_dir=null", "log_loss_freq=1",
                  "use_logger=false", "save_checkpoint_freq=2"]

        # the coarse loop from iteration 0, and its resume
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        t0 = time.perf_counter()
        with timed_steps(times):
            run.main(common + [f"checkpoint_dir={coarse}", "num_iters=3",
                               "save_train_result_freq=3"])
        with open(os.path.join(coarse, "metrics.json")) as f:
            losses = [m["loss"] for m in _json.load(f)["train"]]
        if len(losses) != 3 or not all(np.isfinite(losses)):
            raise AssertionError(f"cli_train: losses {losses}")
        results = os.listdir(os.path.join(coarse, "train_results"))
        if not any(f.endswith("_mesh.obj") for f in results):
            raise AssertionError(f"cli_train: train_results {results}")
        saved = ckpt.read_checkpoint(os.path.join(coarse,
                                                  "checkpoint0000003.pth"))
        resume = common + [f"checkpoint_dir={coarse}", "num_iters=4"]
        _cfg, m, tr = run.build(resume)
        opt, start = tr.restore()
        n_equal = adam_state_equal(saved, opt, "cli_train")
        if start != 3:
            raise AssertionError(f"cli_train: the resume starts at {start}")
        del m, tr, opt, saved
        with timed_steps(times):
            trainer = run.main(resume)
        if trainer.start_iter != 3 or not os.path.isfile(
                os.path.join(coarse, "checkpoint0000004.pth")):
            raise AssertionError("cli_train: the resume did not run 3 -> 4")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        # 4 steps, and one eval forward (train_results) that renders too
        by_path["cli_train"] = check_counts(
            "cli_train", {"cull_boxes": 5, "raster_vis": 5,
                          "fused_mlp_fwd": 4, "fused_mlp_bwd": 4,
                          "resolve_bwd": 4})
        peak = torch.cuda.max_memory_allocated()
        summary["cli_train"] = (statistics.median(times), peak)
        print(f"cli_train: 3 iterations from 0 and a resume 3 -> 4 "
              f"(restored Adam state equal to the saved one in all "
              f"{n_equal} tensors); losses {[round(x, 4) for x in losses]}; "
              f"step ms {[round(x, 1) for x in times]}; {wall / 1e3:.1f} s "
              f"for both runs; peak memory {peak / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in by_path['cli_train'].items() if v} }; "
              f"card {card}")
        del trainer
        torch.cuda.empty_cache()

        # two steps at the fine grid from the init weights at 100,000
        fine = os.path.join(root, "fine")
        _cfg, model, trainer = run.build(
            common + [f"checkpoint_dir={fine}", f"num_iters={FINE_IT + 2}",
                      "save_checkpoint_freq=5000"])
        model.init_params(SEED)
        ckpt.save_checkpoint(fine, FINE_IT, {
            "model": model.state_dict(),
            **make_optimizer(model).state_dict()})
        phase = model.phase_for_iter(FINE_IT)
        grid, v_cap, f_cap = model.grid_for_phase(phase)
        print(f"cli_train_fine: iter {FINE_IT} phase {phase} grid {grid.res} "
              f"v_cap {v_cap} f_cap {f_cap}")
        times = []
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with timed_steps(times), recorded_calls() as rec:
            trainer.train()
        peak = torch.cuda.max_memory_allocated()
        by_path["cli_train_fine"] = check_counts("cli_train_fine", 2)
        if trainer.start_iter != FINE_IT:
            raise AssertionError(f"cli_train_fine: starts at "
                                 f"{trainer.start_iter}")
        fine_losses = [m["loss"] for m in trainer.metrics_trace.data["train"]]
        if not all(np.isfinite(fine_losses)):
            raise AssertionError(f"cli_train_fine: losses {fine_losses}")
        summary["cli_train_fine"] = (statistics.median(times), peak)
        print(f"cli_train_fine: steps at grid {grid.res}: "
              f"{[round(x, 1) for x in times]} ms; losses "
              f"{[round(x, 4) for x in fine_losses]}; peak memory "
              f"{peak / 2**30:.2f} GiB; launches "
              f"{ {k: v for k, v in by_path['cli_train_fine'].items() if v} }"
              f"; card {card}")
        del model, trainer
        torch.cuda.empty_cache()

        # the test config at the fine grid
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tester = run.main(["--config-name", "test_magicpony_horse",
                           f"checkpoint_dir={fine}",
                           f"checkpoint_name=checkpoint{FINE_IT + 2:07d}.pth",
                           f"dataset.test_data_dir={test_dir}"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        by_path["cli_test_fine"] = check_counts("cli_test_fine", 1)
        out_dir = os.path.join(fine, f"test_results_{FINE_IT + 2:07d}")
        files = os.listdir(out_dir)
        for suffix in ("_mesh.obj", "_image_pred.png", "_pose.txt"):
            n = sum(f.endswith(suffix) for f in files)
            if n != CLI_TEST_IMAGES:
                raise AssertionError(f"cli_test_fine: {n} {suffix} files")
        summary["cli_test_fine"] = (ms, peak)
        grid = tester.model.grid_for_phase(tester.model.phase_for_iter(
            FINE_IT + 1, is_training=False))[0]
        print(f"cli_test_fine: test_magicpony_horse at grid {grid.res} over "
              f"{CLI_TEST_IMAGES} images: {ms / 1e3:.2f} s (model build, "
              f"checkpoint load, eval forward, files), peak memory "
              f"{peak / 2**30:.2f} GiB; {len(files)} files; launches "
              f"{ {k: v for k, v in by_path['cli_test_fine'].items() if v} }"
              f"; card {card}")
        del tester
        torch.cuda.empty_cache()
        # K1 on the fine step's own posed meshes (after the counted runs)
        k1_scene_check("train_fine", rec["scenes"][0])
        if keep is not None:
            shutil.move(os.path.join(fine, f"checkpoint{FINE_IT + 2:07d}.pth"),
                        os.path.join(keep, "magicpony.pth"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return by_path, summary


# ---------------------------------------------------------------------------
# Ponymation at the widths of train_ponymation_horse_stage{1,2}
# ---------------------------------------------------------------------------

PONY_STAGE1, PONY_STAGE2 = ("train_ponymation_horse_stage1",
                            "train_ponymation_horse_stage2")
PONY_IT = 100000        # coarse grid, deformation, articulation, legs on
PONY_FINE_IT = 150000   # stage 1's fine grid 256 (coarse until 140,000)
PONY_TIMED = 3
# K1 against its plain version at 1024² on two of a step's ten frames (the
# plain version takes ~16x its 256² time a frame)
PONY_K1_FRAMES = (0, 9)
# the small float32 references: `tests/test_ponymation.py`'s widths at grid
# 8 with the netSDF 256 wide (the fused sweep), 3 frames, spp 2
PONY_SMALL_OVERRIDES = [
    "dataset.in_image_size=64", "dataset.out_image_size=64",
    "dataset.num_frames=3", "dataset.dino_feature_dim=4",
    "model.cfg_predictor_base.cfg_shape.grid_res=8",
    "model.cfg_predictor_base.cfg_shape.grid_res_coarse=8",
    "model.cfg_predictor_base.cfg_shape.num_layers=2",
    "model.cfg_predictor_base.cfg_shape.hidden_size=256",
    "model.cfg_predictor_base.cfg_dino.num_layers=2",
    "model.cfg_predictor_base.cfg_dino.hidden_size=32",
    "model.cfg_predictor_base.cfg_dino.feature_dim=4",
    "model.cfg_predictor_instance.cfg_encoder.cout=32",
    "model.cfg_predictor_instance.cfg_texture.num_layers=2",
    "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
    "model.cfg_predictor_instance.cfg_deform.num_layers=2",
    "model.cfg_predictor_instance.cfg_deform.hidden_size=32",
    "model.cfg_predictor_instance.cfg_articulation.num_layers=1",
    "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
    "model.cfg_predictor_instance.cfg_light.num_layers=2",
    "model.cfg_predictor_instance.cfg_light.hidden_size=32",
    "model.cfg_predictor_instance.cfg_motion_vae.latent_dim=32",
    "+model.cfg_predictor_instance.cfg_motion_vae.transformer_layer_num=1",
    "model.cfg_render.renderer_spp=2",
]
CLI_PONY_FRAMES = 10     # frames a synthetic sequence


def pony_model(config):
    """A full-width Ponymation model of `config` on the card, bf16 compute,
    its init state and its batch size."""
    from animals3d_tpu_torch.precision import set_mixed_precision
    cfg, model = build([], "cuda", config)
    set_mixed_precision("bf16")
    state = {k: v.clone() for k, v in model.init_params(SEED).items()}
    return model, state, cfg["dataset"]["batch_size"]


def moved_nets(before, model):
    """The second-level nets (`netInstance.netVAE`, ...) whose parameters
    changed from `before`."""
    import torch
    return sorted({".".join(k.split(".")[:2]) for k, v in
                   model.state_dict().items()
                   if v.is_floating_point() and not torch.equal(v, before[k])})


def silhouette_pair_counts(rast):
    """The silhouette pairs of each image of a rast, before the antialias
    pass caps them (`ops.antialias.silhouette_pairs`'s validity rule)."""
    import torch
    from animals3d_tpu_torch.ops import antialias as aa
    fid = rast.face_id
    z = torch.where(fid > 0, rast.z, torch.full_like(rast.z, float("inf")))
    h = aa._pair_valid(fid[..., :-1], fid[..., 1:], z[..., :-1], z[..., 1:],
                       2e-3)
    v = aa._pair_valid(fid[:, :-1], fid[:, 1:], z[:, :-1], z[:, 1:], 2e-3)
    return h.flatten(1).sum(1) + v.flatten(1).sum(1)


def pair_readings(scenes):
    """The antialias pass's silhouette pairs over the renders of
    `scenes` (recorded `rasterize_cuda` inputs): the busiest image's, the
    cap (`default_pair_cap`), the pairs in all and those the cap drops. The
    cap is the JAX package's, and the port's pass drops the pairs beyond it
    as the JAX package's does: the dropped share is a reading, printed
    beside the step times it comes with."""
    from animals3d_tpu_torch.ops import antialias as aa
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    busiest = total = dropped = 0
    for v_clip, v_pos0, faces, f_valid, res, _chunk in scenes:
        pairs = silhouette_pair_counts(rc.rasterize_cuda(
            v_clip, faces, f_valid, res, v_pos0=v_pos0))
        cap = aa.default_pair_cap(*res)
        busiest = max(busiest, int(pairs.max()))
        total += int(pairs.sum())
        dropped += int((pairs - cap).clamp(min=0).sum())
    return {"pairs_busiest": busiest, "pair_cap": cap, "pairs": total,
            "pairs_dropped": dropped,
            "pairs_dropped_share": dropped / total}


def dropped_pairs_text(r):
    share = 100 * r["pairs_dropped_share"]
    return (f"antialias cap {r['pair_cap']} drops {r['pairs_dropped']} of "
            f"{r['pairs']} silhouette pairs ({share:.1f}%), busiest image "
            f"{r['pairs_busiest']}")


def pony_render_checks(name, scene, k4_call=None):
    """On one recorded render of a step: the silhouette pairs against the
    antialias pass's cap (`pair_readings`, and the same posed meshes at the
    base resolution, where the cap is 4x smaller); K1 and the cull kernel
    against their plain versions, bit for bit, on frames `PONY_K1_FRAMES`
    (the plain version at 1024² takes seconds a frame); K1 and the cull
    kernel timed on all the frames and on those two, with K1's bound
    there; K4 on the step's own call. Returns the readings."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    v_clip, v_pos0, faces, f_valid, res, chunk = scene
    readings = pair_readings([scene])
    # whether the overflow comes with supersampling or with the meshes
    base = (res[0] // 4, res[1] // 4)
    low = pair_readings([(v_clip, v_pos0, faces, f_valid, base, chunk)])
    readings["pairs_busiest_base"] = low["pairs_busiest"]
    print(f"{name}: at {res[0]}x{res[1]} the {dropped_pairs_text(readings)};"
          f" at {base[0]}x{base[1]} the {dropped_pairs_text(low)}")
    sub = (v_clip[list(PONY_K1_FRAMES)].contiguous(), v_pos0, faces, f_valid,
           res, chunk)
    k1_scene_check(f"{name}_frames_{'_'.join(map(str, PONY_K1_FRAMES))}",
                   sub)
    for label, sc in (("all", scene), ("two", sub)):
        prep = rc.prepare(sc[0], v_pos0, faces, f_valid, res, chunk)

        def k1(p=prep):
            return rc.visibility(p["table"], p["orig"], p["order"],
                                 p["counts"], p["masks"], p["zlo"],
                                 p["fbox"], res, p["nsub"])
        readings[f"k1_ms_{label}"] = median_ms(k1, 5)
        readings[f"cull_ms_{label}"] = median_ms(
            lambda p=prep: rc.cull(p["table"], res), 5)
        if label == "two":
            stats = {}
            out = rc.visibility_reference(
                prep["table"], prep["orig"], prep["order"], prep["counts"],
                prep["masks"], prep["zlo"], res, prep["nsub"], stats=stats)
            bytes_ms, ops_ms, _nb, live_pairs = visibility_bound(
                sc[0], faces, prep, res, stats["visits"], out)
            readings["k1_bound_two"] = max(bytes_ms, ops_ms)
            readings["k1_live_pairs_two"] = live_pairs
        del prep
    print(f"{name}: K1 at {res[0]}x{res[1]} {readings['k1_ms_all']:.4f} ms "
          f"on {v_clip.shape[0]} frames, {readings['k1_ms_two']:.4f} ms on "
          f"frames {PONY_K1_FRAMES} (bound {readings['k1_bound_two']:.4f} ms"
          f", {readings['k1_live_pairs_two']} live (face, pixel) pairs); "
          f"cull kernel {readings['cull_ms_all']:.4f} ms on all, "
          f"{readings['cull_ms_two']:.4f} ms on two; card {card_line()}")
    if k4_call is not None:
        k4_call_check(name, k4_call)
    torch.cuda.empty_cache()
    return readings


def pony_train_phase(path, model, state, B, it, steps_warm, steps_timed,
                     kernels_per_step, trained_net):
    """`train_step`s of a full-width Ponymation model at `it` (`steps_warm`
    + `steps_timed`), the counters set to 0 just before and read just
    after; every loss finite; only `trained_net` moved. Then one step's
    device busy time and, where the step renders, the render checks on
    one step's own calls (`pony_render_checks`). Restores the init state.
    Returns (launches, (median ms, peak bytes), readings)."""
    import torch
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    model.load_state_dict(state)
    batch = fake_batch(model, B, SEED)
    phase = model.phase_for_iter(it)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    opt = make_optimizer(model)
    if set(opt.optimizers) != {"instance"}:
        raise AssertionError(f"{path}: optimizers {set(opt.optimizers)}")
    n_trained = sum(p.numel() for o in opt.optimizers.values()
                    for g in o.param_groups for p in g["params"])
    spp = model.cfg_render.renderer_spp
    print(f"{path}: iter {it} phase {phase} grid {grid.res} v_cap {v_cap} "
          f"f_cap {f_cap} batch {B} x {model.num_frames} frames at "
          f"{model.in_image_size}², spp {spp} (visibility at "
          f"{model.out_image_size * spp}²), render "
          f"{model.cfg_model.enable_render}, render_default "
          f"{model.cfg_render.render_default}; {n_trained} trained "
          f"parameters ({trained_net})")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    steps = steps_warm + steps_timed
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(model, opt, batch, it, gen, phase)
        torch.cuda.synchronize()
        if i >= steps_warm:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    launches = check_counts(path, {k: n * steps
                                   for k, n in kernels_per_step.items()})
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{path}: losses {losses}")
    moved = moved_nets(state, model)
    if moved != [trained_net]:
        raise AssertionError(f"{path}: moved {moved}")
    med = statistics.median(times)
    print(f"{path}: losses {[round(x, 4) for x in losses]}; train_step "
          f"median {med:.2f} ms (min {min(times):.2f} max {max(times):.2f}, "
          f"{len(times)} timed of {steps}), "
          f"{B * model.num_frames / med * 1e3:.2f} frames/s; peak memory "
          f"{peak / 2**30:.2f} GiB; launches in {steps} steps "
          f"{ {k: v for k, v in launches.items() if v} }; only "
          f"{trained_net} moved; card {card_line()}")

    def step():
        train_step(model, opt, batch, it, gen, phase)
    busy, n_events = device_busy_ms(step)
    print(f"{path}: one step's device busy time {busy:.3f} ms ({n_events} "
          f"device events); card {card_line()}")
    readings = {"busy_ms": busy}
    if model.cfg_model.enable_render:
        with recorded_calls() as rec:
            step()
        torch.cuda.synchronize()
        if len(rec["scenes"]) != 1 or len(rec["k4"]) != 1:
            raise AssertionError(f"{path}: {len(rec['scenes'])} renders, "
                                 f"{len(rec['k4'])} resolve backwards")
        scene, k4 = rec["scenes"][0], rec["k4"][0]
        del rec
        readings.update(pony_render_checks(path, scene, k4))
    model.load_state_dict(state)
    del opt
    torch.cuda.empty_cache()
    return launches, (med, peak), readings


def pony_generate_path(model, state, B):
    """Stage 2's eval forward at `PONY_IT` (`generate`: one frame of the
    batch, its shape and pose, a sampled sequence of 10 articulations,
    rendered from the default camera at spp 1), 1 warm-up and
    `PONY_TIMED` timed; the cull kernel and K1 once a forward. Returns
    (launches, (median ms, peak bytes))."""
    import torch
    from animals3d_tpu_torch.data.synth import fake_batch
    model.load_state_dict(state)
    batch = fake_batch(model, B, SEED)
    phase = model.phase_for_iter(PONY_IT, is_training=False)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    Fr, H = model.num_frames, model.out_image_size
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times = []
    runs = WARMUP_RUNS + PONY_TIMED
    for i in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            _loss, (_met, aux) = model.forward(batch, PONY_IT, gen, phase)
        torch.cuda.synchronize()
        if i >= WARMUP_RUNS:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = check_counts("pony_generate", runs)
    peak = torch.cuda.max_memory_allocated()
    mask = aux["mask_pred"]
    shapes = (tuple(mask.shape), tuple(aux["arti_params"].shape),
              tuple(aux["shape"].v_pos.shape[:1]))
    if shapes != ((1, Fr, H, H), (1, Fr, model.netInstance.num_bones, 3),
                  (Fr,)):
        raise AssertionError(f"pony_generate: shapes {shapes}")
    cover = (mask > 0.5).flatten(2).sum(2)[0]
    if not (bool(torch.isfinite(mask).all()) and int(cover.min()) > 0):
        raise AssertionError(f"pony_generate: mask px {cover.tolist()}")
    med = statistics.median(times)
    print(f"pony_generate: 1 of {B * Fr} frames -> {Fr} generated frames "
          f"at {H}² (default camera, spp {model.cfg_render.renderer_spp}); "
          f"median {med:.2f} ms, min {min(times):.2f} max {max(times):.2f}; "
          f"mask px per frame {cover.tolist()}; peak memory "
          f"{peak / 2**30:.2f} GiB; launches in {runs} forwards "
          f"{ {k: v for k, v in launches.items() if v} }; card {card_line()}")
    return launches, (med, peak)


def pony_slice(card):
    """Ponymation at full width: `pony_stage1_train` (1 + 3 steps of
    `train_ponymation_horse_stage1` at `PONY_IT`: batch 1 x 10 frames at
    256², spp 4, so K1 at 10 x 1024²), `pony_stage1_fine` (2 steps at
    `PONY_FINE_IT`, grid 256), `pony_stage2_train` (1 + 3 steps of
    `train_ponymation_horse_stage2`: 20 x 10 frames, no render) and
    `pony_generate`. Returns ({path: launches}, {path: (ms, peak)},
    {path: readings})."""
    import torch
    by_path, summary, readings = {}, {}, {}
    model, state, B = pony_model(PONY_STAGE1)
    cfg_r = model.cfg_render
    if (cfg_r.renderer_spp, cfg_r.render_default, cfg_r.render_flow) != \
            (4, False, False):
        raise AssertionError(f"pony: stage 1 render config {cfg_r}")
    per_step = {"cull_boxes": 1, "raster_vis": 1, "fused_mlp_fwd": 1,
                "resolve_bwd": 1}
    for path, it, warm, timed in (
            ("pony_stage1_train", PONY_IT, WARMUP_RUNS, PONY_TIMED),
            ("pony_stage1_fine", PONY_FINE_IT, 0, 2)):
        ph = model.phase_for_iter(it)
        if not (ph.deform_on and ph.articulation_on and ph.attach_legs
                and ph.use_coarse_grid == (it == PONY_IT)):
            raise AssertionError(f"{path}: phase {ph}")
        by_path[path], summary[path], readings[path] = pony_train_phase(
            path, model, state, B, it, warm, timed, per_step,
            "netInstance.netArticulation")
    del model, state
    torch.cuda.empty_cache()
    model, state, B = pony_model(PONY_STAGE2)
    if model.cfg_model.enable_render or not model.enable_motion_vae:
        raise AssertionError("pony: stage 2 config")
    by_path["pony_stage2_train"], summary["pony_stage2_train"], \
        readings["pony_stage2_train"] = pony_train_phase(
            "pony_stage2_train", model, state, B, PONY_IT, WARMUP_RUNS,
            PONY_TIMED, {"fused_mlp_fwd": 1}, "netInstance.netVAE")
    by_path["pony_generate"], summary["pony_generate"] = \
        pony_generate_path(model, state, B)
    del model, state
    torch.cuda.empty_cache()
    return by_path, summary, readings


def adam_state_equal(saved, opt, what):
    """Every tensor of each saved Adam state equal to `opt`'s, bit for
    bit; returns how many."""
    import torch
    n = 0
    for name, o in opt.optimizers.items():
        want = saved["optimizer"][name]["state"]
        got = o.state_dict()["state"]
        if set(got) != set(want):
            raise AssertionError(f"{what}: Adam {name} state keys")
        for i, st in want.items():
            for k, v in st.items():
                if not torch.equal(got[i][k].cpu(), v):
                    raise AssertionError(f"{what}: Adam {name} state "
                                         f"{i}/{k} differs")
                n += 1
    return n


def cli_pony_phase(card, keep=None):
    """`python -m animals3d_tpu_torch.run` with the Ponymation configs at
    full width on a synthetic sequence tree (2 sequences of
    `CLI_PONY_FRAMES` frames at 256² with 16-bit flows, DINO features of
    16): stage 1 resumed at `PONY_IT` from a MagicPony checkpoint the port
    writes (its weights load tolerantly; its Adam states, sized for
    MagicPony's groups, are reported and kept at init), 2 steps; stage 2
    from that stage-1 checkpoint (netVAE missing there, kept at init and
    reported), 2 steps; a resume of stage 2 one step further with its Adam
    state restored bit for bit; then stage 1's `Trainer.test` over one
    sequence with flows loaded and rendered, writing `_flow_gt.png` and
    `_flow_pred.png`. The counters run from 0 over the four; returns
    (launches, (median step ms, peak bytes), stage 1's `pair_readings`).
    With `keep` (a directory), the resumed stage-2 checkpoint is moved
    there as `pony.pth`.
    """
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.trainer import make_optimizer
    root = tempfile.mkdtemp(prefix="chip_smoke_pony_")
    try:
        tree = write_synth_dataset(os.path.join(root, "seq"), size=CLI_SIZE,
                                   dino_dim=CLI_DINO, sequences=2,
                                   frames=CLI_PONY_FRAMES, seed=0)
        test_tree = write_synth_dataset(
            os.path.join(root, "seq_test"), size=CLI_SIZE, dino_dim=CLI_DINO,
            sequences=1, frames=CLI_PONY_FRAMES, seed=1)
        s1, s2 = os.path.join(root, "stage1"), os.path.join(root, "stage2")
        _cfg, mp = build([], "cuda")            # train_magicpony_horse
        mp.init_params(SEED)
        ckpt.save_checkpoint(s1, PONY_IT, {"model": mp.state_dict(),
                                           **make_optimizer(mp).state_dict()})
        del mp
        torch.cuda.empty_cache()
        common = [f"dataset.train_data_dir={tree}", "dataset.val_data_dir=null",
                  "use_logger=false", "log_loss_freq=1",
                  "save_checkpoint_freq=5000", "checkpoint_path=null",
                  "dataset.num_workers=4"]
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times, counts = [], {}

        def counted(label, fn):
            before = {k: c.launches for k, c in counters().items()}
            out = fn()
            torch.cuda.synchronize()
            counts[label] = {k: c.launches - before[k]
                             for k, c in counters().items()
                             if c.launches != before[k]}
            return out
        with timed_steps(times), recorded_calls() as rec:
            t1 = counted("stage1", lambda: run.main(
                ["--config-name", PONY_STAGE1, f"checkpoint_dir={s1}",
                 f"num_iters={PONY_IT + 2}"] + common))
        scenes = rec["scenes"]
        del rec
        if t1.start_iter != PONY_IT or not os.path.isfile(
                os.path.join(s1, f"checkpoint{PONY_IT + 2:07d}.pth")):
            raise AssertionError("cli_train_pony: stage 1 did not run "
                                 f"{PONY_IT} -> {PONY_IT + 2}")
        s1_losses = [m["loss"] for m in t1.metrics_trace.data["train"]]
        del t1
        os.makedirs(s2)
        shutil.copy(os.path.join(s1, f"checkpoint{PONY_IT + 2:07d}.pth"), s2)
        with timed_steps(times):
            t2 = counted("stage2", lambda: run.main(
                ["--config-name", PONY_STAGE2, f"checkpoint_dir={s2}",
                 f"num_iters={PONY_IT + 4}"] + common))
        s2_losses = [m["loss"] for m in t2.metrics_trace.data["train"]]
        del t2
        torch.cuda.empty_cache()
        saved = ckpt.read_checkpoint(os.path.join(
            s2, f"checkpoint{PONY_IT + 4:07d}.pth"))
        resume = ["--config-name", PONY_STAGE2, f"checkpoint_dir={s2}",
                  f"num_iters={PONY_IT + 5}"] + common
        _cfg, m, tr = run.build(resume)
        opt, start = tr.restore()
        n_equal = adam_state_equal(saved, opt, "cli_train_pony")
        if start != PONY_IT + 4 or set(opt.optimizers) != {"instance"}:
            raise AssertionError(f"cli_train_pony: the resume starts at "
                                 f"{start}, optimizers {set(opt.optimizers)}")
        del m, tr, opt, saved
        torch.cuda.empty_cache()
        with timed_steps(times):
            t3 = counted("stage2_resume", lambda: run.main(resume))
        if t3.start_iter != PONY_IT + 4:
            raise AssertionError("cli_train_pony: the resume did not start "
                                 f"at {PONY_IT + 4}")
        del t3
        torch.cuda.empty_cache()
        tester = counted("stage1_test", lambda: run.main(
            ["--config-name", PONY_STAGE1, f"checkpoint_dir={s1}",
             "run_train=false", "run_test=true", "checkpoint_path=null",
             "dataset.train_data_dir=null", "dataset.val_data_dir=null",
             f"dataset.test_data_dir={test_tree}",
             "dataset.load_flow=true", "model.cfg_render.render_flow=true",
             "use_logger=false"]))
        del tester
        launches = check_counts("cli_train_pony", {
            "cull_boxes": 2 + CLI_PONY_FRAMES, "raster_vis": 2 +
            CLI_PONY_FRAMES, "fused_mlp_fwd": 5, "resolve_bwd": 2})
        readings = pair_readings(scenes)          # after the count: it renders
        del scenes
        peak = torch.cuda.max_memory_allocated()
        out_dir = os.path.join(s1, f"test_results_{PONY_IT + 2:07d}")
        files = os.listdir(out_dir)
        n_gt = sum(f.endswith("_flow_gt.png") for f in files)
        n_pred = sum(f.endswith("_flow_pred.png") for f in files)
        if not (n_gt and n_pred):
            raise AssertionError(f"cli_train_pony: {n_gt} flow_gt and "
                                 f"{n_pred} flow_pred files")
        if not all(np.isfinite(s1_losses + s2_losses)):
            raise AssertionError(f"cli_train_pony: losses {s1_losses} "
                                 f"{s2_losses}")
        if keep is not None:
            shutil.move(os.path.join(s2, f"checkpoint{PONY_IT + 5:07d}.pth"),
                        os.path.join(keep, "pony.pth"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    med = statistics.median(times)
    print(f"cli_train_pony: stage 1 {PONY_IT} -> {PONY_IT + 2} from a "
          f"MagicPony checkpoint (losses {[round(x, 4) for x in s1_losses]}), "
          f"stage 2 -> {PONY_IT + 4} from it (losses "
          f"{[round(x, 4) for x in s2_losses]}), a resume -> {PONY_IT + 5} "
          f"with all {n_equal} Adam state tensors restored bit for bit, and "
          f"the stage-1 test over {CLI_PONY_FRAMES} windows of one sequence "
          f"({n_gt} flow_gt and {n_pred} flow_pred files); step ms "
          f"{[round(x, 1) for x in times]}; peak memory {peak / 2**30:.2f} "
          f"GiB; launches by run {counts}; stage 1's renders: the "
          f"{dropped_pairs_text(readings)}; card {card}")
    return launches, (med, peak), readings


# ---------------------------------------------------------------------------
# the Visualizer, keypoint evaluation, the test configs and visual logging
# ---------------------------------------------------------------------------

VIS_RES, VIS_SPP = 256, 4
VIS_FINETUNE_ITERS = 2
VIS_KEYFRAMES = (0.0, 20.0)     # two keyframe files, degrees on every bone
VIS_SCENE_EVERY = 10            # the renders whose silhouette pairs are read
VIS_REF_TOL, VIS_REF_SHARE = 2e-3, 0.01
# the Visualizer reference's model: `SMALL_OVERRIDES` with the netSDF at
# its full depth and width (5 × 256), which the eval sweep runs plain
VIS_REF_OVERRIDES = [o for o in SMALL_OVERRIDES if "cfg_shape.num_layers"
                     not in o and "cfg_shape.hidden_size" not in o]
VIS_ALL_MODES = ("input_view", "other_views", "rotation", "animation",
                 "canonicalization")
VIS_VIDEO_FRAMES = {"rotation": 75, "canonicalization": 25}


def five_launches(launches):
    """The launches of the cull kernel, K1, K4, K6 and K7, as text."""
    return ", ".join(f"{label} {launches[k]}" for label, k in (
        ("cull", "cull_boxes"), ("K1", "raster_vis"), ("K4", "resolve_bwd"),
        ("K6", "fused_mlp_fwd"), ("K7", "fused_mlp_bwd")))


def vis_renders(modes, finetune, animation_frames):
    """The renders of one image's Visualizer run, each one cull and one K1
    launch: the finetune's forwards, the keypoint rasterization, the input
    view, 12 other views, 75 rotation frames, the animation's and 25
    canonicalization frames."""
    per = {"input_view": 1, "other_views": 12, "animation": animation_frames,
           **VIS_VIDEO_FRAMES}
    return (VIS_FINETUNE_ITERS if finetune else 0) + 1 + \
        sum(per[m] for m in modes)


def vis_files_check(path, out, modes, animation_frames):
    """Every file the modes write for image 0 (a video as an mp4, or as
    png frames where cv2 is absent) and the keypoint artifacts; returns
    the file count."""
    import os
    files = set(os.listdir(out))
    want = [f"0000000{s}" for s in ("_2d_projection_uv.txt",
                                    "_binary_occlusion.txt",
                                    "_3d_vertices.txt", "_pose.txt")]
    if "input_view" in modes:
        want += [f"0000000{s}" for s in ("_input_image.png",
                                         "_input_view.png",
                                         "_input_view_geo_normal.png",
                                         "_input_view_shading.png")]
    if "other_views" in modes:
        want += [f"0000000_other_view_{k:02d}.png" for k in range(12)]
    missing = [f for f in want if f not in files]
    frames = {**VIS_VIDEO_FRAMES, "animation": animation_frames}
    for mode in ("rotation", "animation", "canonicalization"):
        stem = f"0000000_{mode}"
        if mode in modes and stem + ".mp4" not in files and not all(
                f"{stem}_{i:03d}.png" in files for i in range(frames[mode])):
            missing.append(stem)
    if missing:
        raise AssertionError(f"{path}: missing {missing}")
    return len(files)


def overrides_for(config, values):
    """key=value overrides of `config`, with "+" for keys it lacks."""
    from animals3d_tpu_torch import config as cfglib
    cfg = cfglib.load_config(config)
    return [f"{'' if k in cfg else '+'}{k}={v}" for k, v in values.items()]


def keypoint_evaluation(path, vis_dir, root):
    """`animals3d_tpu_torch.evaluation.main` over the Visualizer's
    artifacts, those of image 0 under two names, with synthetic keypoint
    files: 12 keypoints within 0.01 of visible vertices, the same in both,
    so each transfer lands within 0.02 of its target (PCK@0.1 of 1)."""
    import os
    import shutil
    from animals3d_tpu_torch import evaluation
    eval_dir = os.path.join(root, "eval")
    os.makedirs(eval_dir)
    for i in range(2):
        for suffix in ("_2d_projection_uv.txt", "_binary_occlusion.txt"):
            shutil.copy(os.path.join(vis_dir, "0000000" + suffix),
                        os.path.join(eval_dir, f"{i:07d}{suffix}"))
    uv = np.loadtxt(os.path.join(vis_dir, "0000000_2d_projection_uv.txt"))
    occ = np.loadtxt(os.path.join(vis_dir, "0000000_binary_occlusion.txt"))
    visible = np.flatnonzero(occ == 0)
    if not 0 < len(visible) < len(occ):
        raise AssertionError(f"{path}: {len(visible)} of {len(occ)} "
                             "vertices visible")
    r = np.random.default_rng(SEED)
    pick = r.choice(visible, 12)
    kp = np.concatenate([uv[pick] + r.uniform(-0.01, 0.01, (12, 2)),
                         np.ones((12, 1))], 1)
    for i in range(2):
        np.savetxt(os.path.join(eval_dir, f"{i:07d}_keypoints.txt"), kp)
    scores = evaluation.main(["--result-dir", eval_dir, "--annotation-dir",
                              eval_dir, "--num-pairs", "100"])
    if not (scores["num_valid_kp"] > 0 and scores["pck"] == 1.0):
        raise AssertionError(f"{path}: evaluation {scores}")
    return scores


def vis_phase(path, config, ckpt, image_dir, modes, finetune, card,
              keyframes=None, animation_frames=30):
    """`python -m animals3d_tpu_torch.visualization --config-name
    <config>` (its `main`, in-process) on the one image of `image_dir`
    with the checkpoint `ckpt` at full width: resolution 256, spp 4, the
    eval phase of iteration 10^9 (grid 256), float32 as in a fresh
    process, every file of `modes` and the keypoint artifacts, the texture
    finetune (2 Adam steps) where `finetune`; then the keypoint evaluation
    over the artifacts. Checks the launches (one cull and one K1 a render,
    K6 once a MagicPony finetune step, K7 never), the files and that the
    input view covers pixels; prints the wall time by mode and a
    rotation render's, the peak memory and the antialias cap's dropped
    share over every `VIS_SCENE_EVERY`-th render. Returns (launches,
    (ms a rotation render, peak bytes), pair readings)."""
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import visualization as tvis
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    root = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    vis_dir = os.path.join(root, "vis")
    alphas = []
    real_rv = tvis.Visualizer.render_views

    def render_views(self, *args, modes=("shaded", "geo_normal"), **kw):
        r = real_rv(self, *args, modes=modes, **kw)
        if "shading" in modes:                     # the input view
            alphas.append(float(r["shaded"][:, 3].max()))
        return r
    try:
        argv = ["--config-name", config,
                f"checkpoint_dir={os.path.dirname(ckpt)}",
                f"checkpoint_name={os.path.basename(ckpt)}",
                f"dataset.test_data_dir={image_dir}",
                "render_modes=[" + ",".join(modes) + "]"] + overrides_for(
            config, {"output_dir": vis_dir, "resolution": VIS_RES,
                     "spp": VIS_SPP, "evaluate_keypoint": "true",
                     "finetune_texture": str(bool(finetune)).lower(),
                     "finetune_iters": VIS_FINETUNE_ITERS,
                     **({"arti_param_dir": keyframes} if keyframes else {})})
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        tvis.Visualizer.render_views = render_views
        t0 = time.perf_counter()
        try:
            with recorded_calls(every=VIS_SCENE_EVERY) as rec:
                vis = tvis.main(argv)
        finally:
            tvis.Visualizer.render_views = real_rv
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        renders = vis_renders(modes, finetune, animation_frames)
        runs = {"cull_boxes": renders, "raster_vis": renders}
        if "fused_mlp_fwd" in PATHS[path][1]:
            runs["fused_mlp_fwd"] = VIS_FINETUNE_ITERS
        launches = check_counts(path, runs)
        if not (alphas and min(alphas) > 0):
            raise AssertionError(f"{path}: input view alpha max {alphas}")
        n_files = vis_files_check(path, vis_dir, modes, animation_frames)
        scenes = rec["scenes"]
        del rec
        readings = pair_readings(scenes)          # after the count: it renders
        n_scenes = len(scenes)
        del scenes
        scores = keypoint_evaluation(path, vis_dir, root)
        model = vis.model
        grid = model.grid_for_phase(model.phase_for_iter(
            10 ** 9, is_training=False))[0].res
        secs = {k: round(v, 2) for k, v in vis.seconds.items()}
        per_render = 1e3 * vis.seconds["rotation"] / 75
        del vis, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"{path}: visualization --config-name {config} on one image at "
          f"{VIS_RES}² spp {VIS_SPP}, grid {grid}, modes {list(modes)}"
          f"{', finetune 2 steps' if finetune else ''}: {wall:.1f} s; "
          f"seconds by mode {secs}; rotation {per_render:.1f} ms a render; "
          f"peak memory {peak / 2**30:.2f} GiB; launches in {renders} "
          f"renders: {five_launches(launches)}; the "
          f"{dropped_pairs_text(readings)} over {n_scenes} of the renders; "
          f"input view alpha max {alphas[0]:.3f}; {n_files} files; keypoint "
          f"evaluation {scores}; card {card}")
    return launches, (per_render, peak), readings


def cli_test_phase(path, config, ckpt, seq_dir, renders, images, card):
    """`python -m animals3d_tpu_torch.run --config-name <config>` (the test
    path) at full width with the checkpoint `ckpt` over the sequence tree
    `seq_dir`: `renders` eval forwards (one cull and one K1 each) writing
    the mesh, image and pose files of `images` frames. Returns (launches,
    (ms, peak bytes))."""
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import run
    out = tempfile.mkdtemp(prefix=f"chip_smoke_{path}_")
    try:
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tester = run.main(["--config-name", config,
                           f"checkpoint_dir={os.path.dirname(ckpt)}",
                           f"checkpoint_name={os.path.basename(ckpt)}",
                           f"dataset.test_data_dir={seq_dir}",
                           f"test_result_dir={out}"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        launches = check_counts(path, renders)
        files = os.listdir(out)
        for suffix in ("_mesh.obj", "_image_pred.png", "_pose.txt"):
            n = sum(f.endswith(suffix) for f in files)
            if n != images:
                raise AssertionError(f"{path}: {n} {suffix} files")
        model = tester.model
        grid = model.grid_for_phase(model.phase_for_iter(
            10 ** 9, is_training=False))[0].res
        del tester, model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"{path}: run --config-name {config} (the test path) at grid "
          f"{grid} over {images} frames: {ms / 1e3:.2f} s (model build, "
          f"checkpoint load, {renders} eval forwards, files), peak memory "
          f"{peak / 2**30:.2f} GiB; {len(files)} files; launches "
          f"{ {k: v for k, v in launches.items() if v} }; card {card}")
    return launches, (ms, peak)


class TagRecorder:
    """A logger with tensorboardX's surface that keeps each call's tag and
    kind."""

    def __init__(self):
        self.tags = {}

    def _add(self, kind, tag):
        self.tags.setdefault(tag, set()).add(kind)

    def add_scalar(self, tag, *_a, **_k):
        self._add("simple_value", tag)

    def add_image(self, tag, *_a, **_k):
        self._add("image", tag)

    def add_histogram(self, tag, *_a, **_k):
        self._add("histo", tag)

    def add_video(self, tag, *_a, **_k):
        self._add("video", tag)

    def flush(self):
        pass


CLI_TEST_FRAMES = 2      # frames of the test configs' synthetic sequence
LOG_ITERS = 2
LOG_IMAGES = 10          # one batch of train_magicpony_horse, and of val


def log_visuals_phase(card, train_dir, val_dir):
    """Two iterations of `train_magicpony_horse` at full width through the
    port's CLI (`run.build`, `Trainer.train`) from a checkpoint of the init
    weights at `TRAIN_IT` (articulation on: the bones are drawn over the
    normals) with `use_logger: true` and `log_image_freq: 1`: after each
    step the visuals of the training batch and of a validation batch (the
    eval forward, its geo_normal/kd/shading render, 15 turntable frames of
    the posed shape and 15 of the prior) go to a `TagRecorder` in the
    writer's place, which must hold every visual and turntable tag (the
    CPU tests read the event files of the real writer). Prints one
    `_log_visuals` call's time. Returns (launches, (ms a `_log_visuals` call, peak bytes))."""
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import run
    from animals3d_tpu_torch import trainer as trainer_mod
    from animals3d_tpu_torch.trainer import make_optimizer
    root = tempfile.mkdtemp(prefix="chip_smoke_log_")
    times = []
    real_log = trainer_mod.Trainer._log_visuals
    real_logger = trainer_mod.Trainer._logger

    def log_visuals(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_log(self, *args, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    recorder = TagRecorder()
    try:
        trainer_mod.Trainer._log_visuals = log_visuals
        trainer_mod.Trainer._logger = lambda self: recorder
        _cfg, model, trainer = run.build([
            "--config-name", "train_magicpony_horse",
            f"dataset.train_data_dir={train_dir}",
            f"dataset.val_data_dir={val_dir}", f"checkpoint_dir={root}",
            f"num_iters={TRAIN_IT + LOG_ITERS}", "use_logger=true",
            "log_image_freq=1", "log_loss_freq=1",
            "save_checkpoint_freq=5000"])
        model.init_params(SEED)
        ckpt.save_checkpoint(root, TRAIN_IT, {
            "model": model.state_dict(),
            **make_optimizer(model).state_dict()})
        torch.cuda.empty_cache()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        calls = 2 * LOG_ITERS            # the training and a val batch
        renders = LOG_ITERS + calls * (2 + 2 * 15)
        launches = check_counts("log_visuals", {
            "cull_boxes": renders, "raster_vis": renders,
            "fused_mlp_fwd": LOG_ITERS, "fused_mlp_bwd": LOG_ITERS,
            "resolve_bwd": LOG_ITERS})
        tags = recorder.tags
        want = [p + "image/" + n for p in ("train_", "val_") for n in (
            "image_gt", "image_pred", "mask_gt", "mask_pred",
            "dino_feat_im_gt", "dino_feat_im_pred", "instance_geo_normal",
            "albedo", "shading")] + \
            [p + "animation/" + n for p in ("train_", "val_") for n in (
                "instance_normal_rotation", "prior_image_rotation",
                "prior_normal_rotation")] + ["train_arti_params", "train_sdf"]
        missing = [t for t in want if t not in tags]
        if missing or len(times) != calls:
            raise AssertionError(f"log_visuals: missing tags {missing}, "
                                 f"{len(times)} calls")
        if trainer.start_iter != TRAIN_IT:
            raise AssertionError(f"log_visuals: starts at "
                                 f"{trainer.start_iter}")
        del trainer, model
        torch.cuda.empty_cache()
    finally:
        trainer_mod.Trainer._log_visuals = real_log
        trainer_mod.Trainer._logger = real_logger
        shutil.rmtree(root, ignore_errors=True)
    print(f"log_visuals: train_magicpony_horse at full width, "
          f"{LOG_ITERS} iterations from {TRAIN_IT} with use_logger and "
          f"log_image_freq 1 (a tag recorder, {len(tags)} tags): "
          f"`_log_visuals` ms "
          f"{[round(x, 1) for x in times]} ({calls} calls, {renders} renders "
          f"with the steps'); peak memory {peak / 2**30:.2f} GiB; launches "
          f"{five_launches(launches)}; card {card}")
    return launches, (statistics.median(times), peak)


def vis_reference_phase(card):
    """A small float32 Visualizer (`test_magicpony_horse` at
    `VIS_REF_OVERRIDES`: grid 16, the netSDF 5 × 256, 64², spp 2) run with every mode, two
    keyframe files and the keypoint artifacts on the card and on the CPU
    from the same checkpoint: the same files; each frame's pixels within
    `VIS_REF_TOL` but at most `VIS_REF_SHARE` of a frame's (the pixels
    whose winning face flips on rounding between the two devices, and
    their antialiased neighbours); uv projections within 1e-4; occlusion
    flags equal but at most 1% of the vertices."""
    import os
    import shutil
    import tempfile
    import torch
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch import visualization as tvis
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.utils import results_io
    set_mixed_precision(None)
    root = tempfile.mkdtemp(prefix="chip_smoke_visref_")
    frames = {"cuda": {}, "cpu": {}}
    real_save = results_io.save_image
    # hidden, cv2 leaves every video frame a png, and each is compared
    cv2 = sys.modules.get("cv2")
    try:
        data = os.path.join(root, "data")
        write_synth_dataset(data, n=1, size=64, dino_dim=16, seed=3)
        anim = os.path.join(root, "anim")
        os.makedirs(anim)
        config = "test_magicpony_horse"
        ov = VIS_REF_OVERRIDES + [
            f"dataset.test_data_dir={data}", f"checkpoint_dir={root}",
            "checkpoint_name=small.pth",
            "render_modes=[" + ",".join(VIS_ALL_MODES) + "]"] + \
            overrides_for(config, {"resolution": 64, "spp": 2,
                                   "evaluate_keypoint": "true",
                                   "arti_param_dir": anim,
                                   "canon_frames": 5})
        cfg = cfglib.load_config(config, overrides=ov)
        current = []

        def save(path, img):
            arr = img.detach().cpu().numpy() if hasattr(img, "detach") \
                else np.asarray(img)
            frames[current[0]][os.path.basename(path)] = np.array(
                arr, np.float32)
            real_save(path, img)
        results_io.save_image = save
        sys.modules["cv2"] = None
        outs = {}
        for dev in ("cuda", "cpu"):
            current[:] = [dev]
            outs[dev] = os.path.join(root, dev)
            vis = tvis.Visualizer(dict(cfg, output_dir=outs[dev]), device=dev)
            if dev == "cuda":
                vis.model.init_params(SEED)
                torch.save({"model": vis.model.state_dict()},
                           os.path.join(root, "small.pth"))
                K = vis.model.netInstance.num_bones
                for i, deg in enumerate(VIS_KEYFRAMES):
                    np.savetxt(os.path.join(anim, f"arti_params_{i:02d}.txt"),
                               np.full((K, 3), deg))
            vis.run()
            del vis
        names = sorted(os.listdir(outs["cuda"]))
        if names != sorted(os.listdir(outs["cpu"])) or \
                sorted(frames["cuda"]) != sorted(frames["cpu"]):
            raise AssertionError("vis_reference: the files differ")
        worst, off, total = 0.0, 0, 0
        for name, want in frames["cpu"].items():
            got = frames["cuda"][name]
            bad = np.abs(got - want) > VIS_REF_TOL
            bad = bad.any(0) if bad.ndim == 3 else bad
            worst = max(worst, float(bad.mean()))
            off += int(bad.sum())
            total += bad.size
        uv = [np.loadtxt(os.path.join(outs[d], "0000000_2d_projection_uv.txt"))
              for d in ("cuda", "cpu")]
        occ = [np.loadtxt(os.path.join(outs[d], "0000000_binary_occlusion.txt"))
               for d in ("cuda", "cpu")]
        uv_err = float(np.abs(uv[0] - uv[1]).max())
        occ_share = float((occ[0] != occ[1]).mean())
    finally:
        results_io.save_image = real_save
        if cv2 is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = cv2
        shutil.rmtree(root, ignore_errors=True)
    print(f"vis_reference: {config} at grid 16, netSDF 5 × 256, 64², "
          f"spp 2, tf32 off, every mode on "
          f"the card and the CPU: {len(names)} files each, {len(frames['cpu'])} "
          f"frames; pixels beyond {VIS_REF_TOL:g}: {off} of {total}, at most "
          f"{100 * worst:.3f}% of a frame (bound {100 * VIS_REF_SHARE:g}%); "
          f"uv max |gpu - cpu| {uv_err:.3g}; occlusion flags differing "
          f"{100 * occ_share:.3f}%; card {card}")
    if not (worst <= VIS_REF_SHARE and uv_err <= 1e-4 and occ_share <= 0.01):
        raise AssertionError("vis_reference: the card and the CPU disagree")


def vis_slice(card, keep):
    """The Visualizer on the three checkpoints the CLI phases kept in
    `keep`, the test configs of Fauna and Ponymation through the CLI, and
    the trainer's visual logging; returns ({path: launches},
    {path: (ms, peak)}, {path: pair readings})."""
    import os
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    image = write_synth_dataset(os.path.join(keep, "image"), n=1,
                                size=CLI_SIZE, dino_dim=CLI_DINO, seed=2)
    seq = write_synth_dataset(os.path.join(keep, "seq"), size=CLI_SIZE,
                              dino_dim=CLI_DINO, sequences=1,
                              frames=CLI_TEST_FRAMES, seed=3)
    anim = os.path.join(keep, "anim")
    os.makedirs(anim)
    from animals3d_tpu_torch import config as cfglib
    mp_cfg = cfglib.load_config("test_magicpony_horse")
    n_body = mp_cfg["model"]["cfg_predictor_instance"]["cfg_articulation"]
    K = n_body["num_body_bones"] + n_body["num_legs"] * n_body["num_leg_bones"]
    for i, deg in enumerate(VIS_KEYFRAMES):
        np.savetxt(os.path.join(anim, f"arti_params_{i:02d}.txt"),
                   np.full((K, 3), deg))
    train_dir = write_synth_dataset(os.path.join(keep, "train"),
                                    n=LOG_IMAGES, size=CLI_SIZE,
                                    dino_dim=CLI_DINO, seed=4)
    val_dir = write_synth_dataset(os.path.join(keep, "val"), n=LOG_IMAGES,
                                  size=CLI_SIZE, dino_dim=CLI_DINO, seed=5)
    by_path, summary, readings = {}, {}, {}
    ck = {m: os.path.join(keep, f"{m}.pth")
          for m in ("magicpony", "fauna", "pony")}
    for path, config, ckpt, modes, finetune, kw in (
            ("vis_magicpony", "test_magicpony_horse", ck["magicpony"],
             VIS_ALL_MODES, True,
             dict(keyframes=anim, animation_frames=(len(VIS_KEYFRAMES) - 1)
                  * 5 + 1)),
            ("vis_fauna", "test_fauna", ck["fauna"],
             tuple(cfglib.load_config("test_fauna")["render_modes"]), True,
             {}),
            ("vis_pony", "test_ponymation_horse", ck["pony"],
             tuple(cfglib.load_config("test_ponymation_horse")
                   ["render_modes"]), False, {})):
        by_path[path], summary[path], readings[path] = vis_phase(
            path, config, ckpt, image, modes, finetune, card, **kw)
    # the test loaders take a window at every start frame: Fauna's of one
    # frame, Ponymation's of its 10 (padded at the sequence's end)
    pony_frames = cfglib.load_config("test_ponymation_horse")["dataset"][
        "num_frames"]
    by_path["cli_test_fauna"], summary["cli_test_fauna"] = cli_test_phase(
        "cli_test_fauna", "test_fauna", ck["fauna"], seq, CLI_TEST_FRAMES,
        CLI_TEST_FRAMES, card)
    by_path["cli_test_pony"], summary["cli_test_pony"] = cli_test_phase(
        "cli_test_pony", "test_ponymation_horse", ck["pony"], seq,
        CLI_TEST_FRAMES, CLI_TEST_FRAMES * pony_frames, card)
    by_path["log_visuals"], summary["log_visuals"] = log_visuals_phase(
        card, train_dir, val_dir)
    return by_path, summary, readings


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
    train_reference_phase("fauna_train", "train_fauna",
                          FAUNA_SMALL_OVERRIDES, FAUNA_IT)
    train_reference_phase("pony_stage1_train", PONY_STAGE1,
                          PONY_SMALL_OVERRIDES, PONY_IT)
    train_reference_phase("pony_stage2_train", PONY_STAGE2,
                          PONY_SMALL_OVERRIDES, PONY_IT)
    vis_reference_phase(card)

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
    # the CLI phases keep a checkpoint each for the Visualizer
    import shutil
    import tempfile
    keep = tempfile.mkdtemp(prefix="chip_smoke_keep_")
    cli_by_path, cli_summary = cli_phase(card, keep)
    by_path.update(cli_by_path)
    summary.update(cli_summary)

    # 3D-Fauna: the step, the recon and the CLI at the width of train_fauna
    del model, m4, m6, again, shaded, s6, state
    torch.cuda.empty_cache()
    fauna, fstate, fB = fauna_slice()
    by_path["fauna_train"], fsum = fauna_train_phase(fauna, fstate, fB, card)
    summary.update(fsum)
    by_path["fauna_recon"], *summary["fauna_recon"] = fauna_recon_path(
        fauna, fstate, fB, card)
    del fauna, fstate
    torch.cuda.empty_cache()
    by_path["cli_train_fauna"], summary["cli_train_fauna"] = \
        cli_fauna_phase(card, keep)

    # Ponymation: both stages, generation and the CLI
    pony_by_path, pony_summary, pony_readings = pony_slice(card)
    by_path.update(pony_by_path)
    summary.update(pony_summary)
    by_path["cli_train_pony"], summary["cli_train_pony"], \
        pony_readings["cli_train_pony"] = cli_pony_phase(card, keep)

    # the Visualizer, the test configs and the trainer's visual logging
    try:
        vis_by_path, vis_summary, vis_readings = vis_slice(card, keep)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    by_path.update(vis_by_path)
    summary.update(vis_summary)
    pony_readings.update(vis_readings)
    # a Ponymation stage-1 step and a Visualizer render at spp 4 go through
    # the capped antialias pass
    pairs = {p: f" ({dropped_pairs_text(r)})" for p, r in
             pony_readings.items() if "pairs" in r}
    print("paths (ms, peak GiB): " + ", ".join(
        f"{k} {ms:.2f} ms {peak / 2**30:.2f} GiB{pairs.get(k, '')}"
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
    # K1 and the cull kernel at 1024² (Ponymation's spp 4): all ten frames
    # of a step, and the two held to the plain version, with K1's bound
    for e in kernels:
        key = {"raster_vis": "k1", "cull_boxes": "cull"}.get(e["name"])
        if key:
            e["pony_1024"] = {
                p: {k: v for k, v in r.items() if k.startswith(key)}
                for p, r in pony_readings.items() if f"{key}_ms_all" in r}
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
