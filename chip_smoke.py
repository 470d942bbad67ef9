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
     loss, every parameter's gradient and the parameters after the step;
  3. kernels: run each kernel against its plain PyTorch version on the
     card — the tile visibility kernel on a random scene, the exact-z
     depth-stack scene, the prior mesh of the full-width model posed by
     10 cameras at 256² (face capacity 196,608) and the full-width
     recon's own posed meshes (the inputs `reconstruct` rasterizes).
     face_id and the per-tile chunk flags must be identical and z equal
     where the ids agree. Times the kernel and the plain version (CUDA
     events, medians) on the last two scenes and computes the kernel's
     bound from this run's inputs; the `kernels` line reports the recon
     scene. Then the fused netSDF sweep, forward and backward, against
     its plain versions at the full-width shape (the embedded jittered
     129³ lattice, weights of `init_params(0)`) and at a ragged small N,
     in bf16 and float32, and the resolve backward against its plain
     version on the training step's own winner ids with a random
     cotangent (10, 65,536, 42) and on the depth-stack scene, where one
     face collects hundreds of pixels; each with its time, its plain
     version's, its bound and (resolve backward) `index_add_`'s;
  4. train slice: `train_step` of the same model at full width —
     iter-50000 training phase (grid jitter, random pose sampling, fused
     sweep), batch 10 of `fake_batch`, bf16 — 1 warm-up and 5 timed steps
     with fresh noise from a generator. The launch counters are set to 0
     just before and read just after: each of the four kernels must have
     launched once per step;
  5. slice: `reconstruct` of `train_magicpony_horse` at full width —
     iter-50000 phase (coarse grid 128, articulation on), batch 10 at 256²,
     dino_vits8, bf16 compute — with random weights from `init_params(0)`:
     1 warm-up run, then 5 timed runs. The kernels' launch counters are set
     to 0 just before this phase and read just after it; every render must
     have launched the visibility kernel once.

Prints a `kernels` JSON line (`launches` is the count over the training
steps of phase 4, `launches_train` the same, `launches_recon` the count
over the renders of phase 5), the card's name and power limit, and as the
last line `{"ok": true, "device": {...}}`. Exits non-zero without a CUDA
card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

F32_PEAK_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
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


def visibility_bound(v_clip, faces, prep, res, visits, outputs):
    """Least time (ms) the H100 needs for the visibility function on these
    inputs: (bytes ms, operations ms, bytes, live pairs).

    Operations: 12 float32 operations (3 edge functions) per live
    (face, pixel) pair, a pixel centre inside the screen bbox of a valid
    face of a live (tile, chunk) pair — one the occlusion skip keeps, as
    `visits` from the plain version records. Bytes: the coefficients and
    original ids of the live sub-blocks, each read once, the tiles' chunk
    counts and z-mins, the list entries each tile walks, and the outputs
    written once."""
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
    nbytes = (live.shape[0] * sub * 12 * 4 + ids.shape[0] * sub * 4
              + walked * 2 * 4
              + sum(prep[k].numel() * 4 for k in ("counts", "zlo"))
              + sum(a.numel() * a.element_size() for a in outputs))
    return (nbytes / HBM_BYTES_PER_S * 1e3, 12 * pairs / F32_PEAK_FLOPS * 1e3,
            nbytes, pairs)


def visibility_phase(model, images, it, device):
    """Kernel against plain version on the four scenes; returns the
    `kernels` entry for the visibility kernel, timed and bounded on the
    recon scene."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    rng = np.random.default_rng(SEED)
    scenes = {"random": random_scene(rng),
              "depth_stack": depth_stack_scene(),
              "posed_prior": posed_prior_scene(model),
              "recon": recon_scene(model, images, it)}
    entry = None
    for name, (v_clip, v_pos0, faces, f_valid, res, chunk) in scenes.items():
        t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
        v_clip, faces = t(v_clip), t(faces, torch.int64)
        prep = rc.prepare(v_clip, t(v_pos0), faces, t(f_valid, torch.bool),
                          res, chunk)
        args = (prep["table"], prep["orig"], prep["order"], prep["counts"],
                prep["masks"], prep["zlo"], res, prep["nsub"])
        z, fid, flags = rc.visibility(*args)
        torch.cuda.synchronize()
        stats = {}
        z_ref, fid_ref, flags_ref = rc.visibility_reference(*args,
                                                            stats=stats)
        same = fid == fid_ref
        if not bool(same.all()):
            raise AssertionError(f"{name}: face_id differs at "
                                 f"{int((~same).sum())} pixels")
        if not torch.equal(flags, flags_ref):
            raise AssertionError(f"{name}: chunk flags differ")
        err = float((z - z_ref).abs().max())
        if err != 0.0:
            raise AssertionError(f"{name}: z differs by {err}")
        covered = int((fid > 0).sum())
        visits = stats["visits"]
        # the design's own work: every face of a visited sub-block against
        # every pixel of the tile
        design_pairs = visits.shape[0] * (chunk // prep["nsub"]) * rc.TP
        print(f"visibility[{name}]: B={fid.shape[0]} res={res} "
              f"faces={faces.shape[0]} chunk={chunk} covered_px={covered} "
              f"live_subblock_visits={visits.shape[0]} "
              f"design_face_pixel_tests={design_pairs} identical")
        if name in ("posed_prior", "recon") and covered == 0:
            raise AssertionError(f"{name}: the mesh covers no pixel")
        if name not in ("posed_prior", "recon"):
            continue
        ms = statistics.median(cuda_ms(lambda: rc.visibility(*args),
                                       TIMED_RUNS))
        plain_ms = statistics.median(
            cuda_ms(lambda: rc.visibility_reference(*args), 3))
        bytes_ms, ops_ms, nbytes, pairs = visibility_bound(
            v_clip, faces, prep, res, visits, (z, fid, flags))
        bound = max(bytes_ms, ops_ms)
        print(f"visibility[{name}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound:.4f} ms (live bytes {nbytes} -> "
              f"{bytes_ms:.4f} ms; live bbox pairs {pairs} -> {ops_ms:.4f} "
              f"ms), kernel/bound {ms / bound:.1f}x")
        if name != "recon":
            continue
        entry = {"name": "raster_vis", "route": "cuda",
                 "source": "animals3d_tpu_torch/csrc/raster_vis.cu",
                 "replaces": "animals3d_tpu/ops/rasterize_pallas.py:153",
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                 "library_ms": None}
    return entry


# ---------------------------------------------------------------------------
# fused netSDF sweep and resolve backward against their plain versions
# ---------------------------------------------------------------------------

def median_ms(fn, runs=KERNEL_RUNS):
    fn()                                    # warm-up
    return statistics.median(cuda_ms(fn, runs))


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
    on the other side of a bf16 step). At N = 4097 the last row is a tile
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
                rows.append({
                    "name": kname, "route": "cuda",
                    "source": "animals3d_tpu_torch/csrc/fused_mlp.cu",
                    "replaces": "animals3d_tpu/ops/fused_mlp.py:"
                    + ("59" if kname.endswith("fwd") else "76"),
                    "launches": 0, "max_abs_err": kerr, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": "operations" if ops_ms > bytes_ms
                    else "bytes", "library_ms": None})
            if not f32:
                entries = {r["name"]: r for r in rows}
            full = N
    unfused_sweep_line(model, full)
    return entries["fused_mlp_fwd"], entries["fused_mlp_bwd"]


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
    """For orientation only: the unfused path (`get_sdf` over the lattice
    under autograd, forward and backward, bf16) with its peak memory."""
    import torch
    from animals3d_tpu_torch.precision import (compute_dtype,
                                               set_mixed_precision)
    was = compute_dtype()
    set_mixed_precision("bf16")
    shape = model.netBase.cfg.cfg_shape
    grid, _v, _f = model.grid_for_phase(model.phase_for_iter(TRAIN_IT))
    pos = grid.verts * shape.spatial_scale

    def run():
        model.netBase.get_sdf(pos)[..., 0].sum().backward()
        model.zero_grad(set_to_none=True)
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms = statistics.median(cuda_ms(run, 5))
    peak = torch.cuda.max_memory_allocated() - base
    set_mixed_precision(None if was == torch.float32 else "bf16")
    print(f"unfused sweep (get_sdf under autograd, fwd + bwd, bf16, N={N}; "
          f"not a kernel of the port, for orientation): {ms:.3f} ms, peak "
          f"memory above the model {peak / 2**30:.2f} GiB")


def train_scene(model, batch):
    """Winner ids of the training forward's own render: (B, H·W) int32."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.render.camera import xfm_points
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.no_grad():
        _loss, (_m, aux) = model.forward(batch, TRAIN_IT, gen)
        shape = aux["shape"]
        H = model.out_image_size
        rast = rc.rasterize_cuda(xfm_points(shape.v_pos, aux["mvp"]),
                                 shape.t_pos_idx, shape.f_valid, (H, H),
                                 v_pos0=shape.v_pos[0])
    fid = rast.face_id.reshape(rast.face_id.shape[0], -1).contiguous()
    return fid, shape.t_pos_idx.shape[0]


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
        entry = {"name": "resolve_bwd", "route": "cuda",
                 "source": "animals3d_tpu_torch/csrc/resolve_bwd.cu",
                 "replaces": "animals3d_tpu/ops/rasterize_pallas.py:1097",
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": "bytes" if bytes_ms > ops_ms else "operations",
                 "library_ms": library_ms}
    return entry


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def build(overrides, device):
    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    cfg = cfglib.load_config("train_magicpony_horse", overrides=overrides)
    model_cfg = dict(cfg["model"])
    model_cfg["dataset"] = cfg["dataset"]
    return cfg, build_model(model_cfg, device=device)


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


def train_reference_phase():
    """One training step of a small float32 model on the card against the
    same step on the CPU, from the same weights, batch and noise: loss to
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
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    from animals3d_tpu_torch.precision import set_mixed_precision
    from animals3d_tpu_torch.trainer import make_optimizer
    set_mixed_precision(False)
    _cfg, gpu = build(TRAIN_SMALL_OVERRIDES, "cuda")
    state = {k: v.detach().cpu().clone()
             for k, v in gpu.init_params(SEED).items()}
    _cfg, cpu = build(TRAIN_SMALL_OVERRIDES, "cpu")
    cpu.load_state_dict(state)
    phase = gpu.phase_for_iter(TRAIN_IT)
    if not gpu.netBase._use_fused_sweep(training=True):
        raise AssertionError("train reference: the fused sweep is off")
    B = 2
    batches = {"gpu": fake_batch(gpu, B, SEED),
               "cpu": fake_batch(cpu, B, SEED)}
    for batch in batches.values():
        for k in ("images", "dino_features"):
            batch[k] = batch[k] * 0.1
    models = {"gpu": gpu, "cpu": cpu}
    counts = (fm.fused_mlp_fwd.launches, fm.fused_mlp_bwd.launches,
              rv.resolve_bwd.launches)

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
        print(f"train reference: seed {seed}: articulation |gpu - cpu| "
              f"{arti:.3g}, share of pixels that differ {share:.4f}")
        if arti <= 1e-4:
            break
    else:
        raise AssertionError("train reference: no seed of 8 on which the "
                             "card and the CPU pick the same feet")
    if not share <= 0.005:
        raise AssertionError(f"train reference: {share:.4f} of the pixels "
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
    now = (fm.fused_mlp_fwd.launches, fm.fused_mlp_bwd.launches,
           rv.resolve_bwd.launches)
    if any(n <= c for n, c in zip(now, counts)):
        raise AssertionError(f"train reference: kernel launches {counts} -> "
                             f"{now}: the card did not go through a kernel")
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    print(f"train reference: loss gpu {float(l_gpu):.6f} cpu "
          f"{float(l_cpu):.6f} (rel {rel:.3g})")
    if not rel <= 1e-4:
        raise AssertionError(f"train reference: loss differs by {rel}")
    worst, bad, gap, by_net = (0.0, ""), [], {}, {}
    cpu_params = dict(cpu.named_parameters())
    for name, p in gpu.named_parameters():
        q = cpu_params[name]
        if ".ViT." in name:
            if p.grad is not None or q.grad is not None:
                raise AssertionError(f"train reference: {name} has a grad")
            continue
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"train reference: {name}: grad on one "
                                 "device only")
        if p.grad is None:
            if not name.startswith("netInstance.netDeform."):
                raise AssertionError(f"train reference: {name} has no grad")
            continue
        if not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"train reference: {name}: non-finite grad")
        err = float((p.grad.cpu() - q.grad).norm() / q.grad.norm())
        gap[name] = float((p.grad.cpu() - q.grad).abs().max())
        noisy = name.startswith(REF_NOISY_LEAVES)
        if not err <= (REF_NOISY_TOL if noisy else REF_GRAD_TOL):
            bad.append(f"{name}: {err:.3g}")
        worst = max(worst, (err, name))
        net = ".".join(name.split(".")[:2]) + (" (wide bound)" if noisy
                                               else "")
        by_net[net] = max(by_net.get(net, 0.0), err)
    print(f"train reference: worst grad |gpu - cpu| / norm = {worst[0]:.3g} "
          f"({worst[1]}); by network "
          + ", ".join(f"{k} {v:.3g}" for k, v in by_net.items()))
    if bad:
        raise AssertionError("train reference: grads differ by more than "
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
                raise AssertionError(f"train reference: {name} moved "
                                     "without a gradient")
            continue
        if float(diff.max()) > 2.1 * lr or \
                float((diff * clear[name]).max()) > 0.02 * lr:
            raise AssertionError(f"train reference: {name} differs after the "
                                 f"step by {float(diff.max())}")
        moved = max(moved, float((q.detach() - state[name]).abs().max()))
    if not moved > 0:
        raise AssertionError("train reference: the step moved no parameter")
    print(f"train reference: parameters agree after one Adam step (largest "
          f"move {moved:.3g})")


def train_slice_phase(model, B):
    """Full-width training steps; returns the launch counts."""
    import torch
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.ops import fused_mlp as fm
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.ops import resolve_cuda as rv
    from animals3d_tpu_torch.trainer import make_optimizer, train_step
    batch = fake_batch(model, B, SEED)
    phase = model.phase_for_iter(TRAIN_IT)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    if not model.netBase._use_fused_sweep(training=True):
        raise AssertionError("train slice: the fused sweep is off")
    print(f"train slice: iter {TRAIN_IT} phase {phase} grid {grid.res} "
          f"v_cap {v_cap} f_cap {f_cap} batch {B}")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    fixed = draw_noise(model, torch.Generator().manual_seed(SEED), B)

    def fixed_loss():
        # the loss on the same batch with the same draws, without a step
        g = torch.Generator(device="cuda").manual_seed(SEED + 1)
        with torch.no_grad():
            loss, _ = model.forward(batch, TRAIN_IT, g, phase, noise=fixed)
        return float(loss)
    first = fixed_loss()
    kernels = {"raster_vis": rc.visibility,
               "fused_mlp_fwd": fm.fused_mlp_fwd,
               "fused_mlp_bwd": fm.fused_mlp_bwd,
               "resolve_bwd": rv.resolve_bwd}
    for k in kernels.values():
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    steps = WARMUP_RUNS + TIMED_RUNS
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = train_step(model, opt, batch, TRAIN_IT, gen, phase)
        torch.cuda.synchronize()
        if i >= WARMUP_RUNS:
            times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
    launches = {name: k.launches for name, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    last = fixed_loss()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train slice: non-finite loss in {losses}")
    for name, n in launches.items():
        if n != steps:
            raise AssertionError(f"train slice: {name} launched {n} times in "
                                 f"{steps} steps")
    if not last < first:
        raise AssertionError(f"train slice: the loss on the trained batch "
                             f"(same draws) went {first} -> {last}")
    after = model.state_dict()
    changed = sum(not torch.equal(before[k], after[k]) for k in before)
    finite = all(bool(torch.isfinite(v).all()) for v in after.values()
                 if v.is_floating_point())
    vit_same = all(torch.equal(before[k], after[k]) for k in before
                   if ".ViT." in k)
    if not (changed > 40 and finite and vit_same):
        raise AssertionError(f"train slice: {changed} tensors changed, "
                             f"finite {finite}, ViT untouched {vit_same}")
    med = statistics.median(times)
    print(f"train slice: losses per step {[round(x, 4) for x in losses]}; "
          f"loss on the batch with fixed draws {first:.4f} -> {last:.4f}")
    print(f"train slice: train_step median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} steps (spread "
          f"{(max(times) - min(times)) / med * 100:.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB, launches in {steps} steps {launches}, "
          f"{changed} parameter tensors changed; card {card_line()}")
    # back to the initial weights for the reconstruction slice
    model.load_state_dict(before)
    return launches


def slice_phase():
    """Full-width reconstruction; returns (launches, renders)."""
    import torch
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.precision import set_mixed_precision
    cfg, model = build([], "cuda")
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


def drive(model, images, it, B, H):
    """The main path: warm-up and timed `reconstruct` runs."""
    import torch
    times = []
    shaded = out = None
    torch.cuda.reset_peak_memory_stats()
    for i in range(WARMUP_RUNS + TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        shaded, out = model.reconstruct(model, images, it)
        torch.cuda.synchronize()
        if i >= WARMUP_RUNS:
            times.append((time.perf_counter() - t0) * 1e3)
    return shaded, out, times, WARMUP_RUNS + TIMED_RUNS


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
    train_reference_phase()

    model, images, it, B, H = slice_phase()
    entry = visibility_phase(model, images, it, torch.device("cuda"))
    from animals3d_tpu_torch.data.synth import fake_batch
    fwd_entry, bwd_entry = sweep_phase(model)
    res_entry = resolve_phase(model, fake_batch(model, B, SEED))
    entries = [entry, fwd_entry, bwd_entry, res_entry]

    # main path 1: the training step
    launches = train_slice_phase(model, B)
    for e in entries:
        e["launches"] = e["launches_train"] = launches[e["name"]]
        e["launches_recon"] = 0

    # main path 2: reconstruction
    rc.visibility.launches = 0
    shaded, out, times, renders = drive(model, images, it, B, H)
    recon_launches = rc.visibility.launches
    alpha = check_slice(shaded, out, B, H)
    if recon_launches != renders:
        raise AssertionError(f"visibility kernel launched {recon_launches} "
                             f"times in {renders} renders")
    entry["launches_recon"] = recon_launches
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: reconstruct median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} runs (spread "
          f"{(max(times) - min(times)) / med * 100:.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB, mask px per image {alpha.tolist()}, "
          f"visibility launches {recon_launches} in {renders} renders; "
          f"card {card}")
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
