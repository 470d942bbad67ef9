#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`animals3d_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, in this order, each fatal on failure:
  1. build: compile the hand-written CUDA kernel from `csrc/` with nvcc
     and print the compiler's register / shared-memory report;
  2. reference: single-image reconstruction of a small float32 model on
     the card against the same model on the CPU (where the visibility
     step runs its plain version);
  3. kernels: run each kernel against its plain PyTorch version on the
     card — the tile visibility kernel on a random scene, the exact-z
     depth-stack scene, the prior mesh of the full-width model posed by
     10 cameras at 256² (face capacity 196,608) and the full-width
     recon's own posed meshes (the inputs `reconstruct` rasterizes).
     face_id and the per-tile chunk flags must be identical and z equal
     where the ids agree. Times the kernel and the plain version (CUDA
     events, medians) on the last two scenes and computes the kernel's
     bound from this run's inputs; the `kernels` line reports the recon
     scene;
  4. slice: `reconstruct` of `train_magicpony_horse` at full width —
     iter-50000 phase (coarse grid 128, articulation on), batch 10 at 256²,
     dino_vits8, bf16 compute — with random weights from `init_params(0)`:
     2 warm-up runs, then timed runs. The kernels' launch counters are set
     to 0 just before this phase and read just after it; every render must
     have launched the visibility kernel once.

Prints a `kernels` JSON line, the card's name and power limit, and as the
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
SEED = 0
TIMED_RUNS = 10
WARMUP_RUNS = 2
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
    print(f"slice: {cfg['model']['name']} iter {it} phase {phase} "
          f"grid {grid.res} v_cap {v_cap} f_cap {f_cap} batch {B} {H}x{H} "
          f"{cfg['model']['cfg_predictor_instance']['cfg_encoder']['which_vit']}"
          f" compute {cfg.get('mixed_precision')}")
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
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; tf32 off")

    t0 = time.perf_counter()
    print(rc.build())
    print(f"build: {time.perf_counter() - t0:.1f} s")

    reference_phase()

    model, images, it, B, H = slice_phase()
    entry = visibility_phase(model, images, it, torch.device("cuda"))

    rc.visibility.launches = 0
    shaded, out, times, renders = drive(model, images, it, B, H)
    launches = rc.visibility.launches
    alpha = check_slice(shaded, out, B, H)
    if launches != renders:
        raise AssertionError(f"visibility kernel launched {launches} times "
                             f"in {renders} renders")
    entry["launches"] = launches
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated()
    print(f"slice: reconstruct median {med:.2f} ms per batch of {B} "
          f"({B / med * 1e3:.2f} imgs/s), min {min(times):.2f} max "
          f"{max(times):.2f} ms over {len(times)} runs (spread "
          f"{(max(times) - min(times)) / med * 100:.1f}%), peak memory "
          f"{peak / 2**30:.2f} GiB, mask px per image {alpha.tolist()}, "
          f"visibility launches {launches} in {renders} renders; card {card}")
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
