"""Training visuals (port of `animals3d_tpu.utils.visual_log`) — parity
with the reference's `AnimalModel.log_visuals`
(`model/models/AnimalModel.py:517-740`).

Host-side numpy: the functions take the eval forward's `aux` dict (tensors
on any device, or numpy arrays) plus pre-rendered extra buffers, and feed
a tensorboard or wandb writer. Bone overlays are drawn with a tiny numpy
line rasterizer instead of the reference's matplotlib figure round-trip
(`render_bones`, `:703-740`).
"""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    """A tensor on any device (a bf16 one as float32), or an array, as a
    numpy array."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def image_grid(imgs: np.ndarray, pad: int = 0) -> np.ndarray:
    """(N, C, H, W) -> single (C, H', W') row-major grid
    (`misc.image_grid`, `misc.py:88-98`)."""
    imgs = np.asarray(imgs)
    n, c, h, w = imgs.shape
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    grid = np.zeros((c, rows * h, cols * w), imgs.dtype)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[:, r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    return grid


def draw_lines(image_chw: np.ndarray, p0s: np.ndarray, p1s: np.ndarray,
               color=(1.0, 0.0, 0.0), samples: int = 64) -> np.ndarray:
    """Draw line segments (pixel coords) onto a (C, H, W) image in-place."""
    C, H, W = image_chw.shape
    col = np.asarray(color, image_chw.dtype)[:C]
    for p0, p1 in zip(p0s, p1s):
        ts = np.linspace(0.0, 1.0, samples)
        xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(int)
        ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(int)
        ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
        image_chw[:, ys[ok], xs[ok]] = col[:, None]
    return image_chw


def project_points(points: np.ndarray, mvp: np.ndarray, h: int, w: int):
    """World points (..., 3) -> pixel coords (..., 2) via one mvp (4, 4)."""
    hom = np.concatenate([points, np.ones_like(points[..., :1])], -1)
    clip = hom @ mvp.T
    ndc = clip[..., :2] / np.maximum(np.abs(clip[..., 3:4]), 1e-9) \
        * np.sign(clip[..., 3:4])
    x = (ndc[..., 0] + 1.0) * 0.5 * w
    y = (ndc[..., 1] + 1.0) * 0.5 * h
    return np.stack([x, y], -1)


def overlay_bones(image_chw: np.ndarray, posed_bones: np.ndarray,
                  mvp: np.ndarray, alpha: float = 0.8) -> np.ndarray:
    """Blend a bone-skeleton line render over an image
    (`AnimalModel.log_visuals`, `:606-610`): bones (K, 2, 3) world coords."""
    C, H, W = image_chw.shape
    overlay = np.ones_like(image_chw)
    pix = project_points(posed_bones.reshape(-1, 3), mvp, H, W) \
        .reshape(-1, 2, 2)
    draw_lines(overlay, pix[:, 0], pix[:, 1], color=(1.0, 0.0, 0.0))
    lines = (overlay < 1.0).any(0, keepdims=True).astype(image_chw.dtype)
    m = lines * alpha
    return m * overlay + (1.0 - m) * image_chw


def _flow_viz(flow_bf2hw: np.ndarray, num_frames: int) -> np.ndarray:
    """(B, F-1, 2, H, W) flow -> (B, F, 3, H, W) displayable
    (`AnimalModel.py:539-555`): +0.5 shift, dummy channel + dummy frame."""
    b, fm1, _, h, w = flow_bf2hw.shape
    viz = np.concatenate([flow_bf2hw + 0.5,
                          np.zeros((b, fm1, 1, h, w), flow_bf2hw.dtype)], 2)
    return np.concatenate(
        [viz, np.zeros((b, 1, 3, h, w), viz.dtype)], 1)


def mark_corner(images_bfchw: np.ndarray, flags_bf: np.ndarray,
                size: int = 16) -> np.ndarray:
    """Red corner marker on flagged frames (`AnimalModel.py:616-622`)."""
    out = images_bfchw.copy()
    red = np.array([1.0, 0.0, 0.0], out.dtype)[:out.shape[2], None, None]
    b, f = flags_bf.shape
    for i in range(b):
        for j in range(f):
            if flags_bf[i, j]:
                out[i, j, :, :size, :size] = red
    return out


def log_visuals(model, writer, batch, aux, extra, total_iter,
                prefix="train_"):
    """Full-parity visual logging. `aux` is the eval forward's logging dict
    (`AnimalModel.forward`); `extra` holds pre-rendered
    geo_normal/kd/shading buffers (B*F, C, H, W) or None."""
    images = _np(batch["images"])
    B, F = images.shape[:2]
    b0 = max(min(B, 16 // F), 1)

    def get(key):
        v = aux.get(key)
        return None if v is None else _np(v)

    def log_image(name, img_bfchw):
        img = np.clip(np.asarray(img_bfchw)[:b0], 0, 1)
        writer.add_image(prefix + "image/" + name,
                         image_grid(img.reshape(-1, *img.shape[2:])),
                         total_iter)

    def hist(name, values):
        if values is not None:
            writer.add_histogram(prefix + name, np.asarray(values),
                                 total_iter)

    log_image("image_gt", images)
    image_pred = get("image_pred")
    if image_pred is not None:
        log_image("image_pred", image_pred)
    mask_gt, mask_pred = get("mask_gt"), get("mask_pred")
    if mask_gt is not None:
        log_image("mask_gt", np.repeat(mask_gt[:, :, None], 3, 2))
    if mask_pred is not None:
        log_image("mask_pred", np.repeat(mask_pred[:, :, None], 3, 2))

    dino_gt, dino_pred = get("dino_gt"), get("dino_pred")
    if dino_gt is not None:
        log_image("dino_feat_im_gt", dino_gt[:, :, :3])
    if dino_pred is not None:
        log_image("dino_feat_im_pred", dino_pred[:, :, :3])
    if batch.get("dino_clusters") is not None:
        log_image("dino_cluster_im_gt", _np(batch["dino_clusters"]))

    flow_gt, flow_pred = get("flow_gt"), get("flow_pred")
    if flow_gt is not None and F > 1:
        log_image("flow_gt", _flow_viz(flow_gt, F))
    if flow_pred is not None and F > 1:
        log_image("flow_pred", _flow_viz(flow_pred, F))

    # histograms (`:558-585`)
    hist("arti_params", get("arti_params"))
    hist("deformation", get("deformation"))
    pose_raw = get("pose_raw")
    if pose_raw is not None:
        names = ["fwd_x", "fwd_y", "fwd_z"]
        for i, n in enumerate(names):
            hist("pose/" + n, pose_raw[..., i])
        for i, n in enumerate(["trans_x", "trans_y", "trans_z"]):
            hist("pose/" + n, pose_raw[..., -3 + i])
    rots_probs = get("rots_probs")
    if rots_probs is not None:
        for i in range(rots_probs.shape[-1]):
            hist(f"pose/rot_prob_{i}", rots_probs[..., i])
    hist("sdf", get("sdf"))
    shape = aux.get("shape")
    if shape is not None:
        hist("coordinates", _np(shape.v_pos))

    light_params = get("light_params")
    if light_params is not None:
        for i, n in enumerate(["dir_x", "dir_y", "dir_z", "int_ambient",
                               "int_diffuse"]):
            hist("light/" + n, light_params[..., i])

    # extra renders with bone overlay + random-pose marker (`:587-624`)
    if extra is not None:
        h, w = images.shape[-2:]
        # a copy: the bone overlay below draws into `geo` in place
        geo = np.array(_np(extra["geo_normal"])).reshape(
            B, F, -1, h, w)[:, :, :3]
        posed_bones = get("posed_bones")
        mvp = get("mvp")
        if posed_bones is not None and mvp is not None:
            pb = posed_bones.reshape(B, F, *posed_bones.shape[-3:])
            mv = mvp.reshape(B, F, 4, 4)
            for i in range(min(b0, B)):
                for j in range(F):
                    geo[i, j] = overlay_bones(geo[i, j], pb[i, j], mv[i, j])
        flags = get("rand_pose_flag")
        if flags is not None:
            geo = mark_corner(geo, flags.reshape(B, F).astype(bool))
        log_image("instance_geo_normal", geo)
        if light_params is not None:
            kd = _np(extra["kd"]).reshape(B, F, -1, h, w)[:, :, :3]
            log_image("albedo", kd)
            shading = _np(extra["shading"]).reshape(B, F, -1, h, w)
            log_image("shading", np.repeat(shading, 3, 2) / 2.0)


def _has_moviepy():
    try:
        import moviepy  # noqa: F401
        return True
    except ImportError:
        return False


_MOVIEPY = None


def log_videos(writer, name_frames: dict, total_iter, prefix="train_",
               fps=2):
    """Turntable videos (`:626-636`): frames are lists of (C, H, W).
    tensorboardX encodes via moviepy; without it, fall back to a horizontal
    filmstrip image so the turntable is still inspectable."""
    global _MOVIEPY
    if _MOVIEPY is None:
        _MOVIEPY = _has_moviepy()
    for name, frames in name_frames.items():
        if not frames:
            continue
        vid = np.clip(np.stack(frames), 0, 1)             # (T, C, H, W)
        if _MOVIEPY or type(writer).__name__ == "WandbWriter":
            writer.add_video(prefix + "animation/" + name, vid[None],
                             total_iter, fps=fps)
        else:
            strip = np.concatenate(list(vid), axis=-1)    # (C, H, T*W)
            writer.add_image(prefix + "animation/" + name, strip, total_iter)
