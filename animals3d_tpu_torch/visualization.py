"""Offline visualization: render modes, turntables, animation, finetuning
(port of `animals3d_tpu.visualization`).

Reference: `visualization/visualize_results.py` and
`visualize_results_fauna.py`: netBase/netInstance run directly, without
the Trainer; render modes `input_view`, `other_views` (12 azimuths),
`rotation` (75-frame turntable), `animation` (keyframe articulation
interpolation from txt files) and `canonicalization` (a morph to the
canonical pose); test-time texture finetuning; keypoint-transfer artifacts
(read by `animals3d_tpu_torch.evaluation`).

Entry: `python -m animals3d_tpu_torch.visualization --config-name
test_magicpony_horse [--device cpu] [key=value ...]`. The model runs on
the card unless the CPU is asked for. The JAX package's three keys
(`PRNGKey(0)`, `(1)` and `(2)`, the last for Ponymation's VAE) are
`torch.Generator`s of those seeds; `Visualizer.noise` may hand the
reconstruction and the finetune step fixed draws instead (a `Noise` under
"reconstruct" or "finetune").
"""
from __future__ import annotations

import os
import time
from glob import glob

import numpy as np
import torch

from animals3d_tpu_torch import checkpoint as ckpt
from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch.geometry.skinning import (axis_angle_to_matrix,
                                                   euler_angles_to_matrix,
                                                   matrix_to_axis_angle)
from animals3d_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from animals3d_tpu_torch.render.camera import xfm_points
from animals3d_tpu_torch.render.light import fixed_direction_light
from animals3d_tpu_torch.utils import results_io


def azimuth_rotation(angle):
    """4x4 rotation about +y by `angle` (turntable camera orbits)."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    return torch.stack([
        torch.stack([c, zero, s, zero], -1),
        torch.stack([zero, one, zero, zero], -1),
        torch.stack([-s, zero, c, zero], -1),
        torch.stack([zero, zero, zero, one], -1)], -2)


def orbit_cameras(mvp, w2c, campos, angles):
    """Rotate one camera around the object by each angle → batched
    cameras (K, 4, 4), (K, 4, 4), (K, 3)."""
    rot = azimuth_rotation(torch.as_tensor(
        np.asarray(angles, np.float32), device=mvp.device))
    mvp_k = torch.einsum("ij,kjl->kil", mvp, rot)
    w2c_k = torch.einsum("ij,kjl->kil", w2c, rot)
    campos_k = torch.einsum("kji,j->ki", rot[:, :3, :3], campos)
    return mvp_k, w2c_k, campos_k


def _np(x):
    return x.detach().cpu().numpy()


class Visualizer:
    def __init__(self, cfg: dict, device="cuda"):
        from animals3d_tpu_torch.models import build_model
        self.cfg = cfg
        model_cfg = dict(cfg.get("model") or {})
        model_cfg["dataset"] = cfg.get("dataset")
        self.model = build_model(model_cfg, device=device)
        self.device = self.model.device
        self.render_modes = tuple(cfg.get("render_modes", ("input_view",)))
        self.output_dir = cfg.get("output_dir", "visualization")
        self.resolution = int(cfg.get("resolution", 256))
        self.spp = int(cfg.get("spp", 4))
        self.finetune_texture = bool(cfg.get("finetune_texture", False))
        self.finetune_iters = int(cfg.get("finetune_iters", 10))
        self.finetune_lr = float(cfg.get("finetune_lr", 0.001))
        self.evaluate_keypoint = bool(cfg.get("evaluate_keypoint", False))
        # fixed draws for the "reconstruct" and "finetune" forwards
        self.noise = {}
        # wall seconds of each mode of the last `run`, summed over images
        self.seconds = {}

    def _gen(self, seed: int):
        return torch.Generator(device=self.device).manual_seed(seed)

    # -- weights ------------------------------------------------------------
    def load_params(self):
        """Initialize from seed 0, then load `checkpoint_name` of
        `checkpoint_dir` (the latest checkpoint where no name is given):
        the port's checkpoint, or a reference `.pth` through `convert`.
        Returns the model."""
        model = self.model
        model.init_params(0)
        name = self.cfg.get("checkpoint_name")
        cdir = self.cfg.get("checkpoint_dir", ".")
        if name is None:
            ckpt.load_checkpoint(cdir, model)
            return model
        path = os.path.join(cdir, name)
        state = ckpt.read_checkpoint(path)
        if "model" in state:
            ckpt.load_model_state(model, state["model"])
        else:
            from animals3d_tpu_torch import convert
            from animals3d_tpu_torch.convert_jax import load_jax_params
            load_jax_params(model, convert.convert_checkpoint(path, model),
                            strict=False)
        return model

    # -- forward ------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, images, total_iter=10 ** 9):
        """images (1, 1, 3, H, W) → (prior mesh, class vector, the
        instance predictor's 12-tuple) at the eval phase of `total_iter`."""
        model = self.model
        phase = model.phase_for_iter(total_iter, is_training=False)
        grid, v_cap, f_cap = model.grid_for_phase(phase)
        prior_mesh, _sdf, class_vector, _ = model.forward_base(
            grid, v_cap, f_cap, batch={"images": images})
        out = model.netInstance(images, prior_mesh, total_iter, phase,
                                gen=self._gen(2),
                                noise=self.noise.get("reconstruct"))
        return prior_mesh, class_vector, out

    @torch.no_grad()
    def render_views(self, shape, prior_mesh, mvp, w2c, campos, im_features,
                     light_params, class_vector=None,
                     modes=("shaded", "geo_normal")):
        h = w = self.resolution
        return self.model.render(
            list(modes), shape, mvp, w2c, campos, (h, w),
            im_features=im_features, light_params=light_params,
            prior_mesh=prior_mesh, use_dino=False, num_frames=1,
            class_vector=class_vector, spp=self.spp)

    # -- texture finetuning ---------------------------------------------------
    def finetune_loss(self, batch, total_iter=10 ** 9):
        """The finetune's loss on `batch`: the training forward's at
        `total_iter` (MagicPony's), or for Fauna (or with
        `fauna_finetune_loss`) the plain unmasked L1 of the input view on
        the eval-phase nets. Draws from a generator of seed 0 (the JAX
        package takes the same key every step) or `noise["finetune"]`."""
        model = self.model
        phase = model.phase_for_iter(total_iter, is_training=False) \
            ._replace(is_training=True)
        grid, _, _ = model.grid_for_phase(phase)
        gen, noise = self._gen(0), self.noise.get("finetune")
        if type(model).__name__ == "Fauna" or \
                self.cfg.get("fauna_finetune_loss", False):
            eval_phase = phase._replace(is_training=False)
            _, (_m, aux) = model.forward(batch, total_iter, gen, eval_phase,
                                         grid=grid, noise=noise)
            img_gt = batch["images"].reshape(-1, *batch["images"].shape[2:])
            img_pred = aux["image_pred"].reshape(img_gt.shape)
            return (img_pred - img_gt).abs().mean()
        loss, _ = model.forward(batch, total_iter, gen, phase, grid=grid,
                                noise=noise)
        return loss

    def finetune(self, batch, total_iter=10 ** 9):
        """`finetune_iters` Adam steps (optax's: eps 1e-8, no weight decay)
        of `finetune_loss` on netTexture alone, every other parameter
        without gradient for the duration (`visualize_results.py:144-190`;
        Fauna's variant `visualize_results_fauna.py:150-207`)."""
        model = self.model
        tex = list(model.netInstance.netTexture.parameters())
        trainable = {p: p.requires_grad for p in model.parameters()}
        for p in trainable:
            p.requires_grad_(False)
        for p in tex:
            p.requires_grad_(True)
        opt = torch.optim.Adam(tex, lr=self.finetune_lr, eps=1e-8)
        try:
            for _ in range(self.finetune_iters):
                loss = self.finetune_loss(batch, total_iter)
                opt.zero_grad(set_to_none=True)
                if loss.requires_grad:
                    loss.backward()
                for p in tex:   # optax steps a leaf without gradient too
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                opt.step()
        finally:
            for p, flag in trainable.items():
                p.requires_grad_(flag)
            opt.zero_grad(set_to_none=True)
        return model

    # -- keypoint artifacts (`visualize_results.py:213-272`) ----------------
    @torch.no_grad()
    def dump_keypoint_artifacts(self, prefix, shape, mvp):
        """The vertices' uv projections in [-1, 1], their occlusion (a
        vertex is visible where a pixel's winning face holds it) and their
        3D positions, of image 0."""
        v_clip = xfm_points(shape.v_pos, mvp)
        uv = v_clip[..., :2] / v_clip[..., 3:4]
        res = (self.resolution, self.resolution)
        rast = rasterize_cuda(v_clip, shape.t_pos_idx, shape.f_valid, res,
                              v_pos0=shape.v_pos[0])
        fid = _np(rast.face_id[0])
        faces = _np(shape.t_pos_idx)
        vis = np.zeros(shape.v_pos.shape[1], bool)
        hit = np.unique(fid[fid > 0]) - 1
        vis[faces[hit].ravel()] = True
        results_io.save_txt(prefix + "_2d_projection_uv.txt", _np(uv[0]))
        results_io.save_txt(prefix + "_binary_occlusion.txt",
                            (~vis).astype(np.float32)[:, None], fmt="%d")
        results_io.save_txt(prefix + "_3d_vertices.txt",
                            _np(shape.v_pos[0]))

    # -- main ---------------------------------------------------------------
    def run(self):
        """Every image `**/*rgb.jpg` of `dataset.test_data_dir`, in sorted
        order: optional finetune, reconstruction, keypoint artifacts and
        each render mode's files under `output_dir`. Returns the
        directory."""
        from animals3d_tpu_torch.data import util as dutil
        cfg_ds = self.cfg.get("dataset") or {}
        test_dir = cfg_ds.get("test_data_dir")
        stems = sorted(glob(os.path.join(test_dir, "**/*rgb.jpg"),
                            recursive=True))
        stems = [p[:-len("rgb.jpg")] for p in stems]
        os.makedirs(self.output_dir, exist_ok=True)
        self.load_params()
        size = cfg_ds.get("in_image_size", 256)
        self.seconds = {}

        def timed(mode, fn, *args):
            t0 = time.perf_counter()
            result = fn(*args)
            self.seconds[mode] = self.seconds.get(mode, 0.0) \
                + time.perf_counter() - t0
            return result

        for i, stem in enumerate(stems):
            image = dutil.load_image(stem + "rgb.jpg", size)
            images = torch.as_tensor(image, device=self.device)[None, None]

            if self.finetune_texture:
                mask = dutil.load_image(stem + "mask.png", size, mode="L")
                batch = _single_image_batch(image, mask, size, self.device)
                timed("finetune", self.finetune, batch)

            prior_mesh, class_vector, out = timed("reconstruct",
                                                  self.reconstruct, images)
            (shape, pose_raw, pose, mvp, w2c, campos, im_features, feat_key,
             deformation, arti_params, light_params, aux) = out
            prefix = os.path.join(self.output_dir, f"{i:07d}")

            if self.evaluate_keypoint:
                def keypoints():
                    self.dump_keypoint_artifacts(prefix, shape, mvp)
                    results_io.save_txt(prefix + "_pose.txt", _np(pose)[:1])
                timed("evaluate_keypoint", keypoints)

            if "input_view" in self.render_modes:
                def input_view():
                    r = self.render_views(shape, prior_mesh, mvp, w2c,
                                          campos, im_features, light_params,
                                          class_vector,
                                          modes=("shaded", "geo_normal",
                                                 "shading"))
                    results_io.save_image(prefix + "_input_image.png", image)
                    results_io.save_image(prefix + "_input_view.png",
                                          r["shaded"][0, :3])
                    results_io.save_image(
                        prefix + "_input_view_geo_normal.png",
                        r["geo_normal"][0])
                    sh = _np(r["shading"][0])
                    results_io.save_image(
                        prefix + "_input_view_shading.png",
                        np.broadcast_to(sh[:1], (3, *sh.shape[1:])))
                timed("input_view", input_view)

            if "other_views" in self.render_modes:
                def other_views():
                    angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                    frames = self._orbit_frames(shape, prior_mesh, mvp, w2c,
                                                campos, im_features,
                                                light_params, angles,
                                                class_vector)
                    for k, fr in enumerate(frames):
                        results_io.save_image(
                            prefix + f"_other_view_{k:02d}.png", fr)
                timed("other_views", other_views)

            if "rotation" in self.render_modes:
                def rotation():
                    angles = np.linspace(0, 2 * np.pi, 75, endpoint=False)
                    frames = self._orbit_frames(shape, prior_mesh, mvp, w2c,
                                                campos, im_features,
                                                light_params, angles,
                                                class_vector)
                    save_video(prefix + "_rotation.mp4", frames)
                timed("rotation", rotation)

            if "animation" in self.render_modes and arti_params is not None:
                timed("animation", self._render_animation, prefix, out,
                      prior_mesh, class_vector)

            if "canonicalization" in self.render_modes and \
                    arti_params is not None:
                timed("canonicalization", self._render_canonicalization,
                      prefix, out, prior_mesh, class_vector)
        return self.output_dir

    @staticmethod
    def _world_fixed_light(light_params, w2c, w2c_k):
        """The light of the input view, held fixed in world space while the
        camera moves: its camera-space direction to world through w2c's
        rotation, back through the new camera's (`visualize_results.py:
        335-341`)."""
        if light_params is None:
            return None
        light = light_params[:1]
        d = light[..., :3] @ w2c[0, :3, :3] @ w2c_k[0, :3, :3].T
        return torch.cat([d, light[..., 3:]], -1)

    def _orbit_frames(self, shape, prior_mesh, mvp, w2c, campos, im_features,
                      light_params, angles, class_vector):
        frames = []
        for a in angles:
            mvp_k, w2c_k, campos_k = orbit_cameras(mvp[0], w2c[0], campos[0],
                                                   [a])
            light_k = self._world_fixed_light(light_params, w2c, w2c_k)
            r = self.render_views(shape, prior_mesh, mvp_k, w2c_k, campos_k,
                                  im_features[:1], light_k, class_vector,
                                  modes=("shaded",))
            frames.append(_np(r["shaded"][0, :3]))
        return frames

    def _keyframe_sequence(self):
        """Load `arti_params*.txt` keyframes (degrees, (K, 3) each) from
        `cfg.arti_param_dir` and 5-step-interpolate between consecutive
        keyframes (`visualize_results.py:429-443`). → (N, K, 3) radians, or
        None when no directory or files are configured."""
        d = self.cfg.get("arti_param_dir")
        files = sorted(glob(os.path.join(d, "arti_params*.txt"))) if d else []
        if not files:
            return None
        key = np.stack([np.loadtxt(f) for f in files], 0) / 180.0 * np.pi
        interp = 5
        seq = []
        for i in range(len(key) - 1):
            seq.append(key[i])
            for j in range(1, interp):
                t = j / interp
                seq.append(key[i] * (1 - t) + key[i + 1] * t)
        seq.append(key[-1])
        return np.stack(seq, 0)

    def _angles(self, angles, K):
        return torch.as_tensor(np.asarray(angles).reshape(1, 1, K, 3),
                               dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def _render_animation(self, prefix, out, prior_mesh, class_vector):
        (shape, pose_raw, pose, mvp, w2c, campos, im_features, feat_key,
         deformation, arti_params, light_params, aux) = out
        inst = self.model.netInstance
        base = _np(arti_params).reshape(-1, 3)
        K = base.shape[0]
        keyseq = self._keyframe_sequence()
        if keyseq is not None and keyseq.shape[1] == K:
            # the reference's keyframe animation (`visualize_results.py:
            # 409-518`): the canonical camera (identity pose, offset_extra
            # 4) from -120° about y, a full azimuth turn over the sequence,
            # a fixed gray light (0, 0, 1; ambient .2, diffuse .7)
            cpose = torch.cat([torch.eye(3).reshape(-1),
                               torch.zeros(3)])[None].to(self.device)
            mvp0, w2c0, campos0 = inst.get_camera_extrinsics_from_pose(
                cpose, offset_extra=4.0)
            seq = list(keyseq)
            n = len(seq)
            view0 = -120.0 / 180.0 * np.pi
            angles = [view0 + 2 * np.pi * i / max(n - 1, 1)
                      for i in range(n)]
            light = fixed_direction_light(
                torch.tensor([0.0, 0.0, 1.0], device=self.device), 0.2, 0.7,
                1)
            cams = [orbit_cameras(mvp0[0], w2c0[0], campos0[0], [a])
                    for a in angles]
        else:
            # rest → predicted → rest on the input view's camera
            ts = np.linspace(0, 1, 15)
            seq = [base * t for t in np.concatenate([ts, ts[::-1]])]
            light = None if light_params is None else light_params[:1]
            cams = [(mvp[:1], w2c[:1], campos[:1])] * len(seq)
        frames = []
        for angles_k, (mvp_k, w2c_k, campos_k) in zip(seq, cams):
            mesh_k = inst.articulate_with_angles(prior_mesh,
                                                 self._angles(angles_k, K))
            r = self.render_views(mesh_k, prior_mesh, mvp_k, w2c_k, campos_k,
                                  im_features[:1], light, class_vector,
                                  modes=("shaded",))
            frames.append(_np(r["shaded"][0, :3]))
        save_video(prefix + "_animation.mp4", frames)

    @torch.no_grad()
    def _render_canonicalization(self, prefix, out, prior_mesh,
                                 class_vector):
        """Morph the predicted pose and articulation to the canonical -120°
        y view (`visualize_results.py:520-595`): axis-angle viewpoint
        interpolation, camera distance 10 → 14 (offset_extra 0 → 4),
        translation → 0, articulation → the first keyframe (or rest), the
        light held fixed in world space."""
        (shape, pose_raw, pose, mvp, w2c, campos, im_features, feat_key,
         deformation, arti_params, light_params, aux) = out
        inst = self.model.netInstance
        base = _np(arti_params).reshape(1, 1, -1, 3)
        K = base.shape[2]
        keyseq = self._keyframe_sequence()
        target = (keyseq[0].reshape(1, 1, K, 3)
                  if keyseq is not None and keyseq.shape[1] == K
                  else np.zeros_like(base))
        pose_np = _np(pose)
        R0 = pose_np[0, :9].reshape(3, 3)
        T0 = pose_np[0, 9:12]
        ori_axis = _np(matrix_to_axis_angle(torch.as_tensor(R0.T)))
        canon_axis = _np(matrix_to_axis_angle(euler_angles_to_matrix(
            torch.tensor([0.0, -120 / 180 * np.pi, 0.0]), "XYZ")))
        n = int(self.cfg.get("canon_frames", 25))
        frames = []
        for fi in range(n):
            t = fi / (n - 1)
            axis = ori_axis * (1 - t) + canon_axis * t
            R = _np(axis_angle_to_matrix(torch.as_tensor(axis))).T
            cur_pose = torch.as_tensor(np.concatenate(
                [R.reshape(-1), T0 * (1 - t)]).astype(np.float32),
                device=self.device)[None]
            mvp_k, w2c_k, campos_k = inst.get_camera_extrinsics_from_pose(
                cur_pose, offset_extra=4.0 * t)
            angles = base * (1 - t) + target * t
            mesh_k = inst.articulate_with_angles(prior_mesh,
                                                 self._angles(angles, K))
            light_k = self._world_fixed_light(light_params, w2c, w2c_k)
            r = self.render_views(mesh_k, prior_mesh, mvp_k, w2c_k, campos_k,
                                  im_features[:1], light_k, class_vector,
                                  modes=("shaded",))
            frames.append(_np(r["shaded"][0, :3]))
        save_video(prefix + "_canonicalization.mp4", frames)


def _single_image_batch(image, mask, size, device):
    """The training forward's batch of one image (1, 1, ...) with its mask,
    a fixed crop box and no flows, features or background."""
    from animals3d_tpu_torch.data import util as dutil
    box = np.array([0, 100, 100, 512, 512, 1920, 1080, 10.0], np.float32)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)[None, None]
    return {
        "images": t(image), "masks": t(mask),
        "mask_dt": t(dutil.compute_distance_transform(mask)),
        "mask_valid": t(dutil.get_valid_mask(box, size)),
        "flows": None, "bboxs": t(box),
        "bg_images": None, "dino_features": None, "dino_clusters": None,
        "seq_idx": torch.zeros((1,), dtype=torch.int32, device=device),
        "frame_idx": torch.zeros((1, 1), dtype=torch.int32, device=device),
    }


def save_video(path, frames_chw, fps=10):
    """An mp4 through cv2 (the reference uses moviepy or cv2,
    `misc.py:119-142`); without cv2, one png a frame
    (`<path stem>_000.png`, ...)."""
    try:
        import cv2
    except ImportError:
        for i, f in enumerate(frames_chw):
            results_io.save_image(path.replace(".mp4", f"_{i:03d}.png"), f)
        return
    h, w = frames_chw[0].shape[1:]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames_chw:
        img = (np.clip(f, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        vw.write(img[..., ::-1])
    vw.release()


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-name", required=True, dest="config_name")
    ap.add_argument("--config-dir", default=None, dest="config_dir")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_intermixed_args(argv)
    cfg = cfglib.load_config(args.config_name, overrides=args.overrides,
                             config_dir=args.config_dir)
    vis = Visualizer(cfg, device=args.device)
    out = vis.run()
    print(f"visualizations written to {out}")
    return vis


if __name__ == "__main__":
    main()
