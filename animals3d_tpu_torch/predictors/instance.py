"""Instance predictor: image → (pose, deformation, articulation, texture,
light) (port of `animals3d_tpu.predictors.instance`).

Outside training the pose hypothesis is the most probable one; in training
it is sampled (`sample_pose_hypothesis(random_sample=True)`) from the
draws of a `Noise` or a generator. The single-pose representations
(`rot_rep` euler_angle, quaternion, lookat) are decoded by `forward_pose`
but, as in the JAX package, have no hypothesis sampling. With
`enable_refine` a second articulation pass (`netArticulationRefine`) reads
the bones posed by the first. Ponymation's `MotionVAEPredictor`
subclasses it.

On a CUDA device `forward` replays as CUDA graphs (`cuda_graphs`): its two
random draws are made first and enter as inputs with the schedules'
values, and every constant it reads is made once per device
(`device.cached`), so that nothing in the replayed part copies from the
host or waits for the card.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.cuda_graphs import GraphCache
from animals3d_tpu_torch.device import cached, constant
from animals3d_tpu_torch.geometry import skinning as sk
from animals3d_tpu_torch.geometry.mesh import Mesh, make_mesh
from animals3d_tpu_torch.networks.articulation import ArticulationNetwork
from animals3d_tpu_torch.networks.encoders import Encoder32
from animals3d_tpu_torch.networks.mlp import CoordMLP
from animals3d_tpu_torch.networks.vit import DinoViT
from animals3d_tpu_torch.noise import Noise, uniform_rows
from animals3d_tpu_torch.ops.image import grid_sample_bilinear
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors.config import InstancePredictorConfig
from animals3d_tpu_torch.render.camera import perspective
from animals3d_tpu_torch.render.light import DirectionalLight

_ORTHANT_SIGNS = {
    "quadlookat": np.array([[1, 1, 1], [-1, 1, 1], [-1, 1, -1], [1, 1, -1]],
                           np.float32),
    "octlookat": np.stack(np.meshgrid(*[np.arange(1, -2, -2)] * 3,
                                      indexing="ij"), -1).reshape(-1, 3)
    .astype(np.float32),
}


def lookat_forward_to_rot_matrix(vec_forward, up=(0.0, 1.0, 0.0)):
    """Rows: right, up, forward."""
    up = constant(tuple(up), vec_forward.device,
                  vec_forward.dtype).expand_as(vec_forward)
    right = torch.cross(up, vec_forward, dim=-1)
    right = right / torch.clamp(torch.linalg.norm(right, dim=-1,
                                                  keepdim=True), min=1e-12)
    vup = torch.cross(vec_forward, right, dim=-1)
    vup = vup / torch.clamp(torch.linalg.norm(vup, dim=-1, keepdim=True),
                            min=1e-12)
    return torch.stack([right, vup, vec_forward], -2)


def softplus_with_init(x, init=0.5):
    beta = np.log(2.0) / init
    return F.softplus(x * beta) / beta


def scale_bones(angles, entries):
    """angles (..., K, 3) × a scale of ones with each (bones, axis, value)
    entry set in turn, made once per entries, K and dtype on the device."""
    K = angles.shape[-2]
    key = ("bone_scale", K, angles.dtype,
           tuple((tuple(int(b) for b in bones), repr(axis), repr(value))
                 for bones, axis, value in entries))

    def make():
        scale = torch.ones((K, 3), dtype=angles.dtype)
        for bones, axis, value in entries:
            scale[list(bones), axis] = value
        return scale
    return angles * cached(key, angles.device, make)


class ViTEncoder(nn.Module):
    """Frozen DINO ViT + two `Encoder32` heads on its patch tokens and
    block-11 keys (`final_layer_type` "conv"), or, with "none", no heads:
    the global features are then the class token and its block-11 key."""

    def __init__(self, cout: int = 256, which_vit: str = "dino_vits8",
                 frozen: bool = True, final_layer_type: str = "conv",
                 image_size: int = 256):
        super().__init__()
        self.frozen = frozen
        self.final_layer_type = final_layer_type
        self.patch_size = 8
        self.vit_feat_dim = 768 if which_vit == "dino_vitb8" else 384
        heads = 6 if which_vit == "dino_vits8" else 12
        self.ViT = DinoViT(patch_size=8, dim=self.vit_feat_dim,
                           num_heads=heads)
        if frozen:
            self.ViT.requires_grad_(False)
        if final_layer_type not in ("conv", "none"):
            raise NotImplementedError(final_layer_type)
        if final_layer_type == "conv":
            grid = image_size // self.patch_size
            self.final_layer_patch_out = Encoder32(self.vit_feat_dim, cout,
                                                   grid)
            self.final_layer_patch_key = Encoder32(self.vit_feat_dim, cout,
                                                   grid)

    def forward(self, images):
        # images: (N, 3, H, W) already rescaled to (-1, 1) by the caller
        N, _, H, W = images.shape
        ph, pw = H // self.patch_size, W // self.patch_size
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.frozen):
            tokens, key11 = self.ViT(images)
        patch_out = tokens[:, 1:].reshape(N, ph, pw, -1).permute(0, 3, 1, 2)
        # (N, heads, T, hd) → (N, heads*hd, ph, pw)
        pk = key11[:, :, 1:].transpose(2, 3).reshape(N, -1, ph, pw)
        if self.final_layer_type == "conv":
            g_out = self.final_layer_patch_out(patch_out)
            g_key = self.final_layer_patch_key(pk)
        else:
            g_out = tokens[:, 0]
            g_key = key11[:, :, 0].reshape(N, -1)
        return g_out, g_key, patch_out, pk

    @torch.no_grad()
    def class_token(self, images):
        """The ViT's class token after its final norm, without gradient
        (the query of Fauna's memory bank); images in (-1, 1)."""
        tokens, _ = self.ViT(images)
        return tokens[:, 0]


class InstancePredictor(nn.Module):

    # Whether the forward draws random numbers past the pose hypothesis's
    # two, which `forward` draws before the rest: a CUDA graph would replay
    # such a draw's numbers, so a predictor that draws so runs eagerly.
    draws_in_forward = False

    def __init__(self, cfg: InstancePredictorConfig, image_size: int = 256):
        super().__init__()
        self.cfg = cfg
        self._graphs = GraphCache("netinstance", self)
        scalar = 2 * np.pi / cfg.spatial_scale * 0.9
        enc_dim = cfg.cfg_encoder.cout
        self.netEncoder = ViTEncoder(
            cout=enc_dim, which_vit=cfg.cfg_encoder.which_vit,
            frozen=cfg.cfg_encoder.frozen,
            final_layer_type=cfg.cfg_encoder.final_layer_type,
            image_size=image_size)
        vit_feat_dim = self.netEncoder.vit_feat_dim

        tex = cfg.cfg_texture
        tex_minmax = tuple(map(tuple, tex.kd_minmax)) + \
            tuple(map(tuple, tex.ks_minmax)) + tuple(map(tuple, tex.nrm_minmax))
        self.netTexture = CoordMLP(
            3, tex.cout, tex.num_layers, nf=tex.hidden_size,
            activation=tex.activation, min_max=tex_minmax,
            n_harmonic_functions=tex.embedder_freq, embedder_scalar=scalar,
            embed_concat_pts=tex.embed_concat_pts, extra_feat_dim=enc_dim,
            symmetrize=tex.symmetrize, in_layer_relu=tex.in_layer_relu)

        pose = cfg.cfg_pose
        half_range = np.tan(pose.fov / 2 / 180 * np.pi) * pose.cam_pos_z_offset
        self.max_trans_xyz_range = np.array([
            pose.max_trans_xy_range_ratio, pose.max_trans_xy_range_ratio,
            pose.max_trans_z_range_ratio], np.float32) * np.float32(half_range)
        # the pose head's width per rotation representation
        if pose.rot_rep == "euler_angle":
            pose_cout = 6                 # 3 angles + 3 translation
            self.max_rot_xyz_range = np.array(
                [pose.max_rot_x_range, pose.max_rot_y_range,
                 pose.max_rot_z_range], np.float32) / 180.0 * np.pi
        elif pose.rot_rep == "quaternion":
            pose_cout = 7                 # 4 quaternion + 3 translation
        elif pose.rot_rep == "lookat":
            pose_cout = 6                 # 3 forward vector + 3 translation
        elif pose.rot_rep in ("quadlookat", "octlookat"):
            pose_cout = 4 * self.num_pose_hypos + 3
        else:
            raise NotImplementedError(pose.rot_rep)
        self.netPose = Encoder32(vit_feat_dim, pose_cout, image_size // 8,
                                 nf=256)

        if cfg.enable_deform:
            d = cfg.cfg_deform
            self.netDeform = CoordMLP(
                3, 3, d.num_layers, nf=d.hidden_size, activation=None,
                min_max=None, n_harmonic_functions=d.embedder_freq,
                embedder_scalar=scalar, embed_concat_pts=d.embed_concat_pts,
                extra_feat_dim=enc_dim, symmetrize=d.symmetrize)

        if cfg.enable_articulation:
            a = cfg.cfg_articulation
            feat_dim = {"global": enc_dim, "sample": vit_feat_dim,
                        "sample+global": vit_feat_dim + enc_dim}[
                            a.bone_feature_mode]
            self.netArticulation = ArticulationNetwork(
                a.architecture, feat_dim, posenc_dim=1 + 2 + 3 * 2,
                num_layers=a.num_layers, nf=a.hidden_size,
                n_harmonic_functions=a.embedder_freq,
                embedder_scalar=np.pi * 0.9,
                enable_articulation_idadd=a.enable_articulation_idadd)
            if a.enable_refine:
                # the second pass reads the bones posed by the first
                refine_dim = 0
                if "dino_global" in a.refine_feature_mode:
                    refine_dim += enc_dim
                if "dino_sample" in a.refine_feature_mode:
                    refine_dim += vit_feat_dim
                self.netArticulationRefine = ArticulationNetwork(
                    a.architecture, refine_dim, posenc_dim=1 + 2 + 3 * 2,
                    num_layers=a.num_layers, nf=a.hidden_size,
                    n_harmonic_functions=a.embedder_freq,
                    embedder_scalar=np.pi * 0.9,
                    enable_articulation_idadd=a.enable_articulation_idadd)

        if cfg.enable_lighting:
            li = cfg.cfg_light
            self.netLight = DirectionalLight(
                enc_dim, mlp_layers=li.num_layers,
                mlp_hidden_size=li.hidden_size,
                intensity_min_max=tuple(map(tuple, li.amb_diff_minmax)))

    @property
    def num_pose_hypos(self) -> int:
        return 8 if self.cfg.cfg_pose.rot_rep == "octlookat" else 4

    @property
    def num_bones(self) -> int:
        a = self.cfg.cfg_articulation
        return a.num_body_bones + a.num_legs * a.num_leg_bones

    # ------------------------------------------------------------------
    def forward_encoder(self, images):
        """images: (B, F, 3, H, W) in [0, 1] → features over N = B·F."""
        return self.netEncoder(images.reshape(-1, *images.shape[2:]) * 2 - 1)

    def forward_pose(self, patch_out, patch_key, zeroy: bool):
        cfg = self.cfg.cfg_pose
        feat = patch_key if cfg.architecture == "encoder_dino_patch_key" \
            else patch_out
        pose = self.netPose(feat)
        dev = pose.device
        trans = torch.tanh(pose[..., -3:]) * constant(
            tuple(self.max_trans_xyz_range.tolist()), dev, torch.float32)
        if cfg.rot_rep == "euler_angle":
            # tanh-bounded xyz angles
            rot_pred = torch.tanh(pose[..., :3]) * constant(
                tuple(self.max_rot_xyz_range.tolist()), dev, torch.float32)
            return torch.cat([rot_pred, trans], -1)            # (N, 6)
        if cfg.rot_rep == "quaternion":
            # shifted at init, normalized, real part >= 0
            quat = pose[..., :4] + constant((0.01, 0.0, 0.0, 0.0), dev)
            quat = quat / torch.clamp(torch.linalg.norm(
                quat, dim=-1, keepdim=True), min=1e-12)
            return torch.cat([quat * torch.sign(quat[..., :1]), trans],
                             -1)                               # (N, 7)
        if cfg.rot_rep == "lookat":
            # one normalized forward vector
            fwd = pose[..., :3]
            if zeroy:
                fwd = fwd * constant((1.0, 0.0, 1.0), dev)
            fwd = fwd / torch.clamp(torch.linalg.norm(
                fwd, dim=-1, keepdim=True), min=1e-12)
            return torch.cat([fwd, trans], -1)                 # (N, 6)
        K = self.num_pose_hypos
        rots = pose[..., :K * 4].reshape(-1, K, 4)
        logits = rots[..., :1]
        fwd = rots[..., 1:4]
        xs, ys, zs = fwd[..., 0], fwd[..., 1], fwd[..., 2]
        xs = softplus_with_init(xs, 0.5)
        if cfg.rot_rep == "octlookat":
            ys = softplus_with_init(ys, 0.5)
        if zeroy:
            ys = ys * 0
        zs = softplus_with_init(zs, 0.5)
        fwd = torch.stack([xs, ys, zs], -1) * cached(
            ("orthant_signs", cfg.rot_rep, K), dev,
            lambda: torch.as_tensor(_ORTHANT_SIGNS[cfg.rot_rep][:K]))
        fwd = fwd / torch.clamp(torch.linalg.norm(fwd, dim=-1, keepdim=True),
                                min=1e-12)
        rot_pred = torch.cat([logits, fwd], -1).reshape(-1, K * 4)
        return torch.cat([rot_pred, trans], -1)

    def sample_pose_hypothesis(self, poses_raw, total_iter,
                               random_sample: bool, gen=None,
                               noise: Noise = None):
        """softmax(-logits / T) with annealed T and uniform blending. The
        eval pose is the most probable hypothesis; with `random_sample` a
        uniformly random one replaces it unless `best_u < p_best` (p_best
        ramps to 0.8), the draws coming from `noise` or `gen`."""
        self._check_hypotheses()
        draws = self.pose_draws(poses_raw.shape[0], random_sample,
                                poses_raw.device, gen, noise)
        return self.select_pose(poses_raw, self.pose_schedule(total_iter),
                                draws)

    def _check_hypotheses(self):
        rot_rep = self.cfg.cfg_pose.rot_rep
        if rot_rep not in ("quadlookat", "octlookat"):
            # as the reference's multi-hypothesis forward asserts
            raise NotImplementedError(
                f"hypothesis sampling requires quad/octlookat, "
                f"got {rot_rep}")

    def pose_schedule(self, total_iter):
        """The pose sampling's schedules at `total_iter`: (temperature,
        naive_w, p_best)."""
        cfg = self.cfg.cfg_pose
        temp = 1.0 / float(np.clip(total_iter / 1000.0 / cfg.rot_temp_scalar,
                                   1.0, cfg.temp_clip_high))
        naive_w = float(np.clip(1.0 - (total_iter - cfg.naive_probs_iter)
                                / 2000.0, 0.0, 1.0))
        p_best = float(np.clip((total_iter - cfg.best_pose_start_iter)
                               / 2000.0, 0.0, 0.8))
        return temp, naive_w, p_best

    def graph_schedule(self, schedule):
        """`pose_schedule`'s values as the pinned host tensor that a CUDA
        graph reads them from: 1 / T as CUDA takes a host divisor (the
        float32 reciprocal of float32 T), the two terms of the uniform
        blend and p_best."""
        temp, naive_w, p_best = schedule
        inv_temp = np.float32(1.0) / np.float32(temp)
        return torch.tensor([inv_temp, (1.0 / self.num_pose_hypos) * naive_w,
                             1.0 - naive_w, p_best],
                            dtype=torch.float32).pin_memory()

    def pose_draws(self, n: int, random_sample: bool, device, gen=None,
                   noise: Noise = None):
        """The random hypothesis's draws for `n` images from `noise` or
        `gen`, in the order the sampling has always made them: (rand_idx,
        best_u), or None without `random_sample`."""
        if not random_sample:
            return None
        noise = noise or Noise()
        K = self.num_pose_hypos
        if noise.rand_idx is not None:
            rand_idx = noise.rand_idx.to(device).long()
        else:
            rand_idx = torch.floor(uniform_rows(None, (n,), gen, device)
                                   * K).long().clamp(max=K - 1)
        return rand_idx, uniform_rows(noise.best_u, (n,), gen, device)

    def select_pose(self, poses_raw, schedule, draws):
        """The sampling from its schedules (`pose_schedule`'s floats, or in
        a CUDA graph the device copy of `graph_schedule`) and its draws
        (`pose_draws`). Both give the same bits on a CUDA device."""
        K = self.num_pose_hypos
        rots = poses_raw[..., :K * 4].reshape(-1, K, 4)
        N = rots.shape[0]
        logits = rots[..., 0]
        fwd = rots[..., 1:4]
        trans = poses_raw[..., -3:]
        if torch.is_tensor(schedule):
            probs = torch.softmax(-logits * schedule[0], dim=1)
            probs = schedule[1] + probs * schedule[2]
            p_best = schedule[3]
        else:
            temp, naive_w, p_best = schedule
            probs = torch.softmax(-logits / temp, dim=1)
            probs = (1.0 / K) * naive_w + probs * (1.0 - naive_w)
        rot_idx = torch.argmax(probs, dim=1)
        rand_flag = torch.zeros((N,), dtype=torch.int32, device=probs.device)
        if draws is not None:
            rand_idx, best_u = draws
            best_flag = best_u < p_best
            rot_idx = torch.where(best_flag, rot_idx, rand_idx)
            rand_flag = 1 - best_flag.to(torch.int32)

        def take(a):
            idx = rot_idx.reshape(-1, *([1] * (a.ndim - 1)))
            return torch.gather(a, 1, idx.expand(N, 1, *a.shape[2:]))[:, 0]

        rot_sel = take(fwd)
        pose_raw = torch.cat([rot_sel, trans], -1)
        rot_mat = lookat_forward_to_rot_matrix(rot_sel)
        pose = torch.cat([rot_mat.reshape(N, 9), trans], -1)
        aux = {"rot_idx": rot_idx, "rot_prob": take(probs),
               "rot_logit": take(logits), "rots_probs": probs,
               "rand_pose_flag": rand_flag}
        return pose_raw, pose, aux

    def get_camera_extrinsics_from_pose(self, pose, znear=0.1, zfar=1000.0,
                                        offset_extra=None):
        """pose (N, 12) → mvp, w2c, campos; `offset_extra` moves the
        camera that much further back (the Visualizer's canonical view)."""
        cfg = self.cfg.cfg_pose
        N = pose.shape[0]
        dev = pose.device
        R = pose[:, :9].reshape(N, 3, 3).transpose(-1, -2)
        z_off = cfg.cam_pos_z_offset + (offset_extra or 0.0)
        T = pose[:, -3:] + constant((0.0, 0.0, -z_off), dev)
        w2c = torch.zeros((N, 4, 4), dtype=pose.dtype, device=dev)
        w2c[:, :3, :3] = R
        w2c[:, :3, 3] = T
        w2c[:, 3, 3].fill_(1.0)
        proj = cached(("perspective", cfg.fov, znear, zfar), dev,
                      lambda: torch.as_tensor(perspective(
                          cfg.fov / 180 * np.pi, 1.0, znear, zfar)))
        mvp = torch.einsum("ij,bjk->bik", proj, w2c)
        campos = -torch.einsum("bji,bj->bi", R, T)
        return mvp, w2c, campos

    # ------------------------------------------------------------------
    def forward_deformation(self, mesh: Mesh, feat):
        """CoordMLP × 0.1 on canonical verts, broadcasting the batch-1
        prior over feat's batch."""
        verts = mesh.v_pos
        N = feat.shape[0]
        verts_b = verts.expand(N, *verts.shape[1:])
        deform = self.netDeform(verts_b, feat) * 0.1
        mesh = Mesh(v_pos=verts_b, t_pos_idx=mesh.t_pos_idx,
                    v_valid=mesh.v_valid, f_valid=mesh.f_valid,
                    num_verts=mesh.num_verts, num_faces=mesh.num_faces,
                    v_nrm=None,
                    v_tex=mesh.v_tex.expand(N, *verts.shape[1:]),
                    face_gidx=mesh.face_gidx)
        return mesh.deform(deform), deform

    def apply_articulation_constraints(self, angles, phase: Phase):
        """tanh + per-bone-group clamps."""
        a = self.cfg.cfg_articulation
        angles = angles * a.output_multiplier
        nb = a.num_body_bones
        if a.static_root_bones:
            angles = scale_bones(angles, [([nb // 2 - 1, nb - 1],
                                           slice(None), 0.0)])
        angles = torch.tanh(angles)
        n_leg_total = a.num_leg_bones * a.num_legs
        if phase.constrain_legs:
            legs = list(nb + np.arange(n_leg_total))
            # twist, side bend
            angles = scale_bones(angles, [(legs, 2, 0.3), (legs, 1, 0.3)])
            if a.use_fauna_constraints:
                top = [10, 13, 16, 19]
                bottom = [8, 9, 11, 12, 14, 15, 17, 18]
                angles = scale_bones(angles, [
                    (top, 1, 0.05), (top, 2, 0.05), (top, 0, 0.75),
                    (bottom, 1, 0.0), (bottom, 2, 0.0), (bottom, 0, 0.3),
                    (range(8), 2, 0.1)])
        if a.extra_constraints:
            legs_all = list(range(nb, nb + n_leg_total))
            top = [nb + i * a.num_leg_bones for i in range(a.num_legs)]
            bottom = [b for b in legs_all if b not in top]
            angles = scale_bones(angles, [
                (legs_all, 2, 0.3), (legs_all, 1, 0.3), (top, 1, 0.05),
                (top, 2, 0.05), (bottom, 1, 0.0), (bottom, 2, 0.0)])
        return angles * (a.max_arti_angle / 180.0 * np.pi)

    def bone_codes(self, bp, mvp, w2c):
        """Bones (N, K, 2, 3) → their midpoints projected through `mvp`
        (N, K, 2) and the per-bone network input (N, K, 9): those
        midpoints, both ends in camera space and the bone's index code.
        The callers stop their gradients."""
        N, K = bp.shape[:2]
        dev = bp.device
        mid = bp.mean(2)
        mid4 = torch.cat([mid, torch.ones_like(mid[..., :1])], -1)
        mid_clip = torch.einsum("nij,nkj->nki", mvp, mid4)
        mid_2d = mid_clip[..., :2] / mid_clip[..., 3:4]

        bp4 = torch.cat([bp, torch.ones_like(bp[..., :1])], -1)
        cam = torch.einsum("nij,nkej->nkei", w2c, bp4)
        cam3 = cam[..., :3] / cam[..., 3:4] + constant(
            (0.0, 0.0, self.cfg.cfg_pose.cam_pos_z_offset), dev)
        pos3d = cam3.reshape(N, K, 6) / self.cfg.spatial_scale * 2

        idx_in = (torch.arange(K, device=dev) + 0.5) / K * 2 - 1
        idx_in = idx_in[None, :, None].expand(N, K, 1)
        return mid_2d, torch.cat([mid_2d, pos3d, idx_in], -1)

    def get_bones(self, verts, v_valid, feat, patch_feat, mvp, w2c,
                  batch_size, num_frames, attach_legs: bool):
        """Rest bones + per-bone network inputs (detached 2D/3D codes and
        features; no features where `feat` or `patch_feat` is None)."""
        a = self.cfg.cfg_articulation
        bones, structure = sk.estimate_bones(
            verts, v_valid, n_body_bones=a.num_body_bones, n_legs=a.num_legs,
            n_leg_bones=a.num_leg_bones, body_bones_mode=a.body_bones_mode,
            attach_legs_to_body=attach_legs,
            bone_y_threshold=a.bone_y_threshold,
            legs_to_body_joint_indices=a.legs_to_body_joint_indices)
        bp = bones.expand(batch_size, num_frames, *bones.shape[2:])
        K = bp.shape[2]
        N = batch_size * num_frames
        mid_2d, pos_in = self.bone_codes(bp.reshape(N, K, 2, 3), mvp, w2c)
        mid_2d, pos_in = mid_2d.detach(), pos_in.detach()
        if feat is None or patch_feat is None:
            return bones, structure, None, pos_in
        g = feat[:, None].expand(N, K, feat.shape[-1])
        local = grid_sample_bilinear(patch_feat, mid_2d[:, None])[:, 0]
        mode = a.bone_feature_mode
        if mode == "global":
            bones_feat = g
        elif mode == "sample":
            bones_feat = local
        else:
            bones_feat = torch.cat([g.to(local.dtype), local], -1)
        return bones, structure, bones_feat, pos_in

    def forward_articulation(self, mesh: Mesh, feat, patch_feat, mvp, w2c,
                             batch_size, num_frames, phase: Phase,
                             gen=None, noise: Noise = None):
        """bones → articulation net → constraints → skinning. `gen` and
        `noise` serve the subclasses' random sites (Ponymation's VAE)."""
        a = self.cfg.cfg_articulation
        verts = mesh.v_pos
        N = batch_size * num_frames
        if verts.shape[0] == N:
            verts_bf = verts.reshape(batch_size, num_frames, *verts.shape[1:])
        else:
            verts_bf = verts[None]                       # (1, 1, V, 3)
        bones, structure, bones_feat, pos_in = self.get_bones(
            verts_bf, mesh.v_valid, feat, patch_feat, mvp, w2c,
            batch_size, num_frames, phase.attach_legs)
        K = self.num_bones
        angles = self.netArticulation(bones_feat, pos_in) \
            .reshape(batch_size, num_frames, K, 3)
        angles = self.apply_articulation_constraints(angles, phase)
        if a.enable_refine:
            angles = self.refine_articulation(
                verts_bf, mesh.v_valid, bones, structure, angles, feat,
                patch_feat, mvp, w2c, phase)
        posed, aux = sk.skinning(verts_bf, bones, structure, angles,
                                 output_posed_bones=True,
                                 temperature=a.skinning_temperature,
                                 v_valid=mesh.v_valid)
        posed = posed.reshape(N, *posed.shape[2:])
        v_tex = mesh.v_tex.expand(N, *mesh.v_tex.shape[1:])
        out_mesh = make_mesh(posed, mesh.t_pos_idx, mesh.v_valid,
                             mesh.f_valid, mesh.num_verts, mesh.num_faces,
                             v_tex=v_tex, face_gidx=mesh.face_gidx)
        return out_mesh, angles, aux

    def refine_articulation(self, verts_bf, v_valid, bones, structure,
                            angles, feat, patch_feat, mvp, w2c,
                            phase: Phase):
        """The second articulation pass: skin once with `angles`, rebuild
        the per-bone codes from the posed bones and the features that
        `refine_feature_mode` names (the global feature and/or the patch
        features sampled at the posed midpoints), then add the predicted
        delta (`predict_delta`) or take the prediction, constrained, as
        the new angles."""
        a = self.cfg.cfg_articulation
        B, Fr, K = angles.shape[:3]
        N = B * Fr
        _, aux0 = sk.skinning(verts_bf, bones, structure, angles,
                              output_posed_bones=True,
                              temperature=a.skinning_temperature,
                              v_valid=v_valid)
        mid_2d, pos_in = self.bone_codes(
            aux0["posed_bones"].reshape(N, K, 2, 3), mvp, w2c)
        mid_2d, pos_in = mid_2d.detach(), pos_in.detach()
        feats = []
        if "dino_global" in a.refine_feature_mode:
            feats.append(feat[:, None].expand(N, K, feat.shape[-1]))
        if "dino_sample" in a.refine_feature_mode:
            feats.append(grid_sample_bilinear(patch_feat,
                                              mid_2d[:, None])[:, 0])
        dtype = torch.promote_types(*[f.dtype for f in feats]) \
            if len(feats) > 1 else feats[0].dtype
        out = self.netArticulationRefine(
            torch.cat([f.to(dtype) for f in feats], -1), pos_in) \
            .reshape(B, Fr, K, 3)
        if a.predict_delta:
            return angles + out
        return self.apply_articulation_constraints(out, phase)

    # ------------------------------------------------------------------
    def forward(self, images, prior_mesh: Mesh, total_iter,
                phase: Phase = Phase(), gen=None, noise: Noise = None):
        """The 12-tuple (shape, pose_raw, pose, mvp, w2c, campos, feat_out,
        feat_key, deformation, arti_params, light_params, aux). The random
        hypothesis's draws come first; on a CUDA device the rest replays
        as CUDA graphs once two calls in a row share phase and shapes
        (`cuda_graphs`), unless the predictor draws more
        (`draws_in_forward`)."""
        random_sample = phase.is_training and self.cfg.cfg_pose.rand_campos
        draws = self.pose_draws(images.shape[0] * images.shape[1],
                                random_sample, images.device, gen, noise)
        schedule = self.pose_schedule(total_iter)
        if images.is_cuda and not self.draws_in_forward:
            out = self._graphs(
                (phase, random_sample),
                lambda im, mesh, d, sched: self.forward_drawn(
                    im, mesh, sched, phase, d),
                (images, prior_mesh, draws, self.graph_schedule(schedule)))
            if out is not None:
                return out
        tracing.count("netinstance.eager_calls", 1)
        return self.forward_drawn(images, prior_mesh, schedule, phase, draws,
                                  gen=gen, noise=noise)

    def forward_drawn(self, images, prior_mesh: Mesh, schedule, phase: Phase,
                      draws, gen=None, noise: Noise = None):
        """`forward` from the sampling's schedules and draws (see
        `select_pose`); `gen` and `noise` serve the subclasses' random
        sites."""
        batch_size, num_frames = images.shape[:2]
        feat_out, feat_key, patch_out, patch_key = \
            self.forward_encoder(images)
        poses_raw = self.forward_pose(patch_out, patch_key, zeroy=phase.zeroy)
        self._check_hypotheses()
        pose_raw, pose, aux = self.select_pose(poses_raw, schedule, draws)
        mvp, w2c, campos = self.get_camera_extrinsics_from_pose(pose)

        shape = prior_mesh
        deformation = None
        if self.cfg.enable_deform and phase.deform_on:
            shape, deformation = self.forward_deformation(shape, feat_key)

        arti_params = None
        if self.cfg.enable_articulation and phase.articulation_on:
            shape, arti_params, arti_aux = self.forward_articulation(
                shape, feat_key, patch_key, mvp, w2c, batch_size, num_frames,
                phase, gen=gen, noise=noise)
            aux.update(arti_aux)

        light_params = self.netLight(feat_out) if self.cfg.enable_lighting \
            else None
        return (shape, pose_raw, pose, mvp, w2c, campos, feat_out, feat_key,
                deformation, arti_params, light_params, aux)

    def articulate_with_angles(self, prior_mesh: Mesh, angles):
        """Re-skin the prior with explicit articulation angles (B, F, K, 3)
        (the Visualizer's animation and canonicalization) → a mesh of
        B·F posed copies."""
        a = self.cfg.cfg_articulation
        B, F_ = angles.shape[:2]
        verts_bf = prior_mesh.v_pos[:1][None]
        bones, structure = sk.estimate_bones(
            verts_bf, prior_mesh.v_valid, n_body_bones=a.num_body_bones,
            n_legs=a.num_legs, n_leg_bones=a.num_leg_bones,
            body_bones_mode=a.body_bones_mode, attach_legs_to_body=True,
            bone_y_threshold=a.bone_y_threshold,
            legs_to_body_joint_indices=a.legs_to_body_joint_indices)
        verts_rep = verts_bf.expand(B, F_, *verts_bf.shape[2:])
        posed, _ = sk.skinning(verts_rep, bones, structure, angles,
                               temperature=a.skinning_temperature,
                               v_valid=prior_mesh.v_valid)
        N = B * F_
        posed = posed.reshape(N, *posed.shape[2:])
        v_tex = prior_mesh.v_tex[:1].expand(N, *prior_mesh.v_tex.shape[1:])
        return make_mesh(posed, prior_mesh.t_pos_idx, prior_mesh.v_valid,
                         prior_mesh.f_valid, prior_mesh.num_verts,
                         prior_mesh.num_faces, v_tex=v_tex,
                         face_gidx=prior_mesh.face_gidx)

    def frozen_vit_class_token(self, images):
        """images (B, F, 3, H, W) in [0, 1] → the frozen ViT's class
        tokens (B·F, D), without gradient."""
        return self.netEncoder.class_token(
            images.reshape(-1, *images.shape[2:]) * 2 - 1)

    def sample_texture(self, tex_pos, feat):
        return self.netTexture(tex_pos, feat)

    def light(self, feat):
        return self.netLight(feat)
