"""Instance predictor: image → (pose, deformation, articulation, texture,
light) (port of `animals3d_tpu.predictors.instance`).

Outside training the pose hypothesis is the most probable one; in training
it is sampled (`sample_pose_hypothesis(random_sample=True)`) from the
draws of a `Noise` or a generator. The articulation refinement pass is not
ported yet and raises. Ponymation's `MotionVAEPredictor` subclasses it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animals3d_tpu_torch.geometry import skinning as sk
from animals3d_tpu_torch.geometry.mesh import Mesh, make_mesh
from animals3d_tpu_torch.networks.articulation import ArticulationNetwork
from animals3d_tpu_torch.networks.encoders import Encoder32
from animals3d_tpu_torch.networks.mlp import CoordMLP
from animals3d_tpu_torch.networks.vit import DinoViT
from animals3d_tpu_torch.noise import Noise, uniform
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
    up = torch.tensor(up, dtype=vec_forward.dtype,
                      device=vec_forward.device).expand_as(vec_forward)
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


class ViTEncoder(nn.Module):
    """Frozen DINO ViT + two `Encoder32` heads on its patch tokens and
    block-11 keys."""

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
        if final_layer_type != "conv":
            raise NotImplementedError(final_layer_type)
        grid = image_size // self.patch_size
        self.final_layer_patch_out = Encoder32(self.vit_feat_dim, cout, grid)
        self.final_layer_patch_key = Encoder32(self.vit_feat_dim, cout, grid)

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
        g_out = self.final_layer_patch_out(patch_out)
        g_key = self.final_layer_patch_key(pk)
        return g_out, g_key, patch_out, pk

    @torch.no_grad()
    def class_token(self, images):
        """The ViT's class token after its final norm, without gradient
        (the query of Fauna's memory bank); images in (-1, 1)."""
        tokens, _ = self.ViT(images)
        return tokens[:, 0]


class InstancePredictor(nn.Module):

    def __init__(self, cfg: InstancePredictorConfig, image_size: int = 256):
        super().__init__()
        self.cfg = cfg
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
        if pose.rot_rep not in ("quadlookat", "octlookat"):
            raise NotImplementedError(
                f"rot_rep {pose.rot_rep!r}: only quad/octlookat are ported")
        self.netPose = Encoder32(vit_feat_dim, 4 * self.num_pose_hypos + 3,
                                 image_size // 8, nf=256)

        if cfg.enable_deform:
            d = cfg.cfg_deform
            self.netDeform = CoordMLP(
                3, 3, d.num_layers, nf=d.hidden_size, activation=None,
                min_max=None, n_harmonic_functions=d.embedder_freq,
                embedder_scalar=scalar, embed_concat_pts=d.embed_concat_pts,
                extra_feat_dim=enc_dim, symmetrize=d.symmetrize)

        if cfg.enable_articulation:
            a = cfg.cfg_articulation
            if a.enable_refine:
                raise NotImplementedError("articulation refinement")
            feat_dim = {"global": enc_dim, "sample": vit_feat_dim,
                        "sample+global": vit_feat_dim + enc_dim}[
                            a.bone_feature_mode]
            self.netArticulation = ArticulationNetwork(
                a.architecture, feat_dim, posenc_dim=1 + 2 + 3 * 2,
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
        trans = torch.tanh(pose[..., -3:]) * torch.as_tensor(
            self.max_trans_xyz_range, device=dev)
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
        fwd = torch.stack([xs, ys, zs], -1) * torch.as_tensor(
            _ORTHANT_SIGNS[cfg.rot_rep][:K], device=dev)
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
        cfg = self.cfg.cfg_pose
        K = self.num_pose_hypos
        rots = poses_raw[..., :K * 4].reshape(-1, K, 4)
        N = rots.shape[0]
        logits = rots[..., 0]
        fwd = rots[..., 1:4]
        trans = poses_raw[..., -3:]
        temp = 1.0 / float(np.clip(total_iter / 1000.0 / cfg.rot_temp_scalar,
                                   1.0, cfg.temp_clip_high))
        probs = torch.softmax(-logits / temp, dim=1)
        naive_w = float(np.clip(1.0 - (total_iter - cfg.naive_probs_iter)
                                / 2000.0, 0.0, 1.0))
        probs = (1.0 / K) * naive_w + probs * (1.0 - naive_w)
        rot_idx = torch.argmax(probs, dim=1)
        rand_flag = torch.zeros((N,), dtype=torch.int32, device=probs.device)
        if random_sample:
            noise = noise or Noise()
            dev = probs.device
            if noise.rand_idx is not None:
                rand_idx = noise.rand_idx.to(dev).long()
            else:
                rand_idx = torch.floor(uniform(None, (N,), gen, dev) * K) \
                    .long().clamp(max=K - 1)
            p_best = float(np.clip((total_iter - cfg.best_pose_start_iter)
                                   / 2000.0, 0.0, 0.8))
            best_flag = uniform(noise.best_u, (N,), gen, dev) < p_best
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
        T = pose[:, -3:] + torch.tensor([0.0, 0.0, -z_off], device=dev)
        w2c = torch.zeros((N, 4, 4), dtype=pose.dtype, device=dev)
        w2c[:, :3, :3] = R
        w2c[:, :3, 3] = T
        w2c[:, 3, 3] = 1.0
        proj = torch.as_tensor(perspective(cfg.fov / 180 * np.pi, 1.0, znear,
                                           zfar), device=dev)
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
        if a.static_root_bones:
            m = torch.ones_like(angles)
            m[:, :, [a.num_body_bones // 2 - 1, a.num_body_bones - 1]] = 0.0
            angles = angles * m
        angles = torch.tanh(angles)
        nb = a.num_body_bones
        n_leg_total = a.num_leg_bones * a.num_legs
        if phase.constrain_legs:
            legs = list(nb + np.arange(n_leg_total))
            scale = torch.ones_like(angles)
            scale[:, :, legs, 2] = 0.3     # twist
            scale[:, :, legs, 1] = 0.3     # side bend
            angles = angles * scale
            if a.use_fauna_constraints:
                top = [10, 13, 16, 19]
                bottom = [8, 9, 11, 12, 14, 15, 17, 18]
                scale = torch.ones_like(angles)
                scale[:, :, top, 1] = 0.05
                scale[:, :, top, 2] = 0.05
                scale[:, :, top, 0] = 0.75
                scale[:, :, bottom, 1] = 0.0
                scale[:, :, bottom, 2] = 0.0
                scale[:, :, bottom, 0] = 0.3
                scale[:, :, list(range(8)), 2] = 0.1
                angles = angles * scale
        if a.extra_constraints:
            legs_all = list(range(nb, nb + n_leg_total))
            top = [nb + i * a.num_leg_bones for i in range(a.num_legs)]
            bottom = [b for b in legs_all if b not in top]
            scale = torch.ones_like(angles)
            scale[:, :, legs_all, 2] = 0.3
            scale[:, :, legs_all, 1] = 0.3
            scale[:, :, top, 1] = 0.05
            scale[:, :, top, 2] = 0.05
            scale[:, :, bottom, 1] = 0.0
            scale[:, :, bottom, 2] = 0.0
            angles = angles * scale
        return angles * (a.max_arti_angle / 180.0 * np.pi)

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
        bp = bp.reshape(N, K, 2, 3)
        dev = bp.device

        mid = bp.mean(2)
        mid4 = torch.cat([mid, torch.ones_like(mid[..., :1])], -1)
        mid_clip = torch.einsum("nij,nkj->nki", mvp, mid4)
        mid_2d = (mid_clip[..., :2] / mid_clip[..., 3:4]).detach()

        bp4 = torch.cat([bp, torch.ones_like(bp[..., :1])], -1)
        cam = torch.einsum("nij,nkej->nkei", w2c, bp4)
        cam3 = cam[..., :3] / cam[..., 3:4] + torch.tensor(
            [0.0, 0.0, self.cfg.cfg_pose.cam_pos_z_offset], device=dev)
        pos3d = cam3.reshape(N, K, 6) / self.cfg.spatial_scale * 2

        idx_in = (torch.arange(K, device=dev) + 0.5) / K * 2 - 1
        idx_in = idx_in[None, :, None].expand(N, K, 1)
        pos_in = torch.cat([mid_2d, pos3d, idx_in], -1).detach()

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

    # ------------------------------------------------------------------
    def forward(self, images, prior_mesh: Mesh, total_iter,
                phase: Phase = Phase(), gen=None, noise: Noise = None):
        """The 12-tuple (shape, pose_raw, pose, mvp, w2c, campos, feat_out,
        feat_key, deformation, arti_params, light_params, aux)."""
        batch_size, num_frames = images.shape[:2]
        feat_out, feat_key, patch_out, patch_key = \
            self.forward_encoder(images)
        poses_raw = self.forward_pose(patch_out, patch_key, zeroy=phase.zeroy)
        pose_raw, pose, aux = self.sample_pose_hypothesis(
            poses_raw, total_iter,
            random_sample=(phase.is_training and self.cfg.cfg_pose.rand_campos),
            gen=gen, noise=noise)
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
