"""Ponymation's instance predictor: motion-VAE articulation (port of
`animals3d_tpu.predictors.motion_vae`).

  * `force_avg_deform` averages the deformation over the frames of each
    sequence where the caller passes the batch and frame counts and
    N = B·F > 1. The instance forward passes neither (in the JAX package
    too), so only a direct call averages;
  * stage 2 (`enable_motion_vae`) runs the frozen articulation network as
    a teacher without gradient and the VAE as the student; mu, logvar and
    both sets of angles go into aux for Ponymation's losses;
  * `generate` encodes one frame picked at random, takes its pose
    without random sampling, samples z ~ 1.5·N(0, 1) and skins the
    decoded sequence onto that frame's shape.

The VAE's ε and `generate`'s frame pick and z come from a `Noise` where it
has them, else from the generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from animals3d_tpu_torch.geometry import skinning as sk
from animals3d_tpu_torch.geometry.mesh import Mesh, make_mesh
from animals3d_tpu_torch.networks.motion_vae import ArticulationVAE
from animals3d_tpu_torch.noise import Noise, normal
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.predictors.config import InstancePredictorConfig
from animals3d_tpu_torch.predictors.instance import InstancePredictor


# vertex rows of one netDeform evaluation: each of its 256-wide float32
# activations over 20 x 10 frames of 98,304 vertices would take 18.75 GiB
DEFORM_ROWS = 1 << 22


@dataclasses.dataclass(frozen=True)
class MotionVAEConfig:
    latent_dim: int = 256
    z_token_num: int = 1
    transformer_layer_num: int = 4
    pe_dropout: float = 0.0


class MotionVAEPredictor(InstancePredictor):

    def __init__(self, cfg: InstancePredictorConfig,
                 enable_motion_vae: bool = True,
                 cfg_motion_vae: MotionVAEConfig = MotionVAEConfig(),
                 image_size: int = 256):
        super().__init__(cfg, image_size=image_size)
        self.enable_motion_vae = enable_motion_vae
        self.cfg_motion_vae = cfg_motion_vae
        if enable_motion_vae:
            vae = cfg_motion_vae
            self.netVAE = ArticulationVAE(
                njoints=self.num_bones,
                feat_dim=self.netEncoder.vit_feat_dim + cfg.cfg_encoder.cout,
                pos_dim=1 + 2 + 3 * 2, n_harmonic_functions=8,
                harmonic_omega0=np.pi * 0.9, latent_dim=vae.latent_dim,
                z_token_num=vae.z_token_num,
                transformer_layer_num=vae.transformer_layer_num)

    def _deform_offsets(self, verts_b, feat):
        """netDeform's output, in chunks of whole images of at most
        `DEFORM_ROWS` vertex rows (each row's value is the same function of
        that row alone, equal within float32 rounding: a matrix product's
        blocking follows its row count)."""
        step = max(1, DEFORM_ROWS // verts_b.shape[1])
        if verts_b.shape[0] <= step:
            return self.netDeform(verts_b, feat)
        return torch.cat([self.netDeform(verts_b[i:i + step],
                                         feat[i:i + step])
                          for i in range(0, verts_b.shape[0], step)])

    def forward_deformation(self, mesh: Mesh, feat, batch_size=None,
                            num_frames=None):
        verts = mesh.v_pos
        N = feat.shape[0]
        verts_b = verts.expand(N, *verts.shape[1:])
        deform = self._deform_offsets(verts_b, feat) * 0.1
        if self.cfg.cfg_deform.force_avg_deform and batch_size is not None \
                and N == batch_size * num_frames and N > 1:
            d = deform.reshape(batch_size, num_frames, *deform.shape[1:])
            deform = d.mean(1, keepdim=True).expand(d.shape) \
                .reshape(-1, *deform.shape[1:])
        out = Mesh(v_pos=verts_b, t_pos_idx=mesh.t_pos_idx,
                   v_valid=mesh.v_valid, f_valid=mesh.f_valid,
                   num_verts=mesh.num_verts, num_faces=mesh.num_faces,
                   v_nrm=None, v_tex=mesh.v_tex.expand(N, *verts.shape[1:]),
                   face_gidx=mesh.face_gidx)
        return out.deform(deform), deform

    def forward_articulation(self, mesh: Mesh, feat, patch_feat, mvp, w2c,
                             batch_size, num_frames, phase: Phase,
                             gen=None, noise: Noise = None):
        if not self.enable_motion_vae:
            return super().forward_articulation(
                mesh, feat, patch_feat, mvp, w2c, batch_size, num_frames,
                phase)
        a = self.cfg.cfg_articulation
        verts = mesh.v_pos
        N = batch_size * num_frames
        verts_bf = verts.reshape(batch_size, num_frames, *verts.shape[1:]) \
            if verts.shape[0] == N else verts[None]
        bones, structure, bones_feat, pos_in = self.get_bones(
            verts_bf, mesh.v_valid, feat, patch_feat, mvp, w2c,
            batch_size, num_frames, phase.attach_legs)
        K = self.num_bones
        # the teacher: the frozen articulation network, without gradient
        with torch.no_grad():
            angles_gt = self.netArticulation(bones_feat, pos_in) \
                .reshape(batch_size, num_frames, K, 3)
            angles_gt = self.apply_articulation_constraints(angles_gt, phase)
        # the student: the VAE
        noise = noise or Noise()
        vae = self.cfg_motion_vae
        eps = normal(noise.vae_normal,
                     (vae.z_token_num, batch_size, vae.latent_dim), gen,
                     verts.device)
        angles_pred, mu, logvar = self.netVAE(bones_feat, pos_in, num_frames,
                                              batch_size, eps)
        angles_pred = self.apply_articulation_constraints(angles_pred, phase)
        posed, aux = sk.skinning(verts_bf, bones, structure, angles_pred,
                                 output_posed_bones=True,
                                 temperature=a.skinning_temperature,
                                 v_valid=mesh.v_valid)
        posed = posed.reshape(N, *posed.shape[2:])
        out_mesh = make_mesh(posed, mesh.t_pos_idx, mesh.v_valid,
                             mesh.f_valid, mesh.num_verts, mesh.num_faces,
                             v_tex=mesh.v_tex.expand(N, *mesh.v_tex.shape[1:]),
                             face_gidx=mesh.face_gidx)
        aux.update({"mu_vae": mu, "log_var_vae": logvar,
                    "articulation_angles_gt": angles_gt,
                    "articulation_angles_pred": angles_pred})
        return out_mesh, angles_pred, aux

    def generate(self, images, prior_mesh: Mesh, total_iter,
                 phase: Phase = Phase(), num_sequence: int = 1,
                 num_frames: int = 10, gen=None, noise: Noise = None):
        """One randomly picked frame's shape and pose with a motion
        sequence sampled from the VAE's prior: the instance predictor's
        12-tuple over num_sequence · num_frames images, the pose, camera,
        features, deformation, light and pose aux of the picked frame
        repeated over them."""
        noise = noise or Noise()
        imgs = images.reshape(-1, *images.shape[2:])
        dev = imgs.device
        if noise.gen_pick is not None:
            idx = int(noise.gen_pick)
        else:
            if gen is None:
                raise ValueError("generate needs its frame pick or a "
                                 "generator")
            idx = int(torch.randint(0, imgs.shape[0], (), generator=gen,
                                    device=gen.device))
        one = imgs[idx][None, None]
        feat_out, feat_key, patch_out, patch_key = self.forward_encoder(one)
        poses_raw = self.forward_pose(patch_out, patch_key, zeroy=phase.zeroy)
        pose_raw, pose, aux = self.sample_pose_hypothesis(
            poses_raw, float("inf"), random_sample=False)
        mvp, w2c, campos = self.get_camera_extrinsics_from_pose(pose)

        shape = prior_mesh
        deformation = None
        if self.cfg.enable_deform:
            shape, deformation = self.forward_deformation(
                shape, feat_key, batch_size=num_sequence,
                num_frames=num_frames)

        a = self.cfg.cfg_articulation
        verts_bf = shape.v_pos[:1][None]
        bones, structure, _, _ = self.get_bones(
            verts_bf, shape.v_valid, None, None, mvp, w2c, 1, 1,
            phase.attach_legs)
        vae = self.cfg_motion_vae
        z = normal(noise.gen_z_normal,
                   (vae.z_token_num, num_sequence, vae.latent_dim), gen, dev)
        angles = self.netVAE.sample(z, num_frames)
        angles = self.apply_articulation_constraints(angles, phase)

        N = num_sequence * num_frames
        verts_rep = verts_bf.expand(num_sequence, num_frames,
                                    *verts_bf.shape[2:])
        posed, arti_aux = sk.skinning(
            verts_rep, bones, structure, angles, output_posed_bones=True,
            temperature=a.skinning_temperature, v_valid=shape.v_valid)
        posed = posed.reshape(N, *posed.shape[2:])
        out_mesh = make_mesh(posed, shape.t_pos_idx, shape.v_valid,
                             shape.f_valid, shape.num_verts, shape.num_faces,
                             v_tex=shape.v_tex[:1].expand(
                                 N, *shape.v_tex.shape[1:]),
                             face_gidx=shape.face_gidx)
        light_params = self.netLight(feat_out) if self.cfg.enable_lighting \
            else None

        def rep(x):
            return None if x is None else x[:1].expand(N, *x.shape[1:])
        aux = {k: rep(v) for k, v in aux.items()}
        aux.update(arti_aux)
        return (out_mesh, rep(pose_raw), rep(pose), rep(mvp), rep(w2c),
                rep(campos), rep(feat_out), rep(feat_key), rep(deformation),
                angles, rep(light_params), aux)
