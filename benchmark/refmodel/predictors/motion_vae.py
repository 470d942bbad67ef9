"""Ponymation's instance predictor with the motion VAE, for the benchmark's
reference: a frozen copy of `predictors/motion_vae.py` of
`animals3d_tpu_torch` (3DAnimals
`model/predictors/InstancePredictorMotionVAE.py`).

  * stage 2 runs the frozen articulation network as a teacher without
    gradient and the VAE as the student; mu, logvar and both sets of
    angles go into aux for Ponymation's losses;
  * netDeform runs in blocks of whole frames of at most `DEFORM_ROWS`
    vertex rows, so that the reference's transient (rows, 256) float32
    activations fit beside what the benchmark keeps on the card; each row
    is a function of that row alone;
  * `force_avg_deform` averages the deformation over the frames of each
    sequence only where the caller passes the batch and frame counts; the
    instance forward passes neither (in the JAX package and the port
    too), so the training step never averages.

The VAE's ε comes from a `Noise` where it has it, else from the
generator, drawn after the pose hypothesis's draws as in the port. The
port's `generate` (sampling a sequence from the VAE's prior) serves no
cell of the benchmark and is left out of this copy, as is stage 1's
articulation (the VAE is always built; see `refmodel.models.ponymation`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from refmodel.geometry import skinning as sk
from refmodel.geometry.mesh import Mesh, make_mesh
from refmodel.networks.motion_vae import ArticulationVAE
from refmodel.noise import Noise, normal_rows
from refmodel.phase import Phase
from refmodel.predictors.config import InstancePredictorConfig
from refmodel.predictors.instance import InstancePredictor

# vertex rows of one block of netDeform: 4 GiB a 256-wide float32
# activation, of the 18.75 GiB that 20 x 10 frames of 98,304 vertices take
DEFORM_ROWS = 1 << 22


@dataclasses.dataclass(frozen=True)
class MotionVAEConfig:
    latent_dim: int = 256
    z_token_num: int = 1
    transformer_layer_num: int = 4


class MotionVAEPredictor(InstancePredictor):

    def __init__(self, cfg: InstancePredictorConfig,
                 cfg_motion_vae: MotionVAEConfig = MotionVAEConfig(),
                 image_size: int = 256):
        super().__init__(cfg, image_size=image_size)
        self.cfg_motion_vae = vae = cfg_motion_vae
        self.netVAE = ArticulationVAE(
            njoints=self.num_bones,
            feat_dim=self.netEncoder.vit_feat_dim + cfg.cfg_encoder.cout,
            pos_dim=1 + 2 + 3 * 2, n_harmonic_functions=8,
            harmonic_omega0=np.pi * 0.9, latent_dim=vae.latent_dim,
            z_token_num=vae.z_token_num,
            transformer_layer_num=vae.transformer_layer_num)

    def forward_deformation(self, mesh: Mesh, feat, batch_size=None,
                            num_frames=None):
        verts = mesh.v_pos
        N = feat.shape[0]
        verts_b = verts.expand(N, *verts.shape[1:])
        step = max(1, DEFORM_ROWS // verts_b.shape[1])
        deform = torch.cat([self.netDeform(verts_b[i:i + step],
                                           feat[i:i + step])
                            for i in range(0, N, step)]) * 0.1
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
        eps = normal_rows(noise.vae_normal,
                          (vae.z_token_num, batch_size, vae.latent_dim), gen,
                          verts.device, dim=1)
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
