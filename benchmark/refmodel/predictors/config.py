"""Predictor config dataclasses.

Key surface matches the reference dataclasses
(`3DAnimals/model/predictors/BasePredictorBase.py:11-41`,
`InstancePredictorBase.py:14-116`) so the same YAML trees bind 1:1
(`config.bind`). All sequence fields are tuples → the dataclasses are
hashable and usable as static flax module attributes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

_NEG = (-1, -1)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    grid_res: int = 64
    spatial_scale: float = 5.0
    num_layers: int = 5
    hidden_size: int = 64
    embedder_freq: int = 8
    embed_concat_pts: bool = True
    init_sdf: Union[int, float, str, None] = None
    jitter_grid: float = 0.0
    symmetrize: bool = False
    grid_res_coarse_iter_range: Optional[Tuple[float, float]] = None
    grid_res_coarse: int = 128
    # band-sparse lattice SDF evaluation (`ops.dmtet.sdf_lattice_banded`):
    # the MLP is evaluated exactly only within ±band_tau fine cells of the
    # coarse-interpolated surface; off by default, where the sweep is
    # dense (`3DAnimals/model/geometry/dmtet.py:294-310`).
    sparse_band_eval: bool = False
    band_tau: float = 4.0
    band_seg_cap: Optional[int] = None
    # static capacity headroom for extracted meshes (geometry.tets.
    # default_capacity): v_cap = mesh_cap_scale·res², f_cap = 2·v_cap.
    # Every capacity-shaped stage scales with it; num_verts/num_faces in
    # ExtractedMesh report true counts for overflow monitoring.
    # MINIMUM ~2.5: a large inscribed sphere already occupies ~2.2·res²
    # vertices (measured 35.4k at res 128) and marching tets SILENTLY
    # truncates the mesh past capacity — values below ~2.5 will clip real
    # shapes with no error. Keep >=3 unless you monitor num_verts.
    mesh_cap_scale: float = 6.0


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    feature_dim: int = 64
    num_layers: int = 5
    hidden_size: int = 64
    activation: str = "sigmoid"
    embedder_freq: int = 8
    embed_concat_pts: bool = True
    symmetrize: bool = False
    minmax: Tuple[float, float] = (0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class BasePredictorConfig:
    cfg_shape: ShapeConfig = dataclasses.field(default_factory=ShapeConfig)
    cfg_dino: DINOConfig = dataclasses.field(default_factory=DINOConfig)


@dataclasses.dataclass(frozen=True)
class BankConfig:
    """Fauna memory bank (`BasePredictorBank.py` config surface)."""
    memory_bank_size: int = 60
    memory_bank_dim: int = 128
    memory_bank_topk: int = 10
    memory_bank_keys_dim: int = 384


@dataclasses.dataclass(frozen=True)
class ViTEncoderConfig:
    cout: int = 256
    which_vit: str = "dino_vits8"
    pretrained: bool = False
    frozen: bool = False
    final_layer_type: str = "conv"


@dataclasses.dataclass(frozen=True)
class TextureConfig:
    texture_iter_range: Tuple[float, float] = _NEG
    cout: int = 9
    num_layers: int = 5
    hidden_size: int = 64
    activation: str = "sigmoid"
    kd_minmax: Tuple = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    ks_minmax: Tuple = ((0.0, 0.0), (0.0, 0.0), (0.0, 0.0))
    nrm_minmax: Tuple = ((-1.0, 1.0), (-1.0, 1.0), (0.0, 1.0))
    embed_concat_pts: bool = True
    embedder_freq: int = 10
    symmetrize: bool = False
    in_layer_relu: bool = False


@dataclasses.dataclass(frozen=True)
class PoseConfig:
    architecture: str = "encoder_dino_patch_key"
    cam_pos_z_offset: float = 10.0
    fov: float = 25.0
    max_trans_xy_range_ratio: float = 1.0
    max_trans_z_range_ratio: float = 1.0
    rot_rep: str = "euler_angle"
    max_rot_x_range: float = 180.0
    max_rot_y_range: float = 180.0
    max_rot_z_range: float = 180.0
    lookat_zeroy: bool = False
    rot_temp_scalar: float = 1.0
    naive_probs_iter: int = 2000
    best_pose_start_iter: int = 6000
    rand_campos: bool = True
    # Fauna: temperature clip max 10 instead of 100
    # (`InstancePredictorFauna.py:46`)
    temp_clip_high: float = 100.0


@dataclasses.dataclass(frozen=True)
class DeformConfig:
    deform_iter_range: Tuple[float, float] = _NEG
    num_layers: int = 5
    hidden_size: int = 64
    embed_concat_pts: bool = True
    embedder_freq: int = 10
    symmetrize: bool = False
    force_avg_deform: bool = True


@dataclasses.dataclass(frozen=True)
class ArticulationConfig:
    articulation_iter_range: Tuple[float, float] = _NEG
    architecture: str = "mlp"
    num_layers: int = 4
    hidden_size: int = 64
    embedder_freq: int = 8
    bone_feature_mode: str = "global"
    num_body_bones: int = 4
    body_bones_mode: str = "z_minmax"
    num_legs: int = 0
    num_leg_bones: int = 0
    attach_legs_to_body_iter_range: Tuple[float, float] = _NEG
    legs_to_body_joint_indices: Optional[Tuple[int, ...]] = None
    static_root_bones: bool = False
    skinning_temperature: float = 1.0
    max_arti_angle: float = 60.0
    constrain_legs: bool = False
    output_multiplier: float = 1.0
    enable_refine: bool = False
    refine_feature_mode: str = ""
    predict_delta: bool = False
    use_fauna_constraints: bool = False
    extra_constraints: bool = False
    enable_articulation_idadd: bool = False
    # Fauna: y-quantile filtering for leg detection
    bone_y_threshold: Optional[float] = None
    nozeroy_start: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class LightingConfig:
    num_layers: int = 5
    hidden_size: int = 64
    amb_diff_minmax: Tuple = ((0.0, 1.0), (0.5, 1.0))


@dataclasses.dataclass(frozen=True)
class InstancePredictorConfig:
    cfg_encoder: ViTEncoderConfig = dataclasses.field(default_factory=ViTEncoderConfig)
    cfg_texture: TextureConfig = dataclasses.field(default_factory=TextureConfig)
    cfg_pose: PoseConfig = dataclasses.field(default_factory=PoseConfig)
    spatial_scale: float = 5.0
    enable_deform: bool = False
    cfg_deform: DeformConfig = dataclasses.field(default_factory=DeformConfig)
    enable_articulation: bool = False
    cfg_articulation: ArticulationConfig = dataclasses.field(default_factory=ArticulationConfig)
    enable_lighting: bool = False
    cfg_light: LightingConfig = dataclasses.field(default_factory=LightingConfig)
