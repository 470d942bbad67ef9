from animals3d_tpu_torch.predictors.base import BasePredictor
from animals3d_tpu_torch.predictors.config import (
    ArticulationConfig, BasePredictorConfig, DeformConfig, DINOConfig,
    InstancePredictorConfig, LightingConfig, PoseConfig, ShapeConfig,
    TextureConfig, ViTEncoderConfig,
)
from animals3d_tpu_torch.predictors.instance import InstancePredictor
