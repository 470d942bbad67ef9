from refmodel.predictors.base import BasePredictor
from refmodel.predictors.config import (
    ArticulationConfig, BasePredictorConfig, DeformConfig, DINOConfig,
    InstancePredictorConfig, LightingConfig, PoseConfig, ShapeConfig,
    TextureConfig, ViTEncoderConfig,
)
from refmodel.predictors.instance import InstancePredictor
