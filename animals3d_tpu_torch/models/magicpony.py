"""MagicPony: category-specific single-image articulated 3D
reconstruction — the base AnimalModel with no extras."""
from animals3d_tpu_torch.models.animal import AnimalModel


class MagicPony(AnimalModel):
    pass
