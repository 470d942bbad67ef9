"""MagicPony: category-specific single-image articulated 3D
reconstruction — the base AnimalModel with no extras."""
from refmodel.models.animal import AnimalModel


class MagicPony(AnimalModel):
    pass
