from animals3d_tpu_torch.models.animal import AnimalModel, AnimalModelConfig


def build_model(cfg: dict, device="cuda", **render):
    """Model factory: dispatch on cfg['name'] (MagicPony, Fauna or
    Ponymation). `render` (raster_variant, resolve_rows) goes to
    `AnimalModel`."""
    name = cfg.get("name", "MagicPony")
    if name == "MagicPony":
        from animals3d_tpu_torch.models.magicpony import MagicPony
        return MagicPony(cfg, device=device, **render)
    if name == "Fauna":
        from animals3d_tpu_torch.models.fauna import Fauna
        return Fauna(cfg, device=device, **render)
    if name == "Ponymation":
        from animals3d_tpu_torch.models.ponymation import Ponymation
        return Ponymation(cfg, device=device, **render)
    raise NotImplementedError(f"{name} is not ported yet")
