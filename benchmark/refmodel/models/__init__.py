from refmodel.models.animal import AnimalModel, AnimalModelConfig


def build_model(cfg: dict, device="cuda", **render):
    """Model factory: dispatch on cfg['name'] (MagicPony, Fauna or
    Ponymation). `render` (resolve_rows) goes to
    `AnimalModel`."""
    name = cfg.get("name", "MagicPony")
    if name == "MagicPony":
        from refmodel.models.magicpony import MagicPony
        return MagicPony(cfg, device=device, **render)
    if name == "Fauna":
        from refmodel.models.fauna import Fauna
        return Fauna(cfg, device=device, **render)
    raise NotImplementedError(f"{name} is not ported yet")
