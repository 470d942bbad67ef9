"""The two sides of a comparison: the program under test (the port,
`animals3d_tpu_torch`) and the plain reference (`refmodel`, beside this
package), each with the same small interface, so that an entry drives
either one. The reference in a lower precision ("fp8") stands in for the
program in the control runs."""
from __future__ import annotations

import importlib


class Side:
    """`package` is the top-level module of the model code; `precision`
    overrides the configuration's (None keeps it)."""

    def __init__(self, package: str, precision=None, name=None):
        self.package = package
        self.precision = precision
        self.name = name or package

    def _mod(self, sub: str):
        return importlib.import_module(f"{self.package}.{sub}")

    def load_config(self, config_name: str, overrides: list) -> dict:
        return self._mod("config").load_config(config_name, list(overrides))

    def set_precision(self, cfg: dict) -> None:
        mode = self.precision if self.precision is not None \
            else cfg.get("mixed_precision")
        self._mod("precision").set_mixed_precision(mode)

    def build(self, cfg: dict, device):
        """The model as the command line builds it (`run.build`): the
        config's model section with its dataset section."""
        model_cfg = dict(cfg.get("model") or {})
        model_cfg["dataset"] = cfg.get("dataset")
        return self._mod("models").build_model(model_cfg, device=device)

    def make_optimizer(self, model):
        return self._mod("trainer").make_optimizer(model)

    def train_step(self, model, optimizer, batch, total_iter, gen, phase):
        return self._mod("trainer").train_step(model, optimizer, batch,
                                               total_iter, gen, phase)

    def disc_step(self, model, optimizer, record):
        return self._mod("trainer").disc_step(model, optimizer, record)

    def reconstruct(self, model, images, total_iter: int):
        return model.reconstruct(model, images, total_iter)


def program() -> Side:
    return Side("animals3d_tpu_torch", name="program")


def reference(precision: str = "float32") -> Side:
    return Side("refmodel", precision=precision, name="reference")
