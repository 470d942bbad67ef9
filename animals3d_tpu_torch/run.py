"""CLI entry point of the port:
`python -m animals3d_tpu_torch.run --config-name <name> [--config-dir D]
[--device cuda|cpu] [key=value ...]`.

The surface of the repository's `run.py` (the reference's `run.py:7-15`,
a Hydra main), backed by the port's config composer: it builds the model
on `--device` (CUDA unless the CPU is asked for), then runs `train` where
`run_train` is set and `test` where `run_test` is set, in that order.
"""
from __future__ import annotations

import argparse
import sys


def build(argv=None):
    """(config dict, model, Trainer) for the command line `argv`."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config-name", required=True, dest="config_name")
    parser.add_argument("--config-dir", default=None, dest="config_dir")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    args = parser.parse_intermixed_args(argv)

    from animals3d_tpu_torch import config as cfglib
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.trainer import Trainer

    cfg = cfglib.load_config(args.config_name, overrides=args.overrides,
                             config_dir=args.config_dir)
    model_cfg = dict(cfg.get("model") or {})
    model_cfg["dataset"] = cfg.get("dataset")
    model = build_model(model_cfg, device=args.device)
    return cfg, model, Trainer(cfg, model)


def main(argv=None):
    """Run the command line `argv`; returns the `Trainer`."""
    cfg, _model, trainer = build(argv)
    if cfg.get("run_train"):
        trainer.train()
    if cfg.get("run_test"):
        trainer.test()
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
