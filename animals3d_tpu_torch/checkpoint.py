"""Checkpoint save/load with the reference's retention and tolerant-restore
semantics (port of `animals3d_tpu.checkpoint`).

Reference: `Trainer.save_checkpoint`/`load_checkpoint`
(`reference model/Trainer.py:79-127`): `checkpoint{total_iter:07d}`
named by iteration, the latest chosen by its digits, the newest
`keep_num` kept, and `strict=False` loading. The storage is the
reference's own form, one `torch.save` file `checkpoint{iter:07d}.pth`
holding a state dict of sections: `model` (the model's `state_dict`),
`optimizer` and `scheduler` (`trainer.Optimizer.state_dict`: each Adam's
and each MultiStepLR's state by name), and `total_iter`. For Fauna the
`optimizer` section also holds `disc`, the discriminator's Adam, and a
resume restores it. The JAX checkpoint drops the discriminator optimizer's
state (its trainer re-initializes it); the port's optimizer state is its
own contract, so the port keeps it.
"""
from __future__ import annotations

import os
import re

import torch


def _ckpt_iter(name: str):
    m = re.findall(r"\d+", name)
    return int(m[-1]) if m else -1


def list_checkpoints(checkpoint_dir: str):
    if not os.path.isdir(checkpoint_dir):
        return []
    names = [n for n in os.listdir(checkpoint_dir)
             if n.startswith("checkpoint") and n.endswith(".pth")]
    return sorted(names, key=_ckpt_iter)


def save_checkpoint(checkpoint_dir: str, total_iter: int, state: dict,
                    keep_num: int = 2):
    """Write `state` (a dict of sections) as checkpoint{total_iter:07d}.pth
    and keep the newest `keep_num` checkpoints (all where it is 0)."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(checkpoint_dir,
                                        f"checkpoint{total_iter:07d}.pth"))
    tmp = path + ".tmp"
    torch.save({**state, "total_iter": int(total_iter)}, tmp)
    os.replace(tmp, path)
    if keep_num > 0:
        for name in list_checkpoints(checkpoint_dir)[:-keep_num]:
            os.remove(os.path.join(checkpoint_dir, name))
    return path


def _merge(target, loaded, path=""):
    """Copy loaded leaves into target where paths match (strict=False):
    → (merged, missing, unexpected). A leaf whose shape differs keeps its
    target value and is reported missing."""
    if isinstance(target, dict) and isinstance(loaded, dict):
        out = {}
        missing = []
        unexpected = [f"{path}/{k}" for k in loaded if k not in target]
        for k, v in target.items():
            if k in loaded:
                merged, miss, unexp = _merge(v, loaded[k], f"{path}/{k}")
                out[k] = merged
                missing += miss
                unexpected += unexp
            else:
                out[k] = v
                missing.append(f"{path}/{k}")
        return out, missing, unexpected
    if loaded is None:
        return target, [path], []
    if hasattr(target, "shape") and hasattr(loaded, "shape") and \
            tuple(target.shape) != tuple(loaded.shape):
        return target, [f"{path} (shape mismatch)"], []
    return loaded, [], []


def _report(what, missing, unexpected):
    if missing:
        print(f"{what}: {len(missing)} missing keys (kept init): "
              f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    if unexpected:
        print(f"{what}: {len(unexpected)} unexpected keys ignored: "
              f"{unexpected[:5]}{'...' if len(unexpected) > 5 else ''}")


def read_checkpoint(path: str, map_location="cpu") -> dict:
    return torch.load(path, map_location=map_location, weights_only=False)


def load_checkpoint(checkpoint_dir: str, model=None, optimizer=None,
                    checkpoint_name: str | None = None, map_location="cpu"):
    """Restore the latest (or named) checkpoint into `model` (tolerantly
    merged into its state dict) and `optimizer` (a `trainer.Optimizer`;
    each Adam and scheduler whose saved state fits its parameter groups).
    Returns the iteration it was saved at, or 0 where there is none."""
    if checkpoint_name is not None:
        path = os.path.join(checkpoint_dir, checkpoint_name)
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
    else:
        names = list_checkpoints(checkpoint_dir)
        if not names:
            return 0
        path = os.path.join(checkpoint_dir, names[-1])
    loaded = read_checkpoint(path, map_location)
    if model is not None:
        load_model_state(model, loaded.get("model"), what="checkpoint")
    if optimizer is not None:
        optimizer.load_state_dict(
            {k: loaded[k] for k in ("optimizer", "scheduler") if k in loaded})
    return max(_ckpt_iter(os.path.basename(path)), 0)


def load_model_state(model, state, what="checkpoint"):
    """Tolerant `model.load_state_dict`: entries absent from `state` or of
    another shape keep their current values; both lists are printed."""
    init = model.state_dict()
    merged, missing, unexpected = _merge(init, state or {})
    _report(what, missing, unexpected)
    model.load_state_dict(merged)
