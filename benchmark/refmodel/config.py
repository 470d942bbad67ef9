"""Minimal Hydra-compatible config composition + dataclass binding.

The reference drives everything through Hydra 1.3 + OmegaConf
(`3DAnimals/run.py:7`, `3DAnimals/model/utils/misc.py:243-261`).
Neither is available here, so this module reimplements the subset the config
tree actually uses:

  * a ``defaults:`` list composed in order (``- base``, ``- dataset: image``,
    ``- model: magicpony``, and relative paths like ``- dataset:
    ../../dataset/image``), with the loading file's own keys merged last;
  * ``${a.b}`` absolute and ``${..a.b}`` relative interpolations (leading dots:
    one dot = current node, each extra dot = one level up — OmegaConf rules);
  * binding of the composed dict onto typed dataclasses, recursing into
    dataclass-typed fields and silently falling back to field defaults for
    missing keys (semantics of ``misc.load_cfg``,
    `3DAnimals/model/utils/misc.py:243-261`);
  * CLI ``key=value`` dotlist overrides.

YAML quirk handled: the reference YAMLs write ``inf`` (not ``.inf``), which
PyYAML parses as the *string* ``"inf"``; the reference float()-converts it
lazily in ``misc.in_range`` (`misc.py:227-240`). We normalize to float at load.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import re
from typing import Any

import yaml

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")

_INTERP_RE = re.compile(r"^\$\{(\.*)([A-Za-z0-9_.]+)\}$")


# ---------------------------------------------------------------------------
# YAML loading and composition
# ---------------------------------------------------------------------------

def _normalize(node: Any) -> Any:
    """Convert 'inf'/'-inf' strings to floats, recursively."""
    if isinstance(node, dict):
        return {k: _normalize(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_normalize(v) for v in node]
    if node == "inf":
        return float("inf")
    if node == "-inf":
        return float("-inf")
    return node


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f)
    return _normalize(data or {})


def deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _compose_file(path: str) -> dict:
    """Load one yaml file, recursively composing its `defaults:` list."""
    raw = _load_yaml(path)
    raw.pop("hydra", None)
    defaults = raw.pop("defaults", [])
    merged: dict = {}
    here = os.path.dirname(path)
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                merged = deep_merge(merged, raw)
                raw = {}
                continue
            sub = _compose_file(os.path.join(here, entry + ".yaml"))
            merged = deep_merge(merged, sub)
        elif isinstance(entry, dict):
            (group, name), = entry.items()
            if "/" in str(name) or str(name).startswith("."):
                # relative path entry, e.g. `dataset: ../../dataset/image`
                # (Hydra resolves these against the config root's group tree;
                # fall back to the trailing `<group>/<name>` under the root)
                sub_path = os.path.normpath(os.path.join(here, str(name) + ".yaml"))
                if not os.path.exists(sub_path):
                    tail = "/".join(p for p in str(name).split("/") if p != "..")
                    sub_path = os.path.join(_CONFIG_DIR, tail + ".yaml")
            else:
                sub_path = os.path.join(here, group, str(name) + ".yaml")
            sub = _compose_file(sub_path)
            merged = deep_merge(merged, {group: sub})
        else:
            raise ValueError(f"bad defaults entry: {entry!r}")
    return deep_merge(merged, raw)


def _resolve_path(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise KeyError(dotted)
    return node


def _resolve_interp(root: dict, node: Any, path: tuple) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_interp(root, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_interp(root, v, path + (str(i),)) for i, v in enumerate(node)]
    if isinstance(node, str):
        m = _INTERP_RE.match(node)
        if m:
            dots, dotted = m.group(1), m.group(2)
            if not dots:
                target = _resolve_path(root, dotted)
            else:
                # one dot = containing node; each extra dot = one level up
                up = len(dots) - 1
                base_path = path[:-1]  # path of the containing dict
                anchor = base_path[: len(base_path) - up] if up else base_path
                target = _resolve_path(root, ".".join(anchor + (dotted,)) if anchor else dotted)
            # targets may themselves be interpolations; resolve one more level
            if isinstance(target, str) and _INTERP_RE.match(target):
                target = _resolve_interp(root, target, path)
            return copy.deepcopy(target)
    return node


def _parse_override_value(text: str) -> Any:
    return _normalize(yaml.safe_load(text))


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Dotlist overrides with Hydra's strictness: overriding a key that is
    absent from the composed config raises (typos don't vanish silently);
    prefix with ``+``/``++`` to add a new key (Hydra 1.3 semantics)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        parts = key.split(".")
        node = cfg
        for i, p in enumerate(parts[:-1]):
            if p not in node or not isinstance(node[p], dict):
                if not allow_new:
                    raise KeyError(
                        f"override {ov!r}: '{'.'.join(parts[:i + 1])}' not in "
                        f"the composed config (use +{key}=... to add)")
                node = node.setdefault(p, {})
            else:
                node = node[p]
        if parts[-1] not in node and not allow_new:
            raise KeyError(
                f"override {ov!r}: '{key}' not in the composed config "
                f"(use +{key}=... to add)")
        node[parts[-1]] = _parse_override_value(val)
    return cfg


def load_config(config_name: str, overrides: list[str] | None = None,
                config_dir: str | None = None) -> dict:
    """Compose `<config_dir>/<config_name>.yaml` (Hydra-style) into a dict."""
    config_dir = config_dir or _CONFIG_DIR
    path = os.path.join(config_dir, config_name + ".yaml")
    cfg = _compose_file(path)
    if overrides:
        cfg = apply_overrides(cfg, list(overrides))
    # resolve interpolations repeatedly until fixpoint (chained interps)
    for _ in range(4):
        resolved = _resolve_interp(cfg, cfg, ())
        if resolved == cfg:
            break
        cfg = resolved
    return cfg


# ---------------------------------------------------------------------------
# Dataclass binding (misc.load_cfg semantics)
# ---------------------------------------------------------------------------

def bind(config_class, cfg: dict | None):
    """Build `config_class` from a dict, recursing into dataclass fields and
    falling back to field defaults for missing keys."""
    cfg = cfg or {}
    kwargs = {}
    for field in dataclasses.fields(config_class):
        ftype = field.type
        if isinstance(ftype, str):  # from __future__ annotations
            ftype = config_class.__dataclass_fields__[field.name].type
        is_dc = dataclasses.is_dataclass(ftype) if not isinstance(ftype, str) else False
        if isinstance(ftype, str):
            # resolve string annotation within the dataclass's module
            import sys
            mod = sys.modules.get(config_class.__module__)
            ftype_resolved = getattr(mod, ftype, None) if mod else None
            if ftype_resolved is not None and dataclasses.is_dataclass(ftype_resolved):
                ftype, is_dc = ftype_resolved, True
        if is_dc:
            kwargs[field.name] = bind(ftype, cfg.get(field.name))
        elif field.name in cfg:
            val = cfg[field.name]
            if isinstance(val, list):
                val = tuple(tuple(v) if isinstance(v, list) else v for v in val)
            kwargs[field.name] = val
        # else: keep dataclass default
    return config_class(**kwargs)


def in_range(x, rng, default_indicator=None) -> bool:
    """Is x in [lo, hi)? Mirrors misc.in_range (`misc.py:227-240`)."""
    lo, hi = float(rng[0]), float(rng[1])
    lo_ok = x >= lo
    hi_ok = x < hi
    if default_indicator is not None:
        if lo == default_indicator:
            lo_ok = True
        if hi == default_indicator:
            hi_ok = True
    return bool(lo_ok and hi_ok)
