"""Carry a flax parameter tree (nested dicts of numpy arrays, as the JAX
package's `init_params` returns it) into the port's modules.

The port names its submodules as the flax modules are named, so a leaf at
path a/b/c/kernel lands on module a.b.c: a Dense kernel (in, out) becomes
a Linear weight (out, in), a Conv kernel HWIO becomes OIHW, a norm's
`scale` becomes `weight`, `_SplitFirstDense` keeps its (pixel ⊕
feature) split, and a `LinearMod`'s (in, out) `weight` leaf becomes its
(out, in) weight (`FLAX_WEIGHT_IN_OUT`); Fauna's memory bank, its keys
and `netDisc`, Ponymation's `netVAE` (its query tokens are plain
leaves, its attention's q, k, v and proj Dense layers), and the CNN
encoders (a `FrozenBatchNorm`'s `mean` and `var` are plain leaves) need
nothing more. Every leaf is consumed exactly once and
every parameter of the module is set, or this raises. `export_jax_params`
is the inverse (the module's parameters as a flax-layout numpy tree) and
`export_jax_grads` lays the parameters' gradients out the same way.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _in_out_weights(model: nn.Module) -> set:
    """Names of the parameters whose flax leaf is an (in, out) `weight`
    (the modules with `FLAX_WEIGHT_IN_OUT`)."""
    return {f"{n}.weight" if n else "weight"
            for n, m in model.named_modules()
            if getattr(m, "FLAX_WEIGHT_IN_OUT", False)}


def load_jax_params(model: nn.Module, tree: dict, strict: bool = True) -> None:
    """Set the model's parameters from `tree`. With `strict=False` (a warm
    start from a partial checkpoint) parameters absent from the tree keep
    their values, leaves without a parameter of their shape are skipped,
    and both counts are printed."""
    params = dict(model.named_parameters())
    in_out = _in_out_weights(model)
    done, skipped = set(), []
    for path, leaf in _leaves(tree):
        leaf = np.asarray(leaf)
        *mod_path, name = path
        if name == "kernel":
            target = ".".join(mod_path + ["weight"])
            if leaf.ndim == 2:
                leaf = leaf.T
            elif leaf.ndim == 4:
                leaf = leaf.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"{'/'.join(path)}: kernel of rank "
                                 f"{leaf.ndim}")
        elif name == "scale":
            target = ".".join(mod_path + ["weight"])
        else:
            target = ".".join(mod_path + [name])
            if target in in_out:
                leaf = leaf.T
        if target not in params:
            if not strict:
                skipped.append("/".join(path))
                continue
            raise KeyError(f"{'/'.join(path)}: no parameter {target}")
        if target in done:
            raise KeyError(f"{target} set twice")
        p = params[target]
        if tuple(p.shape) != leaf.shape:
            if not strict:
                skipped.append("/".join(path))
                continue
            raise ValueError(f"{target}: shape {tuple(p.shape)} vs "
                             f"{leaf.shape} from {'/'.join(path)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(leaf, copy=True)))
        done.add(target)
    missing = sorted(set(params) - done)
    if not strict:
        print(f"warm start: {len(missing)} parameters kept at init, "
              f"{len(skipped)} leaves of the tree skipped")
    elif missing:
        raise KeyError(f"parameters not in the tree: {missing}")


def _to_flax(name: str, value: np.ndarray, in_out: set):
    """(path, array) of one port tensor in the flax tree's layout."""
    *mod_path, leaf = name.split(".")
    if name in in_out:
        return tuple(mod_path) + ("weight",), value.T
    if leaf == "weight":
        if value.ndim == 2:
            return tuple(mod_path) + ("kernel",), value.T
        if value.ndim == 4:
            return tuple(mod_path) + ("kernel",), value.transpose(2, 3, 1, 0)
        if value.ndim == 1:                          # a norm's scale
            return tuple(mod_path) + ("scale",), value
        raise ValueError(f"{name}: weight of rank {value.ndim}")
    return tuple(mod_path) + (leaf,), value


def _tree(model: nn.Module, pick) -> dict:
    tree: dict = {}
    in_out = _in_out_weights(model)
    for name, p in model.named_parameters():
        value = pick(name, p)
        if value is None:
            continue
        path, arr = _to_flax(name, value.detach().cpu().numpy(), in_out)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(arr, copy=True)
    return tree


def export_jax_params(model: nn.Module) -> dict:
    """The module's parameters as a flax-layout tree of numpy arrays (the
    inverse of `load_jax_params`)."""
    return _tree(model, lambda _name, p: p)


def export_jax_grads(model: nn.Module) -> dict:
    """The parameters' gradients in the flax tree's layout; a parameter
    without a gradient (frozen, or unused in the step) is left out."""
    return _tree(model, lambda _name, p: p.grad)
