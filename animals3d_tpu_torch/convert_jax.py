"""Carry a flax parameter tree (nested dicts of numpy arrays, as the JAX
package's `init_params` returns it) into the port's modules.

The port names its submodules as the flax modules are named, so a leaf at
path a/b/c/kernel lands on module a.b.c: a Dense kernel (in, out) becomes
a Linear weight (out, in), a Conv kernel HWIO becomes OIHW, a norm's
`scale` becomes `weight`, and `_SplitFirstDense` keeps its (pixel ⊕
feature) split. Every leaf is consumed exactly once and every parameter
of the module is set, or this raises.
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


def load_jax_params(model: nn.Module, tree: dict) -> None:
    params = dict(model.named_parameters())
    done = set()
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
        if target not in params:
            raise KeyError(f"{'/'.join(path)}: no parameter {target}")
        if target in done:
            raise KeyError(f"{target} set twice")
        p = params[target]
        if tuple(p.shape) != leaf.shape:
            raise ValueError(f"{target}: shape {tuple(p.shape)} vs "
                             f"{leaf.shape} from {'/'.join(path)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(leaf, copy=True)))
        done.add(target)
    missing = sorted(set(params) - done)
    if missing:
        raise KeyError(f"parameters not in the tree: {missing}")
