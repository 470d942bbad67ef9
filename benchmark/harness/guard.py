"""The import guard: the benchmark measures the PyTorch port alone, so no
module of JAX or of the JAX package may be loaded in the process that
prints a result. Names compare by their whole top-level part (the text
before the first dot): `animals3d_tpu_torch` is the port and passes,
`animals3d_tpu` is the JAX package and fails."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "animals3d_tpu"})


def forbidden(modules=None) -> list:
    """The loaded module names (of `sys.modules` by default) whose
    top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
