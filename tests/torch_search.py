"""The key search of the training-forward parity tests, run in a child
process whose OpenMP threads wait passively.

Why: tier-1 runs six pytest workers on one machine, each with torch's
default thread count. torch's CPU ops run on OpenMP (libgomp), whose idle
threads spin at every parallel region's barrier unless `OMP_WAIT_POLICY`
is `PASSIVE`; with six processes of spinning threads on the same cores, a
port forward of the tiny parity model takes ~24 s instead of ~0.12 s
(JAX's forward and backward ~2 s instead of ~0.3 s), and the search pays
that for every key it rejects. libgomp reads the variable once, when
torch loads, so the worker itself cannot change it; a child started with
it set runs the same code at the same thread count (the results are
those of the worker, bit for bit: the wait policy decides how idle
threads wait, not how work is split) at the speed of an idle machine.

    python tests/torch_search.py OUT THREADS MODULE OVERRIDES_JSON IT...

runs `MODULE.child_search(its, overrides)` (a test module's function that
builds its pair of models and searches every iteration) and writes the
results to OUT with `torch.save`. `in_child` is the parent's side.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def in_child(module: str, its, overrides) -> dict:
    """{iteration: `module.child_search`'s result} from a child process
    with passive OpenMP waits and this process's torch thread count."""
    import torch
    env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE",
               PYTHONPATH=os.pathsep.join(
                   [TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "search.pt")
        subprocess.run([sys.executable, os.path.abspath(__file__), out,
                        str(torch.get_num_threads()), module,
                        json.dumps(list(overrides))]
                       + [str(it) for it in its], check=True, env=env,
                       cwd=REPO)
        return torch.load(out, weights_only=False)


def portable(x):
    """`x` with JAX arrays as numpy and torch tensors detached, for
    `torch.save` (dicts, lists, tuples and dataclasses are walked)."""
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        return {k: portable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(portable(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: portable(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    if type(x).__module__.startswith(("jax", "jaxlib")):
        return np.asarray(x)
    return x


def _child(argv):
    out, threads, module, overrides, *its = argv
    # the settings of tests/conftest.py
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    cache = os.environ.get("ANIMALS3D_TEST_XLA_CACHE",
                           "/tmp/animals3d_tpu_test_xla_cache")
    try:
        os.makedirs(cache, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except Exception:
        pass
    import importlib
    import torch
    torch.set_num_threads(int(threads))
    mod = importlib.import_module(module)
    results = mod.child_search([int(it) for it in its], json.loads(overrides))
    torch.save(portable(results), out)


if __name__ == "__main__":
    _child(sys.argv[1:])
