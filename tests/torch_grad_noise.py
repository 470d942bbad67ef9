#!/usr/bin/env python3
"""How much of the gap between the port's and the JAX package's training
gradients is float32 rounding: a second witness for the tolerances of
`tests/test_torch_train.py`.

    python3 tests/torch_grad_noise.py [--key K] [--targets dark|uniform]

On the CPU, in float32, with the models, batch and noise of
`test_torch_train.py`: takes the first random key from K on which the two
packages' discrete decisions agree, and prints for every trained leaf of
the gradient tree, each as |Δ| over the leaf's norm,

  t-j   the port's gradient against the JAX package's;
  t-t'  the port's gradient against its own after every parameter of the
        port was multiplied by 1 ± 2^-23 (one float32 ulp, random signs);
  j-j'  the same for the JAX package.

A leaf whose t-j is of the size of t-t' or j-j' differs by no more than
either package differs from itself one ulp away: the gap is the
conditioning of the float32 formulation, not a difference between the
packages. `--targets uniform` uses the unscaled uniform-noise images and
feature targets, under which the per-pixel loss residuals cancel and the
first layers of netTexture and netDINO move by up to 1e-2.
"""
from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_train as T  # noqa: E402
from animals3d_tpu_torch.convert_jax import export_jax_grads  # noqa: E402
from torch_parity import flat_tree, numpy_tree  # noqa: E402

ULP = np.float32(2.0 ** -23)


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def port_grads(pair, noise):
    pair.tm.zero_grad(set_to_none=True)
    loss, (_met, aux) = pair.tm.forward(pair.tbatch, T.IT, None, pair.tphase,
                                        noise=noise)
    loss.backward()
    grads = flat_tree(export_jax_grads(pair.tm))
    pair.tm.zero_grad(set_to_none=True)
    return grads, aux


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--targets", choices=("dark", "uniform"), default="dark")
    args = ap.parse_args()
    if args.targets == "uniform":
        T.DARK = 1.0
    pair = T.Pair()
    for seed in range(args.key, args.key + T.MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        (_l, (_m, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
        noise = pair.noise(rng)
        tgrads, taux = port_grads(pair, noise)
        if T.agree(jaux, taux):
            break
    else:
        print("no key on which the packages agree", file=sys.stderr)
        return 1
    want = flat_tree(numpy_tree(jgrads))

    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in pair.tm.named_parameters():
            if ".ViT." not in name:
                up = torch.rand(p.shape, generator=gen) > 0.5
                p.mul_(1 + (up.float() * 2 - 1) * float(ULP))
    tgrads_n, taux_n = port_grads(pair, noise)
    pair.reset()

    r = np.random.default_rng(1)
    nudged = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) * (
            1 + (r.integers(0, 2, x.shape) * 2 - 1) * ULP).astype(np.float32)),
        pair.jp)
    (_l, (_m, jaux_n)), jgrads_n = pair.value_and_grad(nudged, rng)
    want_n = flat_tree(numpy_tree(jgrads_n))

    print(f"key {seed}, {args.targets} targets, {torch.get_num_threads()} "
          f"torch threads; the nudged port still agrees with JAX: "
          f"{T.agree(jaux, taux_n)}, the nudged JAX with the port: "
          f"{T.agree(jaux_n, taux)}")
    print("leaf".ljust(74), "     t-j", "    t-t'", "    j-j'")
    for path, leaf in want.items():
        if path not in tgrads or "ViT" in path:
            continue
        print(f"{'/'.join(path):74s} {rel(tgrads[path], leaf):8.1e} "
              f"{rel(tgrads_n[path], tgrads[path]):8.1e} "
              f"{rel(want_n[path], leaf):8.1e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
