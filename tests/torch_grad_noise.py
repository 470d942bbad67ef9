#!/usr/bin/env python3
"""How much of the gap between the port's and the JAX package's training
gradients is float32 rounding: a second witness for the tolerances of
`tests/test_torch_train.py`.

    python3 tests/torch_grad_noise.py [--key K] [--targets dark|uniform]
        [--threads N] [--nudges N] [--leaf PATH]

On the CPU, in float32, with the models, batch and noise of
`test_torch_train.py`: takes the first random key from K on which the two
packages' discrete decisions agree, and prints for every trained leaf of
the gradient tree, each as |Δ| over the leaf's norm,

  t-j   the port's gradient against the JAX package's;
  t-t'  the port's gradient against its own after every parameter of the
        port was multiplied by 1 ± 2^-23 (one float32 ulp, random signs);
  j-j'  the same for the JAX package.

With `--nudges N` each package is nudged N times (other random signs), and
t-t' and j-j' are the largest movement over the nudges that leave the
packages' discrete decisions (feet, faces, blend branches) the same.

A leaf whose t-j is of the size of t-t' or j-j' differs by no more than
either package differs from itself one ulp away: the gap is the
conditioning of the float32 formulation, not a difference between the
packages. `--targets uniform` uses the unscaled uniform-noise images and
feature targets, under which the per-pixel loss residuals cancel and the
first layers of netTexture and netDINO move by up to 1e-2. `--threads N`
sets torch's CPU thread count (which keys agree depends on it); `--leaf
PATH` (a '/'-joined leaf path) also prints, for that leaf, each package's
gap as a multiple of the leaf's tolerance in `test_torch_train.py`.
"""
from __future__ import annotations

import argparse
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_train as T  # noqa: E402


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--targets", choices=("dark", "uniform"), default="dark")
    ap.add_argument("--threads", type=int, default=0)
    ap.add_argument("--nudges", type=int, default=1)
    ap.add_argument("--leaf", default="")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    if args.targets == "uniform":
        T.DARK = 1.0
    pair = T.Pair()
    for seed in range(args.key, args.key + T.MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        want, jaux = pair.jax_grads_aux(rng)
        tgrads, taux = pair.port_grads_aux(rng)
        if T.agree(jaux, taux):
            break
    else:
        print("no key on which the packages agree", file=sys.stderr)
        return 1

    # per leaf, the largest movement over the nudges after which the
    # nudged package still agrees with the other one (a nudge that flips
    # a foot or a face measures another branch, not rounding)
    moved_t, moved_j = {}, {}
    kept_t, kept_j = [], []
    for n in range(args.nudges):
        tg, ta = pair.port_grads_aux(rng, 1 + n)
        if T.agree(jaux, ta):
            kept_t.append(1 + n)
            for path, leaf in tg.items():
                moved_t[path] = max(moved_t.get(path, 0.0),
                                    rel(leaf, tgrads[path]))
        jg, ja = pair.jax_grads_aux(rng, 1 + n)
        if T.agree(ja, taux):
            kept_j.append(1 + n)
            for path, leaf in jg.items():
                moved_j[path] = max(moved_j.get(path, 0.0),
                                    rel(leaf, want[path]))

    print(f"key {seed}, {args.targets} targets, {torch.get_num_threads()} "
          f"torch threads; of {args.nudges} nudges (seeds 1 to "
          f"{args.nudges}), the port's {kept_t} and JAX's {kept_j} keep the "
          "packages' decisions the same (the columns t-t' and j-j' are the "
          "largest movement over those)")
    print("leaf".ljust(74), "     t-j", "    t-t'", "    j-j'")
    nan = float("nan")
    for path, leaf in want.items():
        if path not in tgrads or "ViT" in path:
            continue
        print(f"{'/'.join(path):74s} {rel(tgrads[path], leaf):8.1e} "
              f"{moved_t.get(path, nan):8.1e} {moved_j.get(path, nan):8.1e}")
    path = tuple(args.leaf.split("/")) if args.leaf else None
    if path in want:
        tol = T.leaf_tolerance(path)
        print(f"{args.leaf}: tolerance {tol:g}; t-j "
              f"{rel(tgrads[path], want[path]) / tol:.2f}, t-t' "
              f"{moved_t.get(path, nan) / tol:.2f}, j-j' "
              f"{moved_j.get(path, nan) / tol:.2f} tolerances")
    return 0


if __name__ == "__main__":
    sys.exit(main())
