"""Where a key of the parity tests' key search spends its time, on the CPU.

    python3 tests/torch_search_profile.py [--procs 6] [--keys 4] [--passive]

Starts `--procs` processes at once (tier-1 runs six pytest workers), each
on one iteration of `tests/test_torch_phases.py` (0, 3,000, 8,000, 50,000,
70,000, 95,000, then again), and times, for each of its first `--keys`
keys: the JAX `value_and_grad` (what `search_here` runs), the JAX forward
alone, `Pair.noise` (the port's prior for the surface draws), the port's
forward with and without gradients, `forward_agrees` and
`same_blend_branches`. `--passive` starts the processes with
`OMP_WAIT_POLICY=PASSIVE`, as `tests/torch_search.py` starts its child.
Each process prints one line a key; the first key carries the compiles.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
ITERS = (0, 3000, 8000, 50000, 70000, 95000)


def one(it: int, keys: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    from test_torch_phases import OVERRIDES
    from test_torch_train import Pair, forward_agrees, same_blend_branches
    pair = Pair(it, OVERRIDES)
    grid = pair.jm.grid_for_phase(pair.phase)[0]
    fwd = jax.jit(lambda p, rng: pair.jm.forward(p, pair.jbatch, it, rng,
                                                 pair.phase, grid))
    for seed in range(keys):
        rng = jax.random.PRNGKey(seed)
        t = {}

        def timed(name, fn):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn())
            t[name] = time.perf_counter() - t0
            return out
        (_l, (_m, jaux)), _g = timed(
            "jax_value_and_grad", lambda: pair.value_and_grad(pair.jp, rng))
        timed("jax_forward", lambda: fwd(pair.jp, rng))
        noise = timed("noise", lambda: pair.noise(rng))
        _tl, (_tm, taux) = timed("port_forward", lambda: pair.tm.forward(
            pair.tbatch, it, None, pair.tphase, noise=noise))
        with torch.no_grad():
            timed("port_forward_no_grad", lambda: pair.tm.forward(
                pair.tbatch, it, None, pair.tphase, noise=noise))
        timed("forward_agrees", lambda: forward_agrees(jaux, taux))
        timed("same_blend_branches", lambda: same_blend_branches(jaux, taux))
        print(f"iteration {it} key {seed}: " + ", ".join(
            f"{k} {v:.2f} s" for k, v in t.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--keys", type=int, default=4)
    ap.add_argument("--passive", action="store_true")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        one(args.one, args.keys)
        return 0
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
    if args.passive:
        env["OMP_WAIT_POLICY"] = "PASSIVE"
    print(f"{args.procs} processes, {args.keys} keys each, OMP_WAIT_POLICY "
          f"{env.get('OMP_WAIT_POLICY', 'unset')}", flush=True)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--one",
         str(ITERS[i % len(ITERS)]), "--keys", str(args.keys)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True) for i in range(args.procs)]
    rc = 0
    for p in procs:
        out, _ = p.communicate()
        sys.stdout.write(out)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
