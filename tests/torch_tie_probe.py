#!/usr/bin/env python3
"""Where a gap between the port's and the JAX package's training
gradients comes from, on one random key: a diagnostic beside
`tests/torch_grad_noise.py` for the keys that `tests/test_torch_train.py`
skips.

    python3 tests/torch_tie_probe.py --key K
    python3 tests/torch_tie_probe.py --key K --scan N

On the CPU, in float32, with the models, batch and noise of
`test_torch_train.py`, for the first key from K whose forward agrees
(`forward_agrees`), it prints:

  1. which selection checks the key passes (`same_blend_branches`,
     `Pair.relu_tie`), and how far the JAX tree moves under a one-ulp
     nudge of its own parameters;
  2. per loss term, the gradient of the articulation network's output
     bias in both packages and the gap between them (the JAX side by
     `jax.jacrev` over the metrics);
  3. the mask loss's gradient with respect to the clip-space vertices
     through the antialias pass alone, from the JAX package's
     rasterization and posed vertices, against the same computed with the
     port's antialias, with the port's rasterization, and with the port's
     posed vertices: which input carries the gap;
  4. the silhouette pairs at which the two packages' posed vertices put
     the antialias blend on different branches (`blend_ties`);
  5. whether the rgb loss's pixel set and residual signs agree, the
     texture field's ReLU decisions that differ between the packages at a
     pixel of the rgb loss (`Pair.relu_switches`), and how far the port's
     tree is from JAX's when it takes JAX's decisions there.

With `--scan N` it prints instead, for every key among K ... K+N-1 whose
forward agrees: whether the blend branches agree, whether the texture
ReLU decisions that differ matter (`Pair.relu_tie`), how far the JAX tree
moves under a one-ulp nudge of its parameters and how far the port's tree
is from it, each as the worst leaf's multiple of its tolerance.

`--threads N` sets torch's CPU thread count (the port's float32 sums, and
so which keys agree, depend on it).
"""
from __future__ import annotations

import argparse
import os
import sys

# JAX on the CPU as `tests/conftest.py` sets it up for the tests
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import test_torch_train as T  # noqa: E402
from animals3d_tpu.ops import rasterize as jrz  # noqa: E402
from animals3d_tpu.ops.antialias import antialias as jantialias  # noqa: E402
from animals3d_tpu_torch.convert_jax import export_jax_grads  # noqa: E402
from animals3d_tpu_torch.ops.antialias import antialias  # noqa: E402
from animals3d_tpu_torch.ops.rasterize import Rast  # noqa: E402
from torch_parity import flat_tree, numpy_tree  # noqa: E402

LEAF = ("netInstance", "netArticulation", "out_linear", "bias")


def term_gaps(pair, rng, taux_loss_terms):
    names = sorted(k for k, v in taux_loss_terms.items()
                   if isinstance(v, torch.Tensor) and v.requires_grad)
    grid, _, _ = pair.jm.grid_for_phase(pair.phase)

    def terms(p):
        _l, (m, _a) = pair.jm.forward(p, pair.jbatch, T.IT, rng, pair.phase,
                                      grid)
        return jnp.stack([jnp.asarray(m[n], jnp.float32).reshape(())
                          for n in names])
    jac = jax.jit(jax.jacrev(terms))(pair.jp)
    for i, n in enumerate(names):
        pair.tm.zero_grad(set_to_none=True)
        taux_loss_terms[n].backward(retain_graph=True)
        got = flat_tree(export_jax_grads(pair.tm)).get(LEAF)
        want = flat_tree(numpy_tree(jax.tree_util.tree_map(
            lambda x: x[i], jac)))[LEAF]
        if got is None:
            continue
        print(f"  {n:24s} port {np.linalg.norm(got):.4g} jax "
              f"{np.linalg.norm(want):.4g} gap "
              f"{np.linalg.norm(got - want):.3g}")
    pair.tm.zero_grad(set_to_none=True)


def antialias_swap(pair, jaux, taux):
    H, W = taux["mask_pred"].shape[-2:]
    faces = np.asarray(jaux["shape"].t_pos_idx)
    gt = pair.batch["masks"][:, 0, 0]
    jv = np.asarray(T.posed_clip(jaux))
    tv = T.posed_clip(taux).numpy()
    jr = jrz.rasterize(jnp.asarray(jv), jnp.asarray(faces),
                       jnp.asarray(jaux["shape"].f_valid), (H, W))
    shape = taux["shape"]
    tr = T.rasterize_cuda(torch.from_numpy(tv), shape.t_pos_idx,
                          shape.f_valid, (H, W),
                          v_pos0=shape.v_pos[0].detach())
    rasts = {"jax": (np.asarray(jr.face_id), np.asarray(jr.z)),
             "port": (tr.face_id.numpy(), tr.z.numpy())}

    def port(r, v):
        fid, z = (torch.from_numpy(np.array(a)) for a in rasts[r])
        v = torch.tensor(v, requires_grad=True)
        a = antialias((fid > 0).float()[..., None],
                      Rast(uv=None, z=z, face_id=fid), v,
                      torch.from_numpy(faces).long())[..., 0]
        ((a - torch.from_numpy(gt)) ** 2).mean().backward()
        return v.grad.numpy()

    def jaxg(r, v):
        fid, z = (jnp.asarray(a) for a in rasts[r])

        def f(v):
            a = jantialias((fid > 0).astype(jnp.float32)[..., None],
                           jrz.Rast(uv=None, z=z, face_id=fid), v,
                           jnp.asarray(faces))[..., 0]
            return ((a - gt) ** 2).mean()
        return np.asarray(jax.grad(f)(jnp.asarray(v)))
    ref = jaxg("jax", jv)
    n = np.linalg.norm(ref)
    for name, g in (("port antialias", port("jax", jv)),
                    ("port rasterization", jaxg("port", jv)),
                    ("port posed vertices", jaxg("jax", tv))):
        print(f"  {name:22s} |g - g_jax| / |g_jax| "
              f"{np.linalg.norm(g - ref) / n:.3g}")


def rgb_decisions(pair, jaux, taux):
    gt = pair.batch["masks"][:, :, 0]
    valid = pair.batch["mask_valid"]

    def region(m):
        both = ((m * valid) > 0).astype(np.float32) * gt
        p = np.pad(both, ((0, 0), (0, 0), (1, 1), (1, 1)))
        H, W = both.shape[-2:]
        avg = sum(p[:, :, i:i + H, j:j + W] for i in range(3)
                  for j in range(3)) / 9
        return avg > 0.99
    rj = region(np.asarray(jaux["mask_pred"]))
    rt = region(taux["mask_pred"].detach().numpy())
    sj = np.sign(np.asarray(jaux["image_pred"]) - pair.batch["images"])
    st = np.sign(taux["image_pred"].detach().numpy() - pair.batch["images"])
    print(f"  rgb-loss pixels differ at {int((rj != rt).sum())}; residual "
          f"signs differ at {int(((sj != st) & rt[:, :, None]).sum())}")
    return rt


def relu_report(pair, rng, taux, jgrads):
    switches = pair.relu_switches(rng, taux)
    for name, (sw, _j) in switches.items():
        print(f"  {name:36s} ReLU decisions that differ at rgb pixels: "
              f"{int(sw.sum())}")
    if switches:
        want = flat_tree(numpy_tree(jgrads))
        with pair.jax_relu_decisions(switches):
            gap = worst(T.gradient_gaps(pair.port_grads(rng), want))
        print(f"  with JAX's decisions taken there, the port's tree is "
              f"{gap[0]:.2f} tolerances from JAX's ({gap[1]})")


def worst(gaps):
    """The leaf farthest outside its tolerance: (multiple, path)."""
    return max((g / T.leaf_tolerance(p), "/".join(p))
               for p, g in gaps.items())


def self_movement(pair, rng, jgrads):
    """How far the JAX tree moves when every JAX parameter is multiplied by
    1 ± 2^-23 (one float32 ulp, fixed signs): (multiple, path) of the
    leaf farthest outside its tolerance."""
    r = np.random.default_rng(1)
    nudged = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) * (1 + (r.integers(
            0, 2, x.shape) * 2 - 1) * np.float32(2.0 ** -23))
            .astype(np.float32)), pair.jp)
    _l, moved = pair.value_and_grad(nudged, rng)
    moved = flat_tree(numpy_tree(moved))
    return worst({p: np.linalg.norm(moved[p] - w) / np.linalg.norm(w)
                  for p, w in flat_tree(numpy_tree(jgrads)).items()
                  if "ViT" not in p and np.linalg.norm(w) > 0})


def scan(pair, first, n):
    for seed in range(first, first + n):
        rng = jax.random.PRNGKey(seed)
        (_l, (_m, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
        pair.reset()
        loss, (_tm, taux) = pair.tm.forward(
            pair.tbatch, T.IT, None, pair.tphase, noise=pair.noise(rng))
        if not T.forward_agrees(jaux, taux):
            continue
        want = flat_tree(numpy_tree(jgrads))
        self_move = self_movement(pair, rng, jgrads)
        loss.backward()
        gap = worst(T.gradient_gaps(flat_tree(export_jax_grads(pair.tm)),
                                    want))
        pair.reset()
        print(f"key {seed}: blend branches agree "
              f"{T.same_blend_branches(jaux, taux)}; texture ReLU tie "
              f"{pair.relu_tie(rng, taux)}; JAX self-movement "
              f"{self_move[0]:.2f} tolerances ({self_move[1]}); gap "
              f"{gap[0]:.2f} tolerances ({gap[1]})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", type=int, default=0)
    ap.add_argument("--scan", type=int, default=0)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    pair = T.Pair()
    print(f"{torch.get_num_threads()} torch threads")
    if args.scan:
        scan(pair, args.key, args.scan)
        return 0
    for seed in range(args.key, args.key + T.MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        (_l, (_m, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
        pair.reset()
        _t, (tmet, taux) = pair.tm.forward(pair.tbatch, T.IT, None,
                                           pair.tphase, noise=pair.noise(rng))
        if T.forward_agrees(jaux, taux):
            break
    else:
        print("no key whose forward agrees", file=sys.stderr)
        return 1
    print(f"key {seed}, {torch.get_num_threads()} torch threads: "
          f"same_blend_branches {T.same_blend_branches(jaux, taux)}, "
          f"relu_tie {pair.relu_tie(rng, taux)}; JAX self-movement "
          f"{self_movement(pair, rng, jgrads)[0]:.2f} tolerances")
    print("1. per loss term, the gradient of " + "/".join(LEAF) + ":")
    term_gaps(pair, rng, tmet)
    print("2. mask-loss gradient w.r.t. the clip vertices through the "
          "antialias pass, against JAX's own:")
    antialias_swap(pair, jaux, taux)
    _r, _tv, _jv, ties = T.blend_ties(jaux, taux)
    print(f"3. silhouette pairs on different blend branches: "
          f"{ties.tolist()}")
    print("4. rgb loss:")
    rgb_decisions(pair, jaux, taux)
    relu_report(pair, rng, taux, jgrads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
