"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU, the port with `device="cpu"` in float32.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from animals3d_tpu import config as jcfg
from animals3d_tpu.models import build_model as jbuild
from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch.convert_jax import load_jax_params
from animals3d_tpu_torch.models import build_model as tbuild
from test_animal_model import TINY_OVERRIDES


def numpy_tree(params):
    """A flax parameter tree as nested dicts of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, params)


def build_pair(overrides=TINY_OVERRIDES, config="train_magicpony_horse",
               iters=(0, 50000)):
    """(JAX model, its init params, port model carrying the same weights)
    of `config` with `overrides`; the grids of `iters`' phases are loaded
    outside the traced init."""
    cfg = jcfg.load_config(config, overrides=overrides)
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    for it in iters:
        jm.grid_for_phase(jm.phase_for_iter(it))
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tcfg_ = tcfg.load_config(config, overrides=overrides)
    tcfg_["model"]["dataset"] = tcfg_["dataset"]
    tm = tbuild(tcfg_["model"], device="cpu")
    load_jax_params(tm, numpy_tree(jp))
    return jm, jp, tm


def to_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _f64_face_at(v_clip, faces, b, fid, ys, xs, H, W):
    """Smallest barycentric and NDC depth of face `fid` (1-based) at pixel
    centres (ys, xs) of image b, in float64."""
    vc = v_clip[b, faces[fid - 1]].astype(np.float64)        # (n, 3, 4)
    sx = (vc[..., 0] / vc[..., 3] + 1) * 0.5 * W
    sy = (vc[..., 1] / vc[..., 3] + 1) * 0.5 * H
    sz = vc[..., 2] / vc[..., 3]
    px, py = xs + 0.5, ys + 0.5
    (x0, x1, x2), (y0, y1, y2) = sx.T, sy.T
    det = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    l1 = ((px - x0) * (y2 - y0) - (x2 - x0) * (py - y0)) / det
    l2 = ((x1 - x0) * (py - y0) - (px - x0) * (y1 - y0)) / det
    l0 = 1 - l1 - l2
    return (np.minimum(np.minimum(l0, l1), l2),
            l0 * sz[:, 0] + l1 * sz[:, 1] + l2 * sz[:, 2])


def assert_same_visibility(fid, fid_want, z, z_want, v_clip, faces,
                           z_atol=1e-4, max_share=0.008):
    """face_id equal on every pixel whose winner is decided above float32
    rounding, z within `z_atol`, at most `max_share` of the pixels flipped.

    Both packages compute the same float32 formulas, but XLA's CPU compiler
    fuses some of them into FMAs, so their roundings differ. The depth of
    a face is the plane equation of the Pallas kernel, which loses digits
    to cancellation: up to 6.3e-5 on the synthetic scenes of
    `test_torch_raster.py`, hence the default `z_atol` — the JAX package's
    own tolerance between its two rasterizers
    (`tests/test_rasterize_pallas.py:26`). The default `max_share` is set
    by the capacity-padded sphere scene, where 22 of 4,096 pixels (0.54%)
    lie on edges shared by two faces. A pixel whose face differs must be a
    tie at that precision, checked in float64: both faces cover it
    (smallest barycentric ≥ -1e-4, the 1e-4·|det| edge bias) at depths
    within `z_atol`."""
    fid, fid_want = np.asarray(fid), np.asarray(fid_want)
    z, z_want = np.asarray(z), np.asarray(z_want)
    np.testing.assert_array_equal(fid > 0, fid_want > 0)
    np.testing.assert_allclose(z, z_want, atol=z_atol, rtol=0)
    flips = np.argwhere(fid != fid_want)
    assert len(flips) <= max_share * fid.size, \
        f"{len(flips)} of {fid.size} pixels differ"
    H, W = fid.shape[1:]
    for b in np.unique(flips[:, 0]):
        ys, xs = flips[flips[:, 0] == b, 1:].T
        m_a, z_a = _f64_face_at(v_clip, faces, b, fid[b, ys, xs], ys, xs,
                                H, W)
        m_b, z_b = _f64_face_at(v_clip, faces, b, fid_want[b, ys, xs], ys,
                                xs, H, W)
        assert (m_a >= -1.1e-4).all() and (m_b >= -1.1e-4).all()
        np.testing.assert_allclose(z_a, z_b, atol=z_atol, rtol=0)


def _grow(m):
    """m or any of its 4-neighbours, over (B, H, W)."""
    out = m.copy()
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    out[:, :, 1:] |= m[:, :, :-1]
    out[:, :, :-1] |= m[:, :, 1:]
    return out


def _silhouette_pairs(fid, z, z_gap=1e-3):
    """Pixels of the pairs the antialias pass may blend: 4-neighbours with
    different faces, one of them background or their depths `z_gap`
    apart (the pass blends at gaps above 2e-3)."""
    out = np.zeros(fid.shape, bool)
    for ax in (1, 2):
        a = [slice(None)] * 3
        b = [slice(None)] * 3
        a[ax], b[ax] = slice(None, -1), slice(1, None)
        fa, fb, za, zb = fid[tuple(a)], fid[tuple(b)], z[tuple(a)], z[tuple(b)]
        pair = (fa != fb) & ((fa == 0) | (fb == 0) | (np.abs(za - zb) > z_gap))
        out[tuple(a)] |= pair
        out[tuple(b)] |= pair
    return out


def assert_images_close(got, want, rast, rast_want, v_clip, faces,
                        atol=1e-4, silhouette_atol=1e-3, z_atol=1e-3,
                        max_share=0.001):
    """(B, C, H, W) images equal within `atol`, except:

    * pixels whose face differs between the two packages and their
      4-neighbours — the antialias pass blends across neighbours. Those
      faces must first pass `assert_same_visibility` on `v_clip` (float64
      tie check, depths within `z_atol`), and at most `max_share` of the
      pixels may flip: 3 of 8,192 (0.037%) are seen on the 64² scenes of
      `test_torch_render.py`, which set the defaults with z gaps up to
      9.1e-4;
    * the pixels of silhouette pairs, within `silhouette_atol`: their
      antialias weight is a ratio of float32 edge functions of the form
      a·x + b·y + c, whose constant c ≈ x·y cancels digits of the weight.
    """
    got, want = to_np(got), to_np(want)
    fid, fid_want = to_np(rast.face_id), to_np(rast_want.face_id)
    assert_same_visibility(fid, fid_want, to_np(rast.z), to_np(rast_want.z),
                           to_np(v_clip), to_np(faces), z_atol=z_atol,
                           max_share=max_share)
    near = _grow(fid != fid_want)
    sil = _silhouette_pairs(fid, to_np(rast.z)) \
        | _silhouette_pairs(fid_want, to_np(rast_want.z))
    for mask, tol in ((~near & ~sil, atol), (~near & sil, silhouette_atol)):
        keep = np.broadcast_to(mask[:, None], got.shape)
        np.testing.assert_allclose(got[keep], want[keep], atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# training-forward helpers
# ---------------------------------------------------------------------------

# TINY_OVERRIDES with the netSDF at the width the fused sweep covers, so
# both packages train through their fused path (Pallas in interpret mode on
# the JAX side, the plain version of the CUDA kernels on the port's)
TRAIN_OVERRIDES = [o for o in TINY_OVERRIDES
                   if "cfg_shape.hidden_size" not in o] + \
    ["model.cfg_predictor_base.cfg_shape.hidden_size=256"]


def fake_batch_np(seed, B=2, F=1, H=64, dino_dim=4):
    """The batch of `tests/test_animal_model.py`, as numpy arrays."""
    r = np.random.default_rng(seed)
    mask = np.zeros((B, F, 1, H, H), np.float32)
    mask[:, :, :, 16:48, 20:44] = 1.0
    return {
        "images": r.uniform(0, 1, (B, F, 3, H, H)).astype(np.float32),
        "masks": mask,
        "mask_dt": r.uniform(0, 5, (B, F, 2, H, H)).astype(np.float32),
        "mask_valid": np.ones((B, F, H, H), np.float32),
        "flows": None, "bboxs": np.zeros((B, F, 8), np.float32),
        "bg_images": None,
        "dino_features": r.uniform(0, 1, (B, F, dino_dim, 16, 16))
        .astype(np.float32),
        "dino_clusters": None, "seq_idx": np.zeros((B,), np.int32),
        "frame_idx": np.zeros((B, F), np.int32),
    }


def batch_to(batch, conv):
    return {k: None if v is None else conv(v) for k, v in batch.items()}


def jax_noise(rng, n_images, num_hypos, num_verts=None, vae=None,
              generate=None):
    """The draws `AnimalModel.forward` makes from `rng`, reproduced by
    splitting the key as the JAX code does (`models/animal.py:415` →
    `predictors/instance.py:534,293-297`; `predictors/base.py:170,227-237`;
    Fauna's random view `models/fauna.py:178` from `rngs[3]`), as a port
    `Noise`. `surf_idx` needs the prior mesh's vertex count. Ponymation's:
    with `vae` = (flax instance predictor, its params, ε's shape), the
    VAE's ε, a normal draw from the key `make_rng("vae")` gives in the
    predictor's root scope on the stream `rngs[4]`
    (`predictors/motion_vae.py:96`, `models/animal.py:551`); with
    `generate` = (images in the batch, z's shape), `generate`'s frame pick
    and unscaled z from `rngs[1]` split in three (`predictors/
    motion_vae.py:124-125`)."""
    from animals3d_tpu_torch.noise import Noise
    rngs = jax.random.split(rng, 5)
    t = lambda a: torch.from_numpy(np.array(a))
    draws = _jax_draws(rng, n_images, num_hypos,
                       None if num_verts is None
                       else np.int32(max(int(num_verts), 1)))
    extra = {}
    if vae is not None:
        inst, params, shape = vae
        key = inst.apply({"params": params},
                         method=lambda m: m.make_rng("vae"),
                         rngs={"vae": rngs[4]})
        extra["vae_normal"] = t(jax.random.normal(key, shape))
    if generate is not None:
        n_in, z_shape = generate
        k_pick, k_vae, _k_pose = jax.random.split(rngs[1], 3)
        extra["gen_pick"] = t(jax.random.randint(k_pick, (), 0, n_in))
        extra["gen_z_normal"] = t(jax.random.normal(k_vae, z_shape))
    return Noise(**{k: None if v is None else t(v)
                    for k, v in draws.items()}, **extra)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_draws(rng, n_images, num_hypos, num_verts):
    """`jax_noise`'s draws of the MagicPony and Fauna sites in one jitted
    call (the same numbers as drawn one by one: `jax.random` is integer
    arithmetic on the key)."""
    rngs = jax.random.split(rng, 5)
    rng_pose, _ = jax.random.split(rngs[1])
    k1, k2 = jax.random.split(rng_pose)
    e1, e2, e3 = jax.random.split(rngs[2], 3)
    n = 5000
    return dict(
        jitter_u=jax.random.uniform(rngs[0], ()),
        rand_idx=jax.random.randint(k1, (n_images,), 0, num_hypos),
        best_u=jax.random.uniform(k2, (n_images,)),
        rand_pts_u=jax.random.uniform(e1, (n, 3)),
        surf_idx=None if num_verts is None else jax.random.randint(
            e2, (n,), 0, num_verts),
        surf_u=jax.random.uniform(e3, (n, 3)),
        rv_deg=jax.random.randint(rngs[3], (n_images,), 0, 360))


def flat_tree(tree, prefix=()):
    """{path tuple: numpy leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out

