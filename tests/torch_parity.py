"""Shared helpers of the port's parity tests (`tests/test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; the
JAX package runs on the CPU, the port with `device="cpu"` in float32.
"""
from __future__ import annotations

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


def build_pair(overrides=TINY_OVERRIDES):
    """(JAX model, its init params, port model carrying the same weights)."""
    cfg = jcfg.load_config("train_magicpony_horse", overrides=overrides)
    cfg["model"]["dataset"] = cfg["dataset"]
    jm = jbuild(cfg["model"])
    for it in (0, 50000):       # cache the grids outside the traced init
        jm.grid_for_phase(jm.phase_for_iter(it))
    jp = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    tcfg_ = tcfg.load_config("train_magicpony_horse", overrides=overrides)
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
