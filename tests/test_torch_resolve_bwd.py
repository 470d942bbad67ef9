"""The port's resolve backward (`animals3d_tpu_torch.ops.resolve_cuda`
and `ops.rasterize._ResolveRows`) against the JAX package: the Pallas
kernel `resolve_grad_pallas` in interpret mode, on the scene of
`tests/test_rasterize_pallas.py::test_resolve_grad_pallas_matches_scatter`,
and autodiff of the JAX row gather. On the CPU the port runs the plain
version of its CUDA kernel; the kernel is held to it on the card
(`tests/test_torch_cuda.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops.rasterize_pallas import (TILE_H, TILE_W,
                                                resolve_grad_pallas)
from animals3d_tpu_torch.ops import rasterize as trz
from animals3d_tpu_torch.ops import resolve_cuda as rv
from animals3d_tpu_torch.precision import set_mixed_precision

B, H, W, R = 2, 64, 64, 10
CHUNK, NCH = 64, 2
F = 100


@pytest.fixture(scope="module")
def scene():
    """Random winners over 100 faces, 30% background (sel 0, zero
    cotangent: `resolve`'s contract), Morton-like block permutation and the
    ground-truth (tile, chunk) overlap the Pallas kernel walks."""
    set_mixed_precision(None)
    Fp = CHUNK * NCH
    n_pix = H * W
    r = np.random.default_rng(0)
    blk = 32
    perm = r.permutation(Fp // blk)
    ids_sorted = (perm[:, None] * blk + np.arange(blk)[None]) \
        .reshape(NCH, CHUNK).astype(np.int32)
    sel = r.integers(0, F, (B, n_pix)).astype(np.int32)
    g = r.normal(0, 1, (B, n_pix, R)).astype(np.float32)
    bg = r.uniform(size=(B, n_pix)) < 0.3
    sel[bg] = 0
    g[bg] = 0.0
    nty, ntx = H // TILE_H, W // TILE_W
    T = nty * ntx
    sel_t = sel.reshape(B, nty, TILE_H, ntx, TILE_W) \
        .transpose(0, 1, 3, 2, 4).reshape(B, T, TILE_H * TILE_W)
    inv = np.zeros(Fp, np.int64)
    inv[ids_sorted.reshape(-1)] = np.arange(Fp)
    overlap = np.zeros((B, T, NCH), bool)
    for b in range(B):
        for t in range(T):
            overlap[b, t, np.unique(inv[sel_t[b, t]] // CHUNK)] = True
    face_id = np.where(bg, 0, sel + 1).astype(np.int32)
    pallas = np.asarray(resolve_grad_pallas(
        jnp.asarray(g), jnp.asarray(sel), jnp.asarray(ids_sorted),
        jnp.asarray(overlap), (H, W), F, interpret=True))
    return dict(g=g, sel=sel, bg=bg, face_id=face_id, pallas=pallas)


def test_plain_resolve_bwd_matches_pallas_interpret(scene):
    """atol/rtol 1e-5, the JAX package's own tolerance between its kernel
    and a dense scatter-add (float32 sums in another order)."""
    launches = rv.resolve_bwd.launches
    got = rv.resolve_bwd(torch.from_numpy(scene["g"]),
                         torch.from_numpy(scene["face_id"]), F)
    assert rv.resolve_bwd.launches == launches     # plain version on CPU
    assert got.shape == (B, F, R) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), scene["pallas"], atol=1e-5,
                               rtol=1e-5)


def test_resolve_rows_function_matches_pallas_and_jax_autodiff(scene):
    """`_ResolveRows` forward is the gather; its backward against the
    Pallas kernel (1e-5) and against autodiff of the JAX gather
    `vmap(p[s])` (atol 1e-6)."""
    pf = np.random.default_rng(1).normal(size=(B, F, R)).astype(np.float32)
    tpf = torch.from_numpy(pf).requires_grad_(True)
    rows = trz._ResolveRows.apply(tpf, torch.from_numpy(scene["face_id"]))
    want_rows = jax.vmap(lambda p, s: p[s])(jnp.asarray(pf),
                                            jnp.asarray(scene["sel"]))
    np.testing.assert_array_equal(rows.detach().numpy(),
                                  np.asarray(want_rows))
    rows.backward(torch.from_numpy(scene["g"]))
    np.testing.assert_allclose(tpf.grad.numpy(), scene["pallas"], atol=1e-5,
                               rtol=1e-5)
    _, vjp = jax.vjp(lambda p: jax.vmap(lambda q, s: q[s])(
        p, jnp.asarray(scene["sel"])), jnp.asarray(pf))
    want, = vjp(jnp.asarray(scene["g"]))
    np.testing.assert_allclose(tpf.grad.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_background_cotangent_contributes_nothing(scene):
    """A non-zero cotangent on background pixels (face_id 0) reaches no
    face — not face 0 either, which the background's sel = 0 aliases."""
    g = scene["g"].copy()
    g[scene["bg"]] = 7.0
    got = rv.resolve_bwd(torch.from_numpy(g),
                         torch.from_numpy(scene["face_id"]), F)
    np.testing.assert_allclose(got.numpy(), scene["pallas"], atol=1e-5,
                               rtol=1e-5)
    pf = torch.zeros((B, F, R), requires_grad=True)
    trz._ResolveRows.apply(pf, torch.from_numpy(scene["face_id"])) \
        .backward(torch.from_numpy(g))
    np.testing.assert_allclose(pf.grad.numpy(), scene["pallas"], atol=1e-5,
                               rtol=1e-5)


def test_resolve_bwd_bf16_cotangent_accumulates_in_float32(scene):
    """Under the bf16 policy the cotangent is rounded to bf16 before the
    scatter and summed in float32: equal to the float32 scatter of the
    rounded values (1e-5), for the wrapper and through `_ResolveRows`."""
    g16 = torch.from_numpy(scene["g"]).to(torch.bfloat16)
    fid = torch.from_numpy(scene["face_id"])
    want = rv.resolve_bwd(g16.float(), fid, F)
    got = rv.resolve_bwd(g16, fid, F)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    set_mixed_precision("bf16")
    try:
        pf = torch.zeros((B, F, R), requires_grad=True)
        trz._ResolveRows.apply(pf, fid).backward(
            torch.from_numpy(scene["g"]))
    finally:
        set_mixed_precision(None)
    assert pf.grad.dtype == torch.float32
    np.testing.assert_allclose(pf.grad.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_resolve_bwd_rejects_bad_inputs(scene):
    g = torch.from_numpy(scene["g"])
    fid = torch.from_numpy(scene["face_id"])
    with pytest.raises(ValueError):
        rv.resolve_bwd(g, fid.long(), F)
    with pytest.raises(ValueError):
        rv.resolve_bwd(g[:, ::2], fid[:, ::2], F)
    with pytest.raises(ValueError):
        rv.resolve_bwd(g.double(), fid, F)
