"""The port's resolve-rows forward (`ops.resolve_cuda.resolve_fwd`, the
counterpart of `resolve_rows_pallas`) and the kernel path of
`ops.rasterize.resolve` (`rows="kernel"`, the counterpart of the JAX
package's `A3D_MXU_FWD=1`) against the JAX package on the CPU: the Pallas
kernel in interpret mode, and the JAX `resolve` under `A3D_FORCE_MXU=1,
A3D_MXU_FWD=1` (read at trace time). On the CPU the port runs the plain
version of its CUDA kernel; the kernel is held to it on the card
(`tests/test_torch_cuda.py`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops.rasterize import resolve as jresolve
from animals3d_tpu.ops.rasterize_pallas import (rasterize_pallas,
                                                resolve_rows_pallas)
from animals3d_tpu_torch.ops import rasterize as trz
from animals3d_tpu_torch.ops import resolve_cuda as rv
from animals3d_tpu_torch.precision import set_mixed_precision


def test_plain_resolve_fwd_matches_pallas_interpret():
    """`resolve_fwd_reference` against `resolve_rows_pallas(interpret=True)`
    on the synthetic winners of `tests/test_rasterize_pallas.py:135`, with
    a third of the pixels background: equal on foreground pixels (the
    one-hot product selects one row exactly), zero on background (where
    the JAX contract lets rows alias face 0)."""
    B, H, W, R = 2, 32, 64, 8
    chunk, nch, F = 64, 2, 90
    r = np.random.default_rng(3)
    perm = r.permutation(chunk * nch // 32)
    ids_sorted = (perm[:, None] * 32 + np.arange(32)[None]) \
        .reshape(nch, chunk).astype(np.int32)
    sel = r.integers(0, F, (B, H * W)).astype(np.int32)
    bg = r.uniform(size=(B, H * W)) < 0.3
    face_id = np.where(bg, 0, sel + 1).astype(np.int32)
    sel[bg] = 0
    pf = r.normal(0, 1, (B, F, R)).astype(np.float32)
    won = jnp.ones((B, (H // 16) * (W // 32), nch), bool)
    want = np.asarray(resolve_rows_pallas(
        jnp.asarray(pf), jnp.asarray(sel), jnp.asarray(ids_sorted), won,
        (H, W), interpret=True))
    launches = rv.resolve_fwd.launches
    got = rv.resolve_fwd(torch.from_numpy(pf), torch.from_numpy(face_id),
                         (H, W)).numpy()
    assert rv.resolve_fwd.launches == launches     # plain version on the CPU
    assert got.shape == (B, R, H * W) and got.dtype == np.float32
    fg = rv.to_tile_order(torch.from_numpy(face_id)[..., None] > 0,
                          (H, W)).numpy()[:, 0]
    fg = np.broadcast_to(fg[:, None], got.shape)
    np.testing.assert_array_equal(got[fg], want[fg])
    assert not got[~fg].any()


def _scene():
    """The scene of `tests/test_rasterize_pallas.py:184`."""
    r = np.random.default_rng(7)
    B, V, F = 2, 60, 40
    v = r.normal(0, 0.4, (B, V, 3)).astype(np.float32)
    v[..., 2] += 3.0
    w = np.ones((B, V, 1), np.float32) * v[..., 2:3]
    v_clip = np.concatenate([v[..., :2] * 2, v[..., 2:] * 0.5, w], -1)
    faces = r.integers(0, V, (F, 3)).astype(np.int32)
    attr = r.normal(0, 1, (B, V, 5)).astype(np.float32)
    fattr = r.normal(0, 1, (B, F, 3)).astype(np.float32)
    return v, v_clip, faces, attr, fattr


def _weights(shape, k):
    return (np.arange(int(np.prod(shape)), dtype=np.float32) % k) \
        .reshape(shape)


def _port_resolve(rows, v_clip, face_id, faces, attr, fattr):
    """Values and gradients (v_clip, attr, face_attr) of the port's resolve
    under the loss of the JAX test."""
    vc, a, fa = (torch.from_numpy(x).requires_grad_(True)
                 for x in (v_clip, attr, fattr))
    rast = trz.Rast(uv=None, z=torch.zeros(face_id.shape),
                    face_id=torch.from_numpy(face_id))
    uv, out, fo = trz.resolve(a, rast, vc, torch.from_numpy(faces).long(),
                              face_attr=fa, rows=rows)
    loss = (out * torch.from_numpy(_weights(out.shape, 7))).sum() \
        + (fo * torch.from_numpy(_weights(fo.shape, 5))).sum() \
        + (uv * torch.from_numpy(_weights(uv.shape, 3))).sum()
    loss.backward()
    return ([x.detach().numpy() for x in (uv, out, fo)],
            [x.grad.numpy() for x in (vc, a, fa)])


def test_kernel_rows_resolve_matches_jax_mxu_path(monkeypatch):
    """The port's `resolve(..., rows="kernel")` against the JAX `resolve`
    on its one-hot-matrix path (`A3D_FORCE_MXU=1, A3D_MXU_FWD=1`, Pallas in
    interpret mode) on the same winners: values within 1e-4 and gradients
    with respect to v_clip, attr and face_attr within 2e-3, the JAX test's
    own tolerances between its paths."""
    set_mixed_precision(None)
    v, v_clip, faces, attr, fattr = _scene()
    H = W = 32
    B, V = v.shape[:2]
    vc, f = jnp.asarray(v_clip), jnp.asarray(faces)
    tab = jnp.concatenate([jnp.asarray(v), vc], -1).transpose(1, 0, 2) \
        .reshape(V, B * 7)
    rast = rasterize_pallas(vc, f, jnp.ones((f.shape[0],), bool), (H, W),
                            chunk=32, interpret=True, fv_rows=tab[f])
    face_id = np.asarray(rast.face_id)
    assert (face_id > 0).sum() > 50
    monkeypatch.setenv("A3D_FORCE_MXU", "1")
    monkeypatch.setenv("A3D_MXU_FWD", "1")

    def f_jax(v_clip, attr, fattr):
        uv, out, fa = jresolve(attr, rast, v_clip, f, face_attr=fattr)
        return (jnp.sum(out * _weights(out.shape, 7))
                + jnp.sum(fa * _weights(fa.shape, 5))
                + jnp.sum(uv * _weights(uv.shape, 3)), (uv, out, fa))
    (_l, want), wgrads = jax.value_and_grad(f_jax, argnums=(0, 1, 2),
                                            has_aux=True)(
        vc, jnp.asarray(attr), jnp.asarray(fattr))
    got, grads = _port_resolve("kernel", v_clip, face_id, faces, attr, fattr)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4, rtol=1e-4)
    for a, b in zip(grads, wgrads):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-3, rtol=2e-3)


def test_kernel_rows_resolve_equals_gather_rows_resolve():
    """On the CPU the port's two resolve paths compute the same float32
    operations on the same values, only laid out in another order: values
    and gradients identical, bit for bit, background zero in both."""
    set_mixed_precision(None)
    _v, v_clip, faces, attr, fattr = _scene()
    r = np.random.default_rng(0)
    face_id = r.integers(0, faces.shape[0] + 1, (2, 32, 64)).astype(np.int32)
    face_id[:, :8] = 0
    got, grads = _port_resolve("kernel", v_clip, face_id, faces, attr, fattr)
    want, wgrads = _port_resolve("gather", v_clip, face_id, faces, attr,
                                 fattr)
    for a, b in zip(got + grads, want + wgrads):
        np.testing.assert_array_equal(a, b)
    assert not got[1][:, :8].any()


def test_resolve_fwd_rejects_bad_inputs():
    pf = torch.zeros((2, 10, 8))
    fid = torch.zeros((2, 32 * 32), dtype=torch.int32)
    rv.resolve_fwd(pf, fid, (32, 32))
    with pytest.raises(ValueError):
        rv.resolve_fwd(pf.double(), fid, (32, 32))
    with pytest.raises(ValueError):
        rv.resolve_fwd(pf, fid.long(), (32, 32))
    with pytest.raises(ValueError):
        rv.resolve_fwd(pf, fid, (32, 48))
    with pytest.raises(ValueError):
        trz.resolve(torch.zeros((2, 5, 3)), trz.Rast(None, torch.zeros(2, 4, 4),
                    torch.zeros((2, 4, 4), dtype=torch.int32)),
                    torch.zeros((2, 5, 4)), torch.zeros((1, 3)).long(),
                    rows="mxu")
