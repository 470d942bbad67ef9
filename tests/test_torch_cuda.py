"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips."""
import numpy as np
import pytest
import torch

from animals3d_tpu_torch.ops import dmtet
from animals3d_tpu_torch.ops import rasterize_cuda as rc

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random(rng):
    B, Fn = 3, 2000
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = (ctr + rng.uniform(-0.1, 0.1, (B, Fn, 3, 3))).reshape(B, 3 * Fn, 3)
    w = rng.uniform(2, 4, (B, 3 * Fn, 1))
    v_clip = np.concatenate([v * w, w], -1).astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3)
    return (v_clip, rng.normal(size=(3 * Fn, 3)).astype(np.float32), faces,
            rng.uniform(size=Fn) > 0.05, (64, 96), 128)


def _depth_stack(rng):
    quads, faces = [], []
    depths = [1.0, 1.0] + [1.0 + 0.2 * i for i in range(1, 8)]
    for qi, z in enumerate(depths):
        i0 = 4 * qi
        s = 1.0 if qi != 3 else 0.3
        quads += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        faces += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    v = np.asarray(quads, np.float32)
    v_clip = np.concatenate([v * 2.0, np.full((len(v), 1), 2.0)], -1)[None]
    return (v_clip.astype(np.float32), v, np.asarray(faces),
            np.ones(len(faces), bool), (32, 32), 2)


def _sphere(rng):
    """Capacity-padded lattice marching-tets sphere."""
    res = 16
    n = res + 1
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    pos = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    sdf = (0.3 - np.linalg.norm(pos, axis=-1)).astype(np.float32)
    out = dmtet.marching_tets_lattice(torch.from_numpy(pos),
                                      torch.from_numpy(sdf), res, 4096, 8192)
    verts = out.verts.numpy()
    v_clip = np.concatenate([verts * 2.0, np.full((len(verts), 1), 2.0)], -1)
    return (v_clip[None].astype(np.float32), verts, out.faces.numpy(),
            out.f_valid.numpy(), (64, 64), 256)


@pytest.mark.parametrize("make", [_random, _depth_stack, _sphere])
def test_visibility_kernel_equals_plain_version(card, make):
    """face_id, z and the chunk flags identical bit for bit; one launch
    counted per call."""
    v_clip, v_pos0, faces, f_valid, res, chunk = make(
        np.random.default_rng(3))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=card)
    prep = rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                      t(f_valid, torch.bool), res, chunk)
    args = (prep["table"], prep["orig"], prep["order"], prep["counts"],
            prep["masks"], prep["zlo"], res, prep["nsub"])
    launches = rc.visibility.launches
    got = rc.visibility(*args)
    torch.cuda.synchronize()
    assert rc.visibility.launches == launches + 1
    want = rc.visibility_reference(*args)
    assert int((want[1] > 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_visibility_kernel_rejects_bad_inputs(card):
    v_clip, v_pos0, faces, f_valid, res, chunk = _random(
        np.random.default_rng(4))
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=card)
    prep = rc.prepare(t(v_clip), t(v_pos0), t(faces, torch.int64),
                      t(f_valid, torch.bool), res, chunk)
    with pytest.raises(ValueError):
        rc.visibility(prep["table"].cpu(), prep["orig"], prep["order"],
                      prep["counts"], prep["masks"], prep["zlo"], res,
                      prep["nsub"])
    with pytest.raises(ValueError):
        rc.visibility(prep["table"][:, :, :, ::2].contiguous(), prep["orig"],
                      prep["order"], prep["counts"], prep["masks"],
                      prep["zlo"], res, prep["nsub"])
