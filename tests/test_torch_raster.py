"""Port parity: the tile visibility kernel's plain version and the port's
reference rasterizer against the JAX package (Pallas kernel in interpret
mode, and the XLA chunk-scan reference), on CPU."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.ops.rasterize_pallas import rasterize_pallas
from animals3d_tpu_torch.ops import rasterize as trz
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from torch_parity import assert_same_visibility

def _random_scene():
    rng = np.random.default_rng(5)
    B, V, Fn = 3, 40, 30
    v = rng.uniform(-0.9, 0.9, (B, V, 3)).astype(np.float32)
    w = rng.uniform(2, 4, (B, V, 1)).astype(np.float32)
    v_clip = np.concatenate([v * w, w], -1)
    v_pos = rng.normal(size=(B, V, 3)).astype(np.float32)
    faces = rng.integers(0, V, (Fn, 3)).astype(np.int32)
    f_valid = np.ones(Fn, bool)
    f_valid[11] = False
    return v_clip, v_pos, faces, f_valid, (32, 32), 8


def _sphere_scene():
    """Capacity-padded marching-tets sphere: padding must never win."""
    from animals3d_tpu.geometry import tets as tetlib
    from animals3d_tpu.ops import dmtet
    grid = tetlib.load_tet_grid(8, data_dir="/nonexistent")
    sdf = (0.3 - np.linalg.norm(grid.verts, axis=-1)).astype(np.float32)
    out = dmtet.marching_tets(jnp.asarray(grid.verts), jnp.asarray(sdf),
                              grid, 1024, 2048)
    verts = np.asarray(out.verts)
    v_clip = np.concatenate([verts * 2.0, np.full((1024, 1), 2.0,
                                                  np.float32)], -1)[None]
    return (v_clip.astype(np.float32), verts[None], np.asarray(out.faces),
            np.asarray(out.f_valid), (64, 64), 128)


def _depth_stack_scene():
    """8 full-screen quads stacked in z plus an exact-z duplicate of the
    front quad: every behind chunk is skippable and the tie must go to the
    smallest original id (`tests/test_rasterize_pallas.py:250`)."""
    quads, faces = [], []
    depths = [1.0, 1.0] + [1.0 + 0.2 * i for i in range(1, 8)]
    for qi, z in enumerate(depths):
        i0 = 4 * qi
        s = 1.0 if qi != 3 else 0.3
        quads += [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]]
        faces += [[i0, i0 + 1, i0 + 2], [i0, i0 + 2, i0 + 3]]
    v = np.asarray(quads, np.float32)[None]
    w = np.full((1, v.shape[1], 1), 2.0, np.float32)
    v_clip = np.concatenate([v * w, w], -1)
    faces = np.asarray(faces, np.int32)
    return v_clip, v, faces, np.ones(len(faces), bool), (32, 32), 2


SCENES = {"random": _random_scene, "sphere": _sphere_scene,
          "depth_stack": _depth_stack_scene}


def _jax_pallas(v_clip, v_pos, faces, f_valid, res, chunk):
    B, V = v_clip.shape[:2]
    vc = jnp.asarray(v_clip)
    tab = jnp.concatenate([jnp.asarray(v_pos), vc], -1) \
        .transpose(1, 0, 2).reshape(V, B * 7)
    f = jnp.asarray(faces)
    return rasterize_pallas(vc, f, jnp.asarray(f_valid), res, chunk=chunk,
                            interpret=True, fv_rows=tab[f])


def _port_visibility(v_clip, v_pos, faces, f_valid, res, chunk):
    prep = rc.prepare(torch.from_numpy(v_clip), torch.from_numpy(v_pos[0]),
                      torch.from_numpy(faces).long(),
                      torch.from_numpy(f_valid), res, chunk)
    z, fid, flags = rc.visibility(prep["table"], prep["orig"], prep["order"],
                                  prep["counts"], prep["masks"], prep["zlo"],
                                  prep["fbox"], res, prep["nsub"])
    return prep, z.numpy(), fid.numpy(), flags.numpy()


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_visibility_reference_matches_pallas_interpret(scene):
    """`visibility_reference` against the Pallas kernel in interpret mode:
    coverage identical, face_id identical except on float32 rounding ties
    (checked in float64), z within 1e-4 (`assert_same_visibility`)."""
    args = SCENES[scene]()
    want = _jax_pallas(*args)
    _prep, z, fid, _flags = _port_visibility(*args)
    assert_same_visibility(fid, want.face_id, z, want.z, args[0], args[2])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_rasterize_matches_xla_rasterize(scene):
    """The port's plain chunk-scan `rasterize` against the JAX one:
    visibility as above, barycentrics within 1e-5 where the faces agree."""
    v_clip, _v_pos, faces, f_valid, res, _chunk = SCENES[scene]()
    want = jrz.rasterize(jnp.asarray(v_clip), jnp.asarray(faces),
                         jnp.asarray(f_valid), res)
    got = trz.rasterize(torch.from_numpy(v_clip),
                        torch.from_numpy(faces).long(),
                        torch.from_numpy(f_valid), res)
    fid, fid_want = got.face_id.numpy(), np.asarray(want.face_id)
    assert_same_visibility(fid, fid_want, got.z.numpy(), want.z, v_clip,
                           faces)
    same = fid == fid_want
    np.testing.assert_allclose(got.uv.numpy()[same],
                               np.asarray(want.uv)[same], atol=1e-5, rtol=0)


def test_visibility_reference_matches_port_rasterize():
    """The tile-order walk with its occlusion skip and the plain chunk scan
    run the same float32 arithmetic: identical face_id and z."""
    for make in SCENES.values():
        v_clip, v_pos, faces, f_valid, res, chunk = make()
        _prep, z, fid, _flags = _port_visibility(v_clip, v_pos, faces,
                                                 f_valid, res, chunk)
        want = trz.rasterize(torch.from_numpy(v_clip),
                             torch.from_numpy(faces).long(),
                             torch.from_numpy(f_valid), res)
        np.testing.assert_array_equal(fid, want.face_id.numpy())
        np.testing.assert_array_equal(z, want.z.numpy())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_flags_cover_every_winner_chunk(scene):
    """Every (image, tile) flags the chunk that holds each of its final
    winners (the flags are a superset of the winner chunks)."""
    prep, _z, fid, flags = _port_visibility(*SCENES[scene]())
    H, W = fid.shape[1:]
    chunk = prep["table"].shape[-1]
    slot = np.empty(prep["orig"].numel(), np.int64)
    slot[prep["orig"].numpy()] = np.arange(prep["orig"].numel())
    ntx = W // rc.TILE_W
    ys, xs = np.nonzero(np.ones((H, W), bool))
    for b in range(fid.shape[0]):
        f = fid[b, ys, xs]
        hit = f > 0
        tiles = (ys[hit] // rc.TILE_H) * ntx + xs[hit] // rc.TILE_W
        chunks = slot[f[hit] - 1] // chunk
        assert flags[b, tiles, chunks].all()


def test_render_rasterizer_matches_reference_on_cpu():
    """`rasterize_cuda` on CPU tensors runs the plain version end to end
    (prep + visibility) and agrees with the plain chunk-scan rasterizer:
    the same face ids, and the barycentrics of `compute_barycentrics` on
    them within 1e-5."""
    v_clip, v_pos, faces, f_valid, res, _ = _random_scene()
    vc = torch.from_numpy(v_clip)
    f = torch.from_numpy(faces).long()
    fv = torch.from_numpy(f_valid)
    launches = rc.visibility.launches
    got = rc.rasterize_cuda(vc, f, fv, res, torch.from_numpy(v_pos[0]),
                            chunk=8)
    want = trz.rasterize(vc, f, fv, res)
    assert rc.visibility.launches == launches       # no kernel on the CPU
    np.testing.assert_array_equal(got.face_id.numpy(), want.face_id.numpy())
    uv = trz.compute_barycentrics(vc, f, got.face_id, res)
    np.testing.assert_allclose(uv.numpy(), want.uv.numpy(), atol=1e-5)


def test_visibility_checks_inputs():
    """The wrapper refuses, on the CPU as on the card, a table of the wrong
    type, a chunk list of the wrong shape, and cull boxes of the wrong
    type, shape or layout."""
    v_clip, v_pos, faces, f_valid, res, chunk = _random_scene()
    prep, *_ = _port_visibility(v_clip, v_pos, faces, f_valid, res, chunk)
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    fbox = prep["fbox"]
    with pytest.raises(ValueError):
        rc.visibility(prep["table"].double(), prep["orig"], *lists, fbox,
                      res, prep["nsub"])
    with pytest.raises(ValueError):
        rc.visibility(prep["table"], prep["orig"], prep["order"][:, :1],
                      *lists[1:], fbox, res, prep["nsub"])
    for bad in (fbox.int(), fbox[:, :-1].contiguous(), fbox[..., :3],
                fbox.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError):
            rc.visibility(prep["table"], prep["orig"], *lists, bad, res,
                          prep["nsub"])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_prepare_gives_variant_3_its_cull_boxes(scene):
    """`prepare` gives the default variant the per-face cull boxes its
    kernel reads; on the CPU they are `cull_boxes` of the table."""
    v_clip, v_pos, faces, f_valid, res, chunk = SCENES[scene]()
    prep = rc.prepare(torch.from_numpy(v_clip), torch.from_numpy(v_pos[0]),
                      torch.from_numpy(faces).long(),
                      torch.from_numpy(f_valid), res, chunk)
    B, nch, _rows, chunk = prep["table"].shape
    assert prep["fbox"].dtype == torch.int16
    assert tuple(prep["fbox"].shape) == (B, nch * chunk, 4)
    assert torch.equal(prep["fbox"], rc.cull_boxes(prep["table"], res))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from animals3d_tpu_torch.device import get_device
    with pytest.raises(RuntimeError):
        get_device("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.zeros(1, device="cuda")


def test_module_imports_without_nvcc():
    """Importing the kernel module builds nothing and needs no nvcc."""
    assert rc._LIB is None or torch.cuda.is_available()
    assert os.path.exists(rc._SOURCE)
