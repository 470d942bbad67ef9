"""Port parity for the visibility variants 4 and 6 (`raster_variant`, the
counterpart of the JAX package's `A3D_RASTER_V`): the port's plain versions
against the Pallas kernels `_raster_kernel_v4` and `_raster_kernel_v6` in
interpret mode, on the CPU. The selectors of the JAX package are read at
trace time, so each run sets them and clears `rasterize_pallas`'s cache,
as `tests/test_rasterize_pallas.py` does. The CUDA kernels are held to the
same plain versions on the card (`tests/test_torch_cuda.py`)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import rasterize_pallas as jrp
from animals3d_tpu_torch.ops import kernels
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from test_torch_raster import _depth_stack_scene, _random_scene, _sphere_scene
from torch_parity import assert_same_visibility


def _v4_scene():
    """Random small triangles over two 256-face chunks, so that variant 4
    runs (sub-blocks of 32 faces); 5% of the faces invalid."""
    rng = np.random.default_rng(11)
    B, Fn = 2, 400
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = (ctr + rng.uniform(-0.12, 0.12, (B, Fn, 3, 3))).reshape(B, 3 * Fn, 3)
    w = rng.uniform(2, 4, (B, 3 * Fn, 1))
    v_clip = np.concatenate([v * w, w], -1).astype(np.float32)
    v_pos = rng.normal(size=(B, 3 * Fn, 3)).astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3).astype(np.int32)
    return v_clip, v_pos, faces, rng.uniform(size=Fn) > 0.05, (32, 64), 256


def _posed_prior_scene():
    """The marching-tets sphere of `tests/test_torch_raster.py` (a prior
    mesh with capacity padding) seen by three cameras turned about the
    vertical axis; the Morton order follows its unposed positions."""
    v_clip, v_pos, faces, f_valid, res, _chunk = _sphere_scene()
    v_pos, faces, f_valid = np.array(v_pos), np.array(faces), \
        np.array(f_valid)
    verts = v_pos[0]
    views = []
    for ang in (0.0, 2.1, 4.2):
        c, s = np.cos(ang), np.sin(ang)
        rot = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        views.append(np.concatenate([verts @ rot.T * 2.0,
                                     np.full((len(verts), 1), 2.0)], -1))
    return (np.stack(views).astype(np.float32), v_pos, faces, f_valid, res,
            256)


def _sliver_scene():
    """Faces a hundredth to a thousandth of a pixel across far from the
    screen origin, where the float32 edge constant c = x1·y2 − x2·y1 is
    rounded by more than the face is wide: the faces' float32 edge tests
    accept pixels outside the faces' vertex bboxes."""
    rng = np.random.default_rng(2)
    B, Fn, H, W = 1, 3000, 64, 64
    ctr = rng.uniform(0.5, 0.98, (B, Fn, 1, 2))
    size = 10.0 ** rng.uniform(-5, -3, (B, Fn, 1, 1))
    xy = ctr + rng.uniform(-1, 1, (B, Fn, 3, 2)) * size
    z = rng.uniform(0.2, 0.8, (B, Fn, 3, 1))
    v = np.concatenate([xy, z], -1).reshape(B, 3 * Fn, 3)
    v_clip = np.concatenate([v, np.ones((B, 3 * Fn, 1))], -1) \
        .astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3).astype(np.int32)
    return (v_clip, v_clip[..., :3], faces, np.ones(Fn, bool), (H, W), 1024)


def _jax(monkeypatch, scene, variant, cap="128", nsub=None, kernel=None,
         bbase=None):
    """`rasterize_pallas` (interpret, fv_rows path) under A3D_RASTER_V; if
    `kernel` is given, counts the calls of that Pallas kernel; if `bbase`
    is a list, appends to it the run bases the prep hands the visibility
    kernel (`_pallas_visibility`'s `bbase`, as numpy)."""
    v_clip, v_pos, faces, f_valid, res, chunk = scene
    calls = []
    if kernel is not None:
        real = getattr(jrp, kernel)

        def counted(*args, **kw):
            calls.append(1)
            return real(*args, **kw)
        monkeypatch.setattr(jrp, kernel, counted)
    if bbase is not None:
        real_vis = jrp._pallas_visibility

        def capturing(*args, **kw):
            jax.debug.callback(lambda b: bbase.append(np.asarray(b)),
                               kw["bbase"])
            return real_vis(*args, **kw)
        monkeypatch.setattr(jrp, "_pallas_visibility", capturing)
    monkeypatch.setenv("A3D_RASTER_V", str(variant))
    monkeypatch.setenv("A3D_V6_CAP", cap)
    if nsub is not None:
        monkeypatch.setenv("A3D_NSUB", str(nsub))
    jrp.rasterize_pallas.clear_cache()
    try:
        B, V = v_clip.shape[:2]
        vc = jnp.asarray(v_clip)
        tab = jnp.concatenate([jnp.asarray(v_pos), vc], -1) \
            .transpose(1, 0, 2).reshape(V, B * 7)
        f = jnp.asarray(faces)
        out = jrp.rasterize_pallas(vc, f, jnp.asarray(f_valid), res,
                                   chunk=chunk, interpret=True,
                                   fv_rows=tab[f])
    finally:
        monkeypatch.delenv("A3D_RASTER_V")
        monkeypatch.delenv("A3D_V6_CAP")
        monkeypatch.delenv("A3D_NSUB", raising=False)
        jrp.rasterize_pallas.clear_cache()
    assert kernel is None or calls, f"{kernel} was not traced"
    return out


def _port(scene, variant, cap=128, nsub=rc.NSUB):
    v_clip, v_pos, faces, f_valid, res, chunk = scene
    t = torch.from_numpy
    return rc.rasterize_cuda(t(v_clip), t(faces).long(), t(f_valid), res,
                             t(v_pos[0]), chunk=chunk, variant=variant,
                             v6_cap=cap, nsub=nsub)


def _assert_flags_cover_winners(rast, scene, variant, nsub=rc.NSUB):
    """Every (image, tile) flags the chunk that holds each of its final
    winners, and flags only chunks that overlap it (as
    `tests/test_torch_raster.py:131`)."""
    v_clip, v_pos, faces, f_valid, res, chunk = scene
    t = torch.from_numpy
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, nsub, variant)
    fid, flags = rast.face_id.numpy(), rast.flags.numpy()
    assert not (flags & ~(prep["masks"].numpy() > 0)).any()
    H, W = fid.shape[1:]
    slot = np.empty(prep["orig"].numel(), np.int64)
    slot[prep["orig"].numpy()] = np.arange(prep["orig"].numel())
    ys, xs = np.nonzero(np.ones((H, W), bool))
    for b in range(fid.shape[0]):
        f = fid[b, ys, xs]
        hit = f > 0
        tiles = (ys[hit] // rc.TILE_H) * (W // rc.TILE_W) + xs[hit] // rc.TILE_W
        assert flags[b, tiles, slot[f[hit] - 1] // chunk].all()


def test_v4_plain_version_matches_pallas_v4_interpret(monkeypatch):
    """Variant 4 at chunk 256 (sub-blocks of 32 faces, the shape on which
    the JAX package runs `_raster_kernel_v4`; at chunk 64 it silently runs
    v3): face_id equal except on float32 ties checked in float64, z within
    1e-4 (`assert_same_visibility`), flags a superset of the winners."""
    scene = _v4_scene()
    want = _jax(monkeypatch, scene, 4, kernel="_raster_kernel_v4")
    got = _port(scene, 4)
    assert int((got.face_id > 0).sum()) > 500
    assert_same_visibility(got.face_id.numpy(), want.face_id, got.z.numpy(),
                           want.z, scene[0], scene[2])
    _assert_flags_cover_winners(got, scene, 4)


def test_v4_run_bases_match_pallas_v4_prep(monkeypatch):
    """`prepare(variant=4)`'s run bases equal the ones the JAX package's
    prep hands `_raster_kernel_v4` (`perm * blk`, `_rasterize_pallas_T`
    :904) on the same inputs: the two Morton orders agree."""
    scene = _v4_scene()
    want = []
    _jax(monkeypatch, scene, 4, bbase=want)
    assert len(want) == 1
    v_clip, v_pos, faces, f_valid, res, chunk = scene
    t = torch.from_numpy
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, variant=4)
    np.testing.assert_array_equal(prep["bbase"].numpy(), want[0].reshape(-1))


_V4_SCENES = {"random": lambda: _random_scene()[:5] + (256,),
              "depth_stack": lambda: _depth_stack_scene()[:5] + (256,),
              "posed_prior": _posed_prior_scene}


@pytest.mark.parametrize("scene", sorted(_V4_SCENES))
def test_prepare_v4_returns_run_bases(scene):
    """`prepare(variant=4)` returns the run bases bbase (nch·chunk / 32,)
    int32 with orig[s] == bbase[s // 32] + s % 32 for every sorted slot
    (padding included); on the CPU `visibility_v4` on them equals
    `visibility_reference` on `orig`, flags included."""
    v_clip, v_pos, faces, f_valid, res, chunk = _V4_SCENES[scene]()
    t = torch.from_numpy
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, variant=4)
    bbase, orig = prep["bbase"], prep["orig"]
    nch = prep["table"].shape[1]
    assert bbase.dtype == torch.int32 and bbase.is_contiguous()
    assert tuple(bbase.shape) == (nch * chunk // rc.BLOCK,)
    s = torch.arange(orig.numel())
    assert torch.equal(orig.long(), bbase.long()[s // 32] + s % 32)
    assert torch.equal(rc.orig_of_runs(bbase), orig)
    lists = (prep["order"], prep["counts"], prep["masks"], prep["zlo"])
    got = rc.visibility_v4(prep["table"], bbase, *lists, prep["fbox"], res,
                           prep["nsub"])
    want = rc.visibility_reference(prep["table"], orig, *lists, res,
                                   prep["nsub"])
    assert int((want[1] > 0).sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["orig", "int64", "short", "sub16"])
def test_visibility_v4_rejects_bad_run_bases(bad):
    """`visibility_v4` checks its run bases on either device: the slot ids
    `orig` in their place, another dtype or length, and sub-blocks that
    are not whole 32-face runs raise ValueError."""
    v_clip, v_pos, faces, f_valid, res, chunk = _v4_scene()
    t = torch.from_numpy
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, variant=4)
    bbase, nsub = prep["bbase"], prep["nsub"]
    if bad == "orig":
        bbase = prep["orig"]
    elif bad == "int64":
        bbase = bbase.long()
    elif bad == "short":
        bbase = bbase[1:].contiguous()
    else:
        nsub = 16
    with pytest.raises(ValueError):
        rc.visibility_v4(prep["table"], bbase, prep["order"], prep["counts"],
                         prep["masks"], prep["zlo"], prep["fbox"], res, nsub)


@pytest.mark.parametrize("cap", ["128", "2", "1"])
def test_v6_plain_version_matches_pallas_v6_interpret(monkeypatch, cap):
    """Variant 6 on the random scene (chunk 8, units of one face), with the
    unit lists capped at 128, at 2 (the full-scan fallback for most tiles)
    and at 1 (for every tile of more than one unit): face_id and z as
    above against `_raster_kernel_v6`, and the port's chunk flags a
    superset of the winners."""
    scene = _random_scene()
    want = _jax(monkeypatch, scene, 6, cap=cap, kernel="_raster_kernel_v6")
    got = _port(scene, 6, cap=int(cap))
    assert_same_visibility(got.face_id.numpy(), want.face_id, got.z.numpy(),
                           want.z, scene[0], scene[2])
    _assert_flags_cover_winners(got, scene, 6)
    if cap != "128":
        v_clip, v_pos, faces, f_valid, res, chunk = scene
        t = torch.from_numpy
        prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(),
                          t(f_valid), res, chunk, variant=6, v6_cap=int(cap))
        assert int((prep["counts6"] > prep["S"]).sum()) > 0


def test_v6_depth_stack_with_two_sub_blocks(monkeypatch):
    """The exact-z-tie and occlusion stack of
    `tests/test_rasterize_pallas.py:347` at chunk 2 with nsub 2 (units of
    one face): identical face_id, z within 1e-5, the tie to the smaller
    id."""
    scene = _depth_stack_scene()
    want = _jax(monkeypatch, scene, 6, nsub=2, kernel="_raster_kernel_v6")
    got = _port(scene, 6, nsub=2)
    np.testing.assert_array_equal(got.face_id.numpy(),
                                  np.asarray(want.face_id))
    np.testing.assert_allclose(got.z.numpy(), np.asarray(want.z), atol=1e-5)
    assert set(np.unique(got.face_id.numpy())) <= {1, 2}
    _assert_flags_cover_winners(got, scene, 6, nsub=2)


@pytest.mark.parametrize("cap", [128, 2])
@pytest.mark.parametrize("make", [_random_scene, _depth_stack_scene,
                                  _sphere_scene, _v4_scene])
def test_v6_plain_version_equals_v3_plain_version(make, cap):
    """Variant 6 computes K1's function: z and face_id identical to the v3
    plain version, bit for bit, with and without the overflow scan, on
    scenes where no face's depth at a pixel falls below the least vertex
    depth its chunk or unit is skipped by (where one does, the per-unit
    and the per-chunk skip may keep different winners; `chip_smoke.py`
    checks those pixels on the full-width meshes). The slot flags differ
    by design: the skip is per unit."""
    scene = make()
    nsub = 2 if make is _depth_stack_scene else rc.NSUB
    got = _port(scene, 6, cap=cap, nsub=nsub)
    want = _port(scene, 3, nsub=nsub)
    assert torch.equal(got.face_id, want.face_id)
    assert torch.equal(got.z, want.z)


@pytest.mark.parametrize("make", [_v4_scene, _sliver_scene, _sphere_scene,
                                  _depth_stack_scene])
def test_cull_boxes_hold_every_accepted_pixel(make):
    """Variants 3 and 4 test a face only on the pixels of its cull box.
    Every pixel centre whose float32 edge tests (a·px + b·py) + c ≥ 0
    accept it lies in the box, on the sliver scene too, where the accepted
    pixels leave the faces' vertex bboxes, and on the depth stack, a
    variant-3 scene of one sub-block per chunk (nsub 1)."""
    v_clip, v_pos, faces, f_valid, res, chunk = make()
    t = torch.from_numpy
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, variant=4 if chunk % 256 == 0 else 3)
    if make is _depth_stack_scene:
        assert prep["nsub"] == 1
    table = prep["table"]
    box = prep["fbox"].long()
    assert torch.equal(prep["fbox"], rc.cull_boxes(table, res))
    B, nch, _rows, chunk = table.shape
    H, W = res
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    X, Y = xs.reshape(-1).float() + 0.5, ys.reshape(-1).float() + 0.5
    coef = table.permute(0, 1, 3, 2).reshape(B, nch * chunk, 12)
    accepted = 0
    for b in range(B):
        c = coef[b]
        e = [rc.affine(c[:, i, None], c[:, i + 4, None], c[:, i + 8, None],
                       X, Y) >= 0 for i in range(3)]
        hit = e[0] & e[1] & e[2]
        bx = box[b]
        inside = ((xs.reshape(-1) >= bx[:, 0:1]) & (xs.reshape(-1) <= bx[:, 1:2])
                  & (ys.reshape(-1) >= bx[:, 2:3])
                  & (ys.reshape(-1) <= bx[:, 3:4]))
        assert not (hit & ~inside).any()
        # an invalid face covers nothing and has an empty box
        empty = (bx[:, 0] > bx[:, 1]) | (bx[:, 2] > bx[:, 3])
        assert not hit[empty].any()
        print(f"image {b}: accepted pairs {int(hit.sum())}, box pairs "
              f"{int(inside.sum())}, empty boxes {int(empty.sum())}")
        accepted += int(hit.sum())
    assert accepted > 0


def _holes_scene():
    """Invalid and empty faces: small random triangles, the first 256 faces
    invalid (whole Morton blocks: whole units hold no valid face), 60
    degenerate (zero area) and 60 with a vertex behind the camera."""
    rng = np.random.default_rng(4)
    B, Fn = 2, 800
    ctr = rng.uniform(-0.9, 0.9, (B, Fn, 1, 3))
    v = ctr + rng.uniform(-0.12, 0.12, (B, Fn, 3, 3))
    v[:, 300:360] = v[:, 300:360, :1]
    w = rng.uniform(2, 4, (B, Fn, 3, 1))
    w[:, 400:460, 0] = -1.0
    v_clip = np.concatenate([v * w, w], -1).reshape(B, 3 * Fn, 4) \
        .astype(np.float32)
    faces = np.arange(3 * Fn).reshape(Fn, 3).astype(np.int32)
    f_valid = np.ones(Fn, bool)
    f_valid[:256] = False
    return (v_clip, v.reshape(B, 3 * Fn, 3).astype(np.float32), faces,
            f_valid, (32, 64), 128)


def _prep6(scene, **kw):
    v_clip, v_pos, faces, f_valid, res, chunk = scene
    t = torch.from_numpy
    return rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, chunk, variant=6, **kw), res


@pytest.mark.parametrize("make", [_v4_scene, _sliver_scene, _sphere_scene,
                                  _depth_stack_scene, _holes_scene])
def test_unit_boxes_hold_every_accepted_pixel(make):
    """K3 takes an overflow tile's faces only from the units whose box
    (`unit_boxes`, the union of their faces' cull boxes) meets the tile.
    Every pixel centre that any face of a unit accepts by its float32
    edge tests (a·px + b·py) + c ≥ 0 lies in the unit's box, on the sliver
    scene too, where the accepted pixels leave the faces' vertex bboxes;
    a unit whose faces are all invalid or empty has an empty box."""
    prep, res = _prep6(make(), nsub=2 if make is _depth_stack_scene
                       else rc.NSUB)
    table, ubox = prep["table"], prep["ubox"].long()
    B, nch, _rows, chunk = table.shape
    sub = chunk // prep["nsub"]
    H, W = res
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    X, Y = xs.float() + 0.5, ys.float() + 0.5
    coef = table.permute(0, 1, 3, 2).reshape(B, nch * chunk, 12)
    accepted, empty = 0, 0
    for b in range(B):
        c = coef[b]
        e = [rc.affine(c[:, i, None], c[:, i + 4, None], c[:, i + 8, None],
                       X, Y) >= 0 for i in range(3)]
        hit = (e[0] & e[1] & e[2]).reshape(-1, sub, H * W).any(1)
        bx = ubox[b]
        inside = ((xs >= bx[:, 0:1]) & (xs <= bx[:, 1:2])
                  & (ys >= bx[:, 2:3]) & (ys <= bx[:, 3:4]))
        assert not (hit & ~inside).any()
        none = (bx[:, 0] > bx[:, 1]) | (bx[:, 2] > bx[:, 3])
        assert not hit[none].any()
        accepted += int(hit.sum())
        empty += int(none.sum())
    assert accepted > 0
    if make is _holes_scene:
        assert 0 < empty < B * ubox.shape[1]


@pytest.mark.parametrize("make", [_v4_scene, _holes_scene])
def test_prepare_v6_returns_face_and_unit_boxes(make):
    """`prepare(variant=6)` returns the face cull boxes (`cull_boxes` of its
    table) and the unit boxes (`unit_boxes` of those), int16, with the
    empty box (W, -1, H, -1) for a unit whose faces' boxes are all
    empty."""
    prep, (H, W) = _prep6(make())
    table = prep["table"]
    B, nch, _rows, chunk = table.shape
    sub = chunk // prep["nsub"]
    assert torch.equal(prep["fbox"], rc.cull_boxes(table, (H, W)))
    assert prep["ubox"].dtype == torch.int16
    assert prep["ubox"].shape == (B, nch * prep["nsub"], 4)
    assert torch.equal(prep["ubox"], rc.unit_boxes(prep["fbox"], sub, (H, W)))
    fb = prep["fbox"].reshape(B, -1, sub, 4).long()
    some = ((fb[..., 0] <= fb[..., 1]) & (fb[..., 2] <= fb[..., 3])).any(-1)
    want_empty = torch.tensor([W, -1, H, -1], dtype=torch.int16)
    assert (prep["ubox"][~some] == want_empty).all()
    assert some.any()
    if make is _holes_scene:
        assert (~some).any()


# (chunk, nsub) for units of 2, 12, 64, 128 (the full width's) and 512
# slots; every shape leaves units of invalid faces only (the scene's first
# 256 faces and the padding sort last)
CULL_UNIT_SHAPES = {2: (16, 8), 12: (96, 8), 64: (512, 8), 128: (1024, 8),
                    512: (2048, 4)}


@pytest.mark.parametrize("sub", sorted(CULL_UNIT_SHAPES))
def test_cull_units_plain_version_equals_cull_and_unit_boxes(sub):
    """`cull_units` on the CPU is `cull_boxes` and `unit_boxes` of those;
    each unit box is the union of the unit's non-empty face boxes (folded
    here one unit at a time), and a unit of invalid faces only has the
    empty box (W, -1, H, -1); `prepare(variant=6)` returns the same
    boxes."""
    chunk, nsub = CULL_UNIT_SHAPES[sub]
    prep, (H, W) = _prep6(_holes_scene()[:5] + (chunk,), nsub=nsub)
    table = prep["table"]
    assert table.shape[-1] // prep["nsub"] == sub
    fbox, ubox = rc.cull_units(table, (H, W), sub)
    assert torch.equal(fbox, rc.cull_boxes(table, (H, W)))
    assert torch.equal(ubox, rc.unit_boxes(fbox, sub, (H, W)))
    assert torch.equal(fbox, prep["fbox"]) and torch.equal(ubox, prep["ubox"])
    B = table.shape[0]
    fb = fbox.numpy().reshape(B, -1, sub, 4)
    invalid = (table[:, :, :3] == 0).all(2) & (table[:, :, 4:7] == 0).all(2) \
        & (table[:, :, 8:11] < 0).any(2)
    invalid = invalid.reshape(B, -1, sub).all(-1)
    for b in range(B):
        for u in range(fb.shape[1]):
            bx = fb[b, u]
            some = bx[(bx[:, 0] <= bx[:, 1]) & (bx[:, 2] <= bx[:, 3])]
            want = ([some[:, 0].min(), some[:, 1].max(), some[:, 2].min(),
                     some[:, 3].max()] if len(some) else [W, -1, H, -1])
            assert ubox[b, u].tolist() == [int(v) for v in want]
    empty = torch.tensor([W, -1, H, -1], dtype=torch.int16)
    assert invalid.any() and (ubox[invalid] == empty).all()


def _hand_made(case):
    """A table (1, 1, 12, 8) of hand-made faces for `case` in slots 0 and
    1, invalid faces (0, 0, -1) in the rest: the screen is 32 by 64."""
    s = 2.0 ** -40
    faces = {
        # two parallel edge normals: a corner's det is 0
        "parallel": [[(1, 0, -2), (-1, 0, 10), (0, 1, -3)],
                     [(0, 1, -2), (0, -1, 20), (1, 0, -5)]],
        "invalid": [[(0, 0, -1)] * 3, [(1, 0, -4), (0, 0, -1), (0, 1, 0)]],
        # corner 2 at x = 10.5 -+ 8s, within 1e-9 of a half-pixel
        "half_pixel": [[(1, s, -10.5), (0, 1, -8), (-1, -1, 30)],
                       [(1, -s, -10.5), (0, 1, -8), (-1, -1, 30)]],
    }[case]
    table = torch.zeros((1, 1, 12, 8), dtype=torch.float32)
    table[0, 0, 8:11] = -1.0
    for f, edges in enumerate(faces):
        for k, (a, b, c) in enumerate(edges):
            table[0, 0, k, f], table[0, 0, 4 + k, f] = a, b
            table[0, 0, 8 + k, f] = c
    return table, (32, 64)


@pytest.mark.parametrize("case", ["parallel", "invalid", "half_pixel"])
def test_cull_boxes_of_hand_made_faces(case):
    """Faces at the edges of the cull arithmetic: two parallel edges (a
    corner's det is 0: the whole screen), an invalid face (an edge (0, 0,
    -1): empty, also beside valid edges), and a corner within 1e-9 of a
    pixel centre's column. Every pixel centre the float32 edge tests accept
    lies in the face's box; `cull_units` folds the boxes of units of 2
    slots."""
    table, (H, W) = _hand_made(case)
    box = rc.cull_boxes(table, (H, W))[0].long()
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    X, Y = xs.float() + 0.5, ys.float() + 0.5
    c = table[0, 0].T
    hit = (rc.affine(c[:, 0, None], c[:, 4, None], c[:, 8, None], X, Y) >= 0) \
        & (rc.affine(c[:, 1, None], c[:, 5, None], c[:, 9, None], X, Y) >= 0) \
        & (rc.affine(c[:, 2, None], c[:, 6, None], c[:, 10, None], X, Y) >= 0)
    inside = ((xs >= box[:, 0:1]) & (xs <= box[:, 1:2])
              & (ys >= box[:, 2:3]) & (ys <= box[:, 3:4]))
    assert not (hit & ~inside).any()
    assert not hit[2:].any() and (box[2:, 0] > box[2:, 1]).all()
    if case == "parallel":
        assert box[:2].tolist() == [[0, W - 1, 0, H - 1]] * 2
        assert hit[0].any() and hit[1].any()
    elif case == "invalid":
        assert not hit[:2].any() and (box[:2, 0] > box[:2, 1]).all()
    else:
        # the column of the corner's pixel centre is accepted and boxed
        for f in range(2):
            assert bool(hit[f].reshape(H, W)[8:, 10].any())
            assert box[f, 0] == 10
    fbox, ubox = rc.cull_units(table, (H, W), 2)
    assert torch.equal(fbox[0].long(), box)
    assert torch.equal(ubox, rc.unit_boxes(fbox, 2, (H, W)))
    assert ubox[0, 1:].tolist() == [[W, -1, H, -1]] * 3


def test_v6_rejects_bad_boxes():
    """`visibility_v6` checks the face and unit boxes on either device: a
    wrong type or shape raises."""
    prep, res = _prep6(_v4_scene())
    args = (prep["table"], prep["orig"], prep["units"], prep["counts6"],
            prep["zu"])
    for fbox, ubox in ((prep["fbox"].int(), prep["ubox"]),
                       (prep["fbox"], prep["ubox"].int()),
                       (prep["fbox"], prep["ubox"][:, 1:].contiguous())):
        with pytest.raises(ValueError):
            rc.visibility_v6(*args, fbox, ubox, res, prep["nsub"])
    got = rc.visibility_v6(*args, prep["fbox"], prep["ubox"], res,
                           prep["nsub"])
    want = rc.visibility_v6_reference(*args, res, prep["nsub"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_library_hash_covers_sources_and_headers(tmp_path, monkeypatch):
    """The kernel library's name hashes every `csrc/*.cu` and every header
    they include (`*.cuh`): an edit of either builds anew, and a file of
    another kind does not."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(kernels._PKG_DIR, "csrc"), csrc)
    monkeypatch.setattr(kernels, "_PKG_DIR", str(tmp_path))
    headers = sorted(csrc.glob("*.cuh"))
    assert headers
    first = kernels.library_path()
    (csrc / "notes.txt").write_text("not a source")
    assert kernels.library_path() == first
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    second = kernels.library_path()
    assert second != first
    src = csrc / "raster_vis_v6.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert kernels.library_path() not in (first, second)
    assert all(p.endswith(".cu") for p in kernels._sources())


def test_variants_reject_shapes_they_cannot_run():
    """A variant that cannot run raises (the JAX package falls back to v3
    instead): variant 4 needs sub-blocks of a multiple of 32 faces,
    variant 6 more than one sub-block per chunk; other variants and
    selectors are refused too."""
    v_clip, v_pos, faces, f_valid, res, _chunk = _random_scene()
    t = torch.from_numpy
    args = (t(v_clip), t(faces).long(), t(f_valid), res, t(v_pos[0]))
    for kw in (dict(variant=4, chunk=64), dict(variant=4, chunk=256, nsub=16),
               dict(variant=6, chunk=2), dict(variant=6, chunk=12),
               dict(variant=6, chunk=64, nsub=1), dict(variant=5),
               dict(variant=3, nsub=0)):
        with pytest.raises(ValueError):
            rc.rasterize_cuda(*args, **kw)
    rc.rasterize_cuda(*args, variant=4, chunk=256)
    rc.rasterize_cuda(*args, variant=6, chunk=16)
    prep = rc.prepare(t(v_clip), t(v_pos[0]), t(faces).long(), t(f_valid),
                      res, 256, variant=4)
    with pytest.raises(ValueError):
        rc.visibility_v4(prep["table"], prep["bbase"], prep["order"],
                         prep["counts"], prep["masks"], prep["zlo"],
                         prep["fbox"].int(), res, prep["nsub"])
