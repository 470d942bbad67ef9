"""The port's keypoint evaluation (`animals3d_tpu_torch.evaluation`, a copy
of the numpy module) against the JAX package's: the cases of
`tests/test_evaluation.py` and `tests/test_evaluation_acsm.py`, seeded
random artifacts written as the Visualizer writes them, and both `main`
forms. The outputs are equal (the same numpy operations)."""
import os

import numpy as np
import pytest

from animals3d_tpu import evaluation as jev
from animals3d_tpu_torch import evaluation as tev
from test_evaluation_acsm import _write_mat


def _pred(rng, V=50, occlude=None):
    uv = rng.uniform(-0.9, 0.9, (V, 2)).astype(np.float32)
    occ = np.zeros(V, bool)
    if occlude is not None:
        occ[occlude] = True
    return {"uv": uv, "occluded": occ, "stem": "x"}


def _kp(uv, n=10):
    return np.concatenate([uv[:n], np.ones((n, 1), np.float32)], -1)


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _case_perfect(ev):
    pred = _pred(np.random.default_rng(0))
    kp = _kp(pred["uv"])
    return ev.evaluate_pairs([pred, pred], [kp, kp], [(0, 1)])


def _case_shifted(ev):
    src = _pred(np.random.default_rng(1))
    tgt = {"uv": src["uv"] + 0.5, "occluded": src["occluded"], "stem": "y"}
    kp = _kp(src["uv"])
    return ev.evaluate_pairs([src, tgt], [kp, kp.copy()], [(0, 1)])


def _case_occluded(ev):
    pred = _pred(np.random.default_rng(2), occlude=np.arange(25))
    return ev.nearest_visible_vertex(_kp(pred["uv"])[:, :2], pred)


def _case_threshold(ev):
    errors = np.array([0.05, 0.09, 0.11, 0.5])
    return [ev.compute_pck(errors, np.ones(4, bool), t)
            for t in (0.05, 0.1, 0.2)] + \
        [ev.compute_pck(errors, np.zeros(4, bool))]


def _case_random(seed):
    def case(ev):
        r = np.random.default_rng(seed)
        preds = [_pred(r, V=80, occlude=r.random(80) < 0.3)
                 for _ in range(4)]
        kps = [np.concatenate([r.uniform(-1, 1, (12, 2)),
                               (r.random((12, 1)) < 0.8)], 1)
               .astype(np.float32) for _ in range(4)]
        pairs = r.integers(0, 4, (30, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]].tolist()
        return (ev.transfer_keypoints(kps[0][:, :2], preds[0], preds[1]),
                ev.evaluate_pairs(preds, kps, pairs, threshold=0.15))
    return case


def _case_crop():
    kp = np.array([[30.0, 40.0], [90.0, 100.0], [-5.0, 300.0]])
    box = [10.0, 20.0, 100.0, 80.0]

    def case(ev):
        crop = ev.crop_keypoints_with_box(kp, box)
        return crop, ev.uncrop_keypoints_with_box(crop, box)
    return case


CASES = {"perfect": _case_perfect, "shifted": _case_shifted,
         "occluded": _case_occluded, "threshold": _case_threshold,
         "crop": _case_crop(),
         **{f"random_{s}": _case_random(s) for s in (0, 1, 2)}}


@pytest.mark.parametrize("name", sorted(CASES))
def test_functions_match_jax(name):
    _same(CASES[name](tev), CASES[name](jev))


def _write_artifacts(d, r, n=4, V=60):
    """Visualizer-style artifacts of n images and their keypoint files."""
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        p = os.path.join(d, f"{i:07d}")
        np.savetxt(p + "_2d_projection_uv.txt",
                   r.uniform(-1, 1, (V, 2)), fmt="%.6f")
        np.savetxt(p + "_binary_occlusion.txt",
                   (r.random((V, 1)) < 0.3).astype(np.float32), fmt="%d")
        np.savetxt(p + "_keypoints.txt", np.concatenate(
            [r.uniform(-1, 1, (8, 2)), r.random((8, 1)) < 0.9], 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_txt_main_matches_jax(tmp_path, seed):
    """`load_predictions` and `main` over seeded random artifacts with
    keypoint files: equal outputs."""
    d = str(tmp_path / "res")
    _write_artifacts(d, np.random.default_rng(seed))
    _same(tev.load_predictions(d), jev.load_predictions(d))
    args = ["--result-dir", d, "--annotation-dir", d, "--num-pairs", "64",
            "--seed", str(seed)]
    got, want = tev.main(args), jev.main(args)
    assert got["num_valid_kp"] > 0
    _same(got, want)


def test_acsm_matches_jax(tmp_path):
    """The ACSM path on `tests/test_evaluation_acsm.py`'s synthetic `.mat`:
    the parsed annotations, the benchmark's pair sampling and keypoint
    error, `evaluate_acsm` and `main --acsm-annotations`: equal."""
    mat = str(tmp_path / "horse_val.mat")
    _write_mat(mat)
    _same(tev.load_pascal_annotations(mat), jev.load_pascal_annotations(mat))
    tb, jb = tev.AcsmBenchmark(mat, seed=7), jev.AcsmBenchmark(mat, seed=7)
    for _ in range(5):
        assert tb.sample_pair() == jb.sample_pair()
    pred = np.array([[31.0, 41.0], [60.0, 75.0], [0.0, 0.0]])
    _same(tb.compute_keypoints_error("img1_1", pred),
          jb.compute_keypoints_error("img1_1", pred))
    res = tmp_path / "preds"
    res.mkdir()
    r = np.random.default_rng(3)
    for name, a in tev.load_pascal_annotations(mat).items():
        uv = tev.crop_keypoints_with_box(a["kp"], a["box"]) \
            + r.normal(0, 0.1, (3, 2))
        np.savetxt(res / f"{name}_2d_projection_uv.txt", uv)
        np.savetxt(res / f"{name}_binary_occlusion.txt", np.zeros(3))
        x, y, w, h = a["box"]
        np.savetxt(res / f"{name}_box.txt", [[0, x, y, w, h, 500, 500, 1]])
    _same(tev.evaluate_acsm(str(res), mat, n_pairs=20, seed=1),
          jev.evaluate_acsm(str(res), mat, n_pairs=20, seed=1))
    args = ["--result-dir", str(res), "--annotation-dir", str(res),
            "--acsm-annotations", mat, "--num-pairs", "15"]
    got = tev.main(args)
    assert got["num_pairs"] == 15
    _same(got, jev.main(args))
