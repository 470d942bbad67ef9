"""Keypoint-transfer PCK evaluation (port of `animals3d_tpu.evaluation`;
numpy only, a copy of its functions).

Reference: `evaluation/evaluate.py`: the repo's quantitative benchmark —
sample image pairs, map each annotated source keypoint to its nearest
*visible* predicted 2D-projected mesh vertex, transfer that vertex to the
target image via the shared mesh topology, and score PCK@0.1 (error
normalized by bounding-box size, `evaluate.py:234-237,389-398,461-472`).

Reads the `_2d_projection_uv.txt` / `_binary_occlusion.txt` artifacts
written by `animals3d_tpu_torch.visualization` with `evaluate_keypoint:
true`, plus keypoint annotation files (`<stem>_keypoints.txt`: rows of x y
visible in [-1, 1] crop coordinates), or an ACSM `.mat` annotation file.

Entry: `python -m animals3d_tpu_torch.evaluation --result-dir D
--annotation-dir A`.
"""
from __future__ import annotations

import os
from glob import glob

import numpy as np


def load_predictions(result_dir: str):
    """→ list of dicts with uv (V,2 in [-1,1]) and occlusion (V,) bool."""
    preds = []
    for uv_path in sorted(glob(os.path.join(result_dir,
                                            "*_2d_projection_uv.txt"))):
        occ_path = uv_path.replace("_2d_projection_uv.txt",
                                   "_binary_occlusion.txt")
        preds.append({
            "uv": np.loadtxt(uv_path, dtype=np.float32).reshape(-1, 2),
            "occluded": np.loadtxt(occ_path, dtype=np.float32)
            .reshape(-1).astype(bool),
            "stem": os.path.basename(uv_path)
            [:-len("_2d_projection_uv.txt")],
        })
    return preds


def nearest_visible_vertex(kp_uv: np.ndarray, pred: dict) -> np.ndarray:
    """For each keypoint (K, 2) in [-1,1], the nearest visible vertex id."""
    uv = pred["uv"]
    vis = ~pred["occluded"]
    big = 1e9
    d = np.linalg.norm(uv[None] - kp_uv[:, None], axis=-1)   # (K, V)
    d[:, ~vis] = big
    return d.argmin(1)


def transfer_keypoints(src_kp: np.ndarray, src_pred: dict,
                       tgt_pred: dict) -> tuple[np.ndarray, np.ndarray]:
    """Transfer source keypoints to the target image via shared topology
    (`evaluate.py:461-472`). Returns (transferred (K,2), valid (K,))."""
    vid = nearest_visible_vertex(src_kp, src_pred)
    transferred = tgt_pred["uv"][vid]
    valid = ~tgt_pred["occluded"][vid]
    return transferred, valid


def compute_pck(errors: np.ndarray, valid: np.ndarray,
                threshold: float = 0.1) -> float:
    """PCK: fraction of valid transfers with normalized error < threshold
    (`evaluate.py:234-237`)."""
    if valid.sum() == 0:
        return 0.0
    return float((errors[valid] < threshold).mean())


def evaluate_pairs(preds, keypoints, pairs, threshold=0.1,
                   box_size: float = 2.0):
    """Run keypoint transfer over (src, tgt) index pairs.

    keypoints: list of (K, 3) arrays [x, y, visible] in [-1,1] coords.
    box_size: normalization span (2.0 = the full [-1,1] crop, matching the
    reference's box-size normalization of the square crop).
    """
    errors, valids = [], []
    for s, t in pairs:
        kp_s, kp_t = keypoints[s], keypoints[t]
        both_vis = (kp_s[:, 2] > 0) & (kp_t[:, 2] > 0)
        trans, valid = transfer_keypoints(kp_s[:, :2], preds[s], preds[t])
        err = np.linalg.norm(trans - kp_t[:, :2], axis=-1) / box_size
        errors.append(err)
        valids.append(valid & both_vis)
    errors = np.concatenate(errors)
    valids = np.concatenate(valids)
    return {"pck": compute_pck(errors, valids, threshold),
            "mean_error": float(errors[valids].mean()) if valids.any() else 0.0,
            "num_pairs": len(pairs), "num_valid_kp": int(valids.sum())}


# ---------------------------------------------------------------------------
# ACSM / PASCAL ingestion (`evaluate.py:155-198, 369-458`): parse the ACSM
# cachedir `.mat` annotations, reproduce the reference's seeded pair-sampling
# scheme and box-normalized keypoint error. Offline only — the annotation
# download itself (`evaluate.py:134-152`, a Dropbox tarball) is out of scope
# for a zero-egress environment; point `annotations_mat` at the extracted
# `cachedir/pascal/data/{category}_val.mat`.
# ---------------------------------------------------------------------------

def load_pascal_annotations(pascal_annotations_path):
    """Parse an ACSM `{category}_val.mat` → {name: {box, kp, visible}}
    (`evaluate.py:155-172`). box = [x_min, y_min, w, h]; kp = (K, 2) pixel
    coords; visible = (K,)."""
    import scipy.io as sio
    anno = sio.loadmat(pascal_annotations_path, struct_as_record=False,
                       squeeze_me=True)["images"]
    parsed = {}
    for sample in np.atleast_1d(anno):
        name = sample.rel_path[:-4] + f"_{sample.voc_rec_id}"
        box = [sample.bbox.x1, sample.bbox.y1,
               sample.bbox.x2 - sample.bbox.x1,
               sample.bbox.y2 - sample.bbox.y1]
        kp = np.asarray(sample.parts[:2], np.float64).T
        visible = np.asarray(sample.parts[2], np.float64)
        parsed[name] = {"box": box, "kp": kp, "visible": visible}
    return parsed


def crop_keypoints_with_box(kp, box):
    """Pixel keypoints → [-1,1] coords of the crop `box` = [x, y, w, h]
    (`evaluate.py:192-205`)."""
    x, y, w, h = box
    kp = np.asarray(kp, np.float64).copy()
    kp[:, 0] = (kp[:, 0] - x) / w * 2 - 1
    kp[:, 1] = (kp[:, 1] - y) / h * 2 - 1
    return kp


def uncrop_keypoints_with_box(kp, box):
    """Inverse of `crop_keypoints_with_box` (`evaluate.py:208-218`)."""
    x, y, w, h = box
    kp = np.asarray(kp, np.float64).copy()
    kp[:, 0] = (kp[:, 0] + 1) / 2 * w + x
    kp[:, 1] = (kp[:, 1] + 1) / 2 * h + y
    return kp


class AcsmBenchmark:
    """The reference's PASCAL keypoint-transfer benchmark harness
    (`evaluate.py:369-458`): seeded pair sampling over annotation names and
    box-size-normalized keypoint error accumulation."""

    def __init__(self, annotations_mat, box_pad_frac=0.0, seed=0):
        import random as _random
        self.pascal_annotations = load_pascal_annotations(annotations_mat)
        self.box_pad_frac = box_pad_frac
        self.random = _random.Random(seed)

    def sample_pair(self):
        return tuple(self.random.sample(
            list(self.pascal_annotations.keys()), 2))

    def load_keypoints(self, name):
        a = self.pascal_annotations[name]
        return a["kp"], a["visible"]

    def load_box(self, name):
        return self.pascal_annotations[name]["box"]

    def compute_keypoints_error(self, name, keypoints_pred):
        """Per-keypoint error in the original image frame, normalized by the
        padded box size (`evaluate.py:389-398`)."""
        keypoints_gt, target_visible = self.load_keypoints(name)
        kps_err = np.linalg.norm(keypoints_gt - keypoints_pred, axis=-1)
        _, _, box_w, box_h = self.load_box(name)
        box_size = max(box_w, box_h) * (1 + 2 * self.box_pad_frac)
        return kps_err / box_size, target_visible, keypoints_gt


def evaluate_acsm(result_dir, annotations_mat, crop_box_dir=None,
                  box_postfix="_box.txt", n_pairs=10000, threshold=0.1,
                  seed=0, box_pad_frac=0.0):
    """The reference's full evaluation loop (`evaluate.py:545-600`): sample
    annotation-name pairs, transfer keypoints through predicted vertices,
    score PCK@threshold in original-image pixels / box size.

    Predictions are this repo's `_2d_projection_uv.txt` /
    `_binary_occlusion.txt` dumps named by annotation name; per-image crop
    boxes come from `<name><box_postfix>` files in `crop_box_dir` (reference
    row format: id xmin ymin w h full_w full_h sharpness).
    """
    preds = {p["stem"]: p for p in load_predictions(result_dir)}
    bench = AcsmBenchmark(annotations_mat, box_pad_frac=box_pad_frac,
                          seed=seed)
    crop_box_dir = crop_box_dir or result_dir

    def crop_box(name):
        row = np.loadtxt(os.path.join(crop_box_dir, name + box_postfix))
        return row[1:5]

    errors, valids, n_used = [], [], 0
    for _ in range(n_pairs):
        src, tgt = bench.sample_pair()
        if src not in preds or tgt not in preds:
            continue
        src_kp_px, src_vis = bench.load_keypoints(src)
        src_kp = crop_keypoints_with_box(src_kp_px, crop_box(src))
        trans, t_valid = transfer_keypoints(
            src_kp.astype(np.float32), preds[src], preds[tgt])
        trans_px = uncrop_keypoints_with_box(trans, crop_box(tgt))
        err, tgt_vis, _gt = bench.compute_keypoints_error(tgt, trans_px)
        errors.append(err)
        valids.append((src_vis > 0) & (tgt_vis > 0) & t_valid)
        n_used += 1
    if not errors:
        return {"pck": 0.0, "num_pairs": 0, "num_valid_kp": 0}
    errors = np.concatenate(errors)
    valids = np.concatenate(valids)
    return {"pck": compute_pck(errors, valids, threshold),
            "mean_error": float(errors[valids].mean()) if valids.any() else 0.0,
            "num_pairs": n_used,
            "num_valid_kp": int(valids.sum())}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--result-dir", required=True)
    ap.add_argument("--annotation-dir", required=True,
                    help="dir of <stem>_keypoints.txt files ([x y vis] rows)")
    ap.add_argument("--num-pairs", type=int, default=10000)
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--acsm-annotations", default=None,
                    help="ACSM {category}_val.mat → run the reference "
                         "PASCAL benchmark loop instead of txt keypoints")
    ap.add_argument("--crop-box-dir", default=None)
    ap.add_argument("--box-pad-frac", type=float, default=0.0)
    args = ap.parse_args(argv)

    if args.acsm_annotations:
        out = evaluate_acsm(args.result_dir, args.acsm_annotations,
                            crop_box_dir=args.crop_box_dir,
                            n_pairs=args.num_pairs,
                            threshold=args.threshold, seed=args.seed,
                            box_pad_frac=args.box_pad_frac)
        print(out)
        return out

    preds = load_predictions(args.result_dir)
    keypoints = []
    kept = []
    for p in preds:
        kp_path = os.path.join(args.annotation_dir,
                               p["stem"] + "_keypoints.txt")
        if os.path.exists(kp_path):
            keypoints.append(np.loadtxt(kp_path, dtype=np.float32)
                             .reshape(-1, 3))
            kept.append(p)
    preds = kept
    assert len(preds) >= 2, "need at least two annotated predictions"
    rng = np.random.default_rng(args.seed)
    pairs = rng.integers(0, len(preds), (args.num_pairs, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    out = evaluate_pairs(preds, keypoints, pairs.tolist(),
                         threshold=args.threshold)
    print(out)
    return out


if __name__ == "__main__":
    main()
