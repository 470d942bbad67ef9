"""Test-output writers: the artifact contract consumed by evaluation and
visualization (port of `animals3d_tpu.utils.results_io`).

Reference: `AnimalModel.save_results` (`reference model/models/AnimalModel.py:638-663`)
and `misc.save_images/save_obj/save_txt` (`misc.py:101-187`): per-frame pngs
(input image / gt+pred masks / pred rgb), `.obj` mesh dumps, and pose /
articulation txt files. Values may be tensors on any device or numpy
arrays; the files are the JAX package's for the same values.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_image(path, img_chw):
    """(C, H, W) float [0,1] → png."""
    from PIL import Image
    arr = np.clip(_np(img_chw), 0, 1)
    if arr.ndim == 3:
        arr = arr.transpose(1, 2, 0)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def save_obj(path, verts, faces, v_valid=None, f_valid=None):
    """Write a .obj; invalid capacity slots are dropped (indices remapped)."""
    verts = _np(verts)
    faces = _np(faces)
    if v_valid is not None:
        v_valid = _np(v_valid)
        remap = np.cumsum(v_valid) - 1
        verts = verts[v_valid]
    else:
        remap = np.arange(len(verts))
    if f_valid is not None:
        faces = faces[_np(f_valid)]
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            a, b, c = (remap[i] + 1 for i in tri)
            f.write(f"f {a} {b} {c}\n")


def save_txt(path, arr, fmt="%.6f"):
    arr = _np(arr)
    np.savetxt(path, arr.reshape(arr.shape[0], -1), fmt=fmt)


def save_results(model, batch, aux, out_dir, start_index=0):
    """Per-sample result dump matching the reference layout."""
    images = _np(batch["images"])
    masks = _np(batch["masks"])
    B, F = images.shape[:2]
    mask_pred = _np(aux["mask_pred"])
    image_pred = _np(aux["image_pred"])
    pose = _np(aux["pose"])
    shape = aux["shape"]
    v_valid = _np(shape.v_valid)
    f_valid = _np(shape.f_valid)
    faces = _np(shape.t_pos_idx)
    verts_all = _np(shape.v_pos)
    arti = aux.get("arti_params")
    arti = None if arti is None else _np(arti)

    def flow_viz(fl):
        # 2-channel flow → rgb with zero blue, shifted by +0.5
        # (`AnimalModel.save_results`, `AnimalModel.py:650-656`)
        fl3 = np.concatenate([fl, np.zeros_like(fl[:, :, :1])], 2) + 0.5
        return np.clip(fl3, 0.0, 1.0)

    flow_gt = batch.get("flows")
    flow_gt = None if flow_gt is None else flow_viz(_np(flow_gt))
    flow_pred = aux.get("flow_pred")
    flow_pred = None if flow_pred is None else flow_viz(_np(flow_pred))

    for b in range(B):
        for f in range(F):
            i = start_index + b
            prefix = os.path.join(out_dir, f"{i:07d}_{f:02d}")
            save_image(prefix + "_input_image.png", images[b, f])
            save_image(prefix + "_mask_gt.png", masks[b, f])
            save_image(prefix + "_mask_pred.png", mask_pred[b, f][None])
            save_image(prefix + "_image_pred.png", image_pred[b, f])
            if flow_gt is not None and f < flow_gt.shape[1]:
                save_image(prefix + "_flow_gt.png", flow_gt[b, f])
            if flow_pred is not None and f < flow_pred.shape[1]:
                save_image(prefix + "_flow_pred.png", flow_pred[b, f])
            # deform/articulation off → batch-1 prior shape shared by all
            n = min(b * F + f, verts_all.shape[0] - 1)
            save_obj(prefix + "_mesh.obj", verts_all[n], faces,
                     v_valid, f_valid)
            save_txt(prefix + "_pose.txt", pose[n:n + 1])
            if arti is not None:
                save_txt(prefix + "_articulation.txt", arti[b, f])
