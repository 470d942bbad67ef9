"""Dataset utilities for image folders (port of `animals3d_tpu.data.util`).

Reference: `reference model/dataset/util.py`. File-format conventions
preserved exactly:
  * samples are `<stem>rgb.jpg` with siblings `<stem>mask.png`,
    `<stem>box.txt` (8 numbers: frame_id x0 y0 w h full_w full_h sharpness)
    and `<stem>feat<D>.png` (packed-PNG DINO features);
  * distance transforms via the native library, else cv2 L2
    DIST_MASK_PRECISE (`util.py:12-18`), else scipy's exact transform;
  * DINO features packed 3 channels per tile horizontally (`util.py:58-74`);
  * crop-boundary validity mask from the box geometry (`util.py:94-105`).

PIL and cv2 are imported inside the functions that use them, so the
package imports without either.
"""
from __future__ import annotations

import numpy as np

from animals3d_tpu_torch import native


def _resample(name: str):
    from PIL import Image
    return {"bilinear": Image.BILINEAR, "nearest": Image.NEAREST}[name]


def load_image(path, size, mode="RGB", resample="bilinear"):
    """Image file → (C, H, W) float32 in [0, 1], resized to (size, size)
    with `resample` ("bilinear" or "nearest")."""
    from PIL import Image
    img = Image.open(path).convert(mode)
    if img.size != (size, size):
        img = img.resize((size, size), _resample(resample))
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr


def crop_image(path, boxs, size) -> np.ndarray:
    """Crop per-frame boxes [x0, y0, w, h] out of one full-frame image and
    resize each crop to (size, size) → (F, 3, size, size) float in [0, 1]
    (reference `util.py:21-28`: torchvision `resized_crop`, bilinear)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    out = []
    for x0, y0, w, h in np.asarray(boxs, np.int64):
        crop = img.crop((x0, y0, x0 + w, y0 + h)) \
            .resize((size, size), Image.BILINEAR)
        out.append(np.asarray(crop, np.float32).transpose(2, 0, 1) / 255.0)
    return np.stack(out)


def distance_transform_backend() -> str:
    """Which path `compute_distance_transform` takes here: "native",
    "cv2" or "scipy"."""
    if native.get_lib() is not None:
        return "native"
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        return "scipy"


def compute_distance_transform(mask: np.ndarray) -> np.ndarray:
    """(1, H, W) binary → (2, H, W): [dt(mask), dt(1-mask)]."""
    out = native.mask_distance_transform(mask)
    if out is not None:
        return out
    m = (mask[0] > 0.5).astype(np.uint8)
    if distance_transform_backend() == "cv2":
        import cv2
        dt = cv2.distanceTransform(m, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
        inv = cv2.distanceTransform(1 - m, cv2.DIST_L2, cv2.DIST_MASK_PRECISE)
    else:
        from scipy.ndimage import distance_transform_edt
        dt = distance_transform_edt(m)
        inv = distance_transform_edt(1 - m)
    return np.stack([dt, inv], 0).astype(np.float32)


def box_loader(fpath) -> np.ndarray:
    try:
        box = np.loadtxt(fpath, dtype=str)
        box[0] = box[0].split("_")[0]
        return box[:8].astype(np.float32)
    except (FileNotFoundError, OSError):
        # default box: every pixel valid
        return np.array([0, 100, 100, 512, 512, 1920, 1080, 0], np.float32)


def decode_feat_from_img(img: np.ndarray, n_channels: int) -> np.ndarray:
    """Packed-PNG feature decode (`util.py:63-70`): tiles of 3 channels laid
    out horizontally."""
    n_addon = int(np.ceil(n_channels / 3) * 3) - n_channels
    n_tiles = (n_channels + n_addon) // 3
    h, tw, c = img.shape
    w = tw // n_tiles
    feat = img.reshape(h, n_tiles, w, c).transpose(0, 2, 1, 3) \
        .reshape(h, w, n_tiles * c)
    if n_addon:
        feat = feat[:, :, :-n_addon]
    return (feat.astype(np.float32) / 255.0).transpose(2, 0, 1)   # (C,H,W)


def dino_loader(fpath, n_channels: int) -> np.ndarray:
    from PIL import Image
    img = np.asarray(Image.open(fpath))
    out = native.decode_packed_feat(img, n_channels)
    if out is not None:
        return out
    return decode_feat_from_img(img, n_channels)


def get_valid_mask(box: np.ndarray, image_size: int) -> np.ndarray:
    """Pixels of the crop that land inside the full frame, minus a 2% margin
    (`util.py:94-105`). box: (8,) floats."""
    x0, y0, cw, ch, fw, fh = box[1:7].astype(np.int64)
    mh = int(ch * 0.02)
    mw = int(cw * 0.02)
    ys = (np.arange(image_size) + 0.5) / image_size * ch + y0
    xs = (np.arange(image_size) + 0.5) / image_size * cw + x0
    vy = (ys >= mh) & (ys < fh - mh)
    vx = (xs >= mw) & (xs < fw - mw)
    return (vy[:, None] & vx[None, :]).astype(np.float32)


def horizontal_flip_box(box: np.ndarray) -> np.ndarray:
    box = box.copy()
    box[..., 1] = box[..., 5] - box[..., 1] - box[..., 3]
    return box
