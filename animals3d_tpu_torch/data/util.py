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

  * 16-bit flow PNGs decoded by a numpy/zlib PNG codec (`png_read`,
    `png_write`): PIL keeps 8 bits of a 16-bit RGB PNG, and the port does
    not require cv2.

PIL and cv2 are imported inside the functions that use them, so the
package imports without either.
"""
from __future__ import annotations

import struct
import zlib

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


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # gray, RGB, gray-alpha, RGBA


def _png_chunks(data: bytes):
    pos = len(_PNG_SIG)
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _png_unfilter(raw: np.ndarray, h: int, row_bytes: int,
                  bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of a
    non-interlaced image: (h, row_bytes) uint8. A byte depends on its left
    (bpp bytes before), upper and upper-left neighbours, so the rows are
    undone together along anti-diagonals of pixels."""
    rows = raw.reshape(h, row_bytes + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG filter type {int(ftype.max())}")
    x = rows[:, 1:].astype(np.int32).reshape(h, -1, bpp)
    w = x.shape[1]
    out = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row and column
    r_all = np.arange(h)
    for d in range(h + w - 1):
        r = r_all[max(0, d - w + 1):min(h, d + 1)]
        c = d - r
        a = out[r + 1, c]                  # left
        b = out[r, c + 1]                  # up
        cc = out[r, c]                     # upper left
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        f = ftype[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(h, row_bytes).astype(np.uint8)


def png_read(path) -> np.ndarray:
    """A PNG file → (H, W, C) array in the file's channel order (uint8 at
    bit depth 8, uint16 at 16). Grayscale, RGB and their alpha forms,
    non-interlaced; raises ValueError on any other form (palette images,
    depths under 8, interlacing)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, comp, filt, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (8, 16) or comp or filt \
            or interlace:
        raise ValueError(f"{path}: PNG form (depth {depth}, color type "
                         f"{color}, interlace {interlace}) not decoded")
    ch = _PNG_CHANNELS[color]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{w}x{h}x{bpp}")
    img = _png_unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(h, w, ch)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def png_write(path, img: np.ndarray) -> None:
    """(H, W, C) uint8 or uint16 (C 1, 2, 3 or 4) → a non-interlaced PNG,
    every row with filter None."""
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png_write: dtype {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    color = {v: k for k, v in _PNG_CHANNELS.items()}[ch]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(">u2" if depth == 16 else
                                           np.uint8)).view(np.uint8) \
        .reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1).tobytes()
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                  color, 0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw, 6))
                + _png_chunk(b"IEND", b""))


def flow_loader(fpath) -> np.ndarray:
    """16-bit flow png → (2, H, W) in [-1, 1]: the file's R and G samples
    / 65535 · 2 − 1. (The reference reads the file with cv2 in BGR order
    and flips the channels back to RGB, so its first two channels are the
    file's R and G.)"""
    import os
    if not os.path.isfile(fpath):
        raise FileNotFoundError(fpath)
    arr = png_read(fpath).astype(np.float32)
    flow = arr[..., :2] / 65535.0 * 2 - 1
    return np.ascontiguousarray(flow.transpose(2, 0, 1))


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
