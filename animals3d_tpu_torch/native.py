"""ctypes loader for the native C++ preprocessing library (port of
`animals3d_tpu.native`).

Builds the repository's `native/preprocess.cpp` with g++ on first use into
`animals3d_tpu_torch/_build/` (named by a hash of the source; written to a
temporary name and renamed, so concurrent processes do not read a half
written library), and exposes numpy-facing wrappers. Each returns None
when no compiler or source is available: callers keep their Python paths.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "native", "preprocess.cpp")
_BUILD = os.path.join(_HERE, "_build")
_LIB = None
_TRIED = False


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    lib_path = os.path.join(_BUILD, f"preprocess_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path
    tmp = None
    try:
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, lib_path)
    except (OSError, subprocess.SubprocessError):
        if tmp is not None and os.path.exists(tmp):
            os.remove(tmp)
        return None
    return lib_path


def get_lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build()
        if path:
            lib = ctypes.CDLL(path)
            fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.mask_distance_transform.argtypes = [fp, ctypes.c_int,
                                                    ctypes.c_int, fp, fp]
            lib.decode_packed_feat.argtypes = [u8, ctypes.c_int, ctypes.c_int,
                                               ctypes.c_int, ctypes.c_int, fp]
            lib.resize_bilinear.argtypes = [fp] + [ctypes.c_int] * 5 + [fp]
            _LIB = lib
    return _LIB


def mask_distance_transform(mask: np.ndarray):
    """(1, H, W) or (H, W) float mask → (2, H, W) [dt, inv_dt], or None."""
    lib = get_lib()
    if lib is None:
        return None
    m = np.ascontiguousarray(mask.reshape(mask.shape[-2], mask.shape[-1]),
                             np.float32)
    h, w = m.shape
    dt = np.empty((h, w), np.float32)
    inv = np.empty((h, w), np.float32)
    lib.mask_distance_transform(m, h, w, dt, inv)
    return np.stack([dt, inv])


def decode_packed_feat(img: np.ndarray, n_channels: int):
    lib = get_lib()
    if lib is None:
        return None
    h, tw, c = img.shape
    n_addon = int(np.ceil(n_channels / 3) * 3) - n_channels
    n_tiles = (n_channels + n_addon) // 3
    w = tw // n_tiles
    out = np.empty((n_tiles * 3, h, w), np.float32)
    lib.decode_packed_feat(np.ascontiguousarray(img, np.uint8), h, w,
                           n_tiles, n_tiles * 3, out)
    return out[:n_channels]


def resize_bilinear(arr: np.ndarray, oh: int, ow: int):
    lib = get_lib()
    if lib is None:
        return None
    c, h, w = arr.shape
    out = np.empty((c, oh, ow), np.float32)
    lib.resize_bilinear(np.ascontiguousarray(arr, np.float32), c, h, w,
                        oh, ow, out)
    return out
