"""The host side of the port's CUDA kernels: one library built from every
`csrc/*.cu` with one nvcc call (`build`), loaded with ctypes and typed from
one table of its exported functions (`library`, `SIGNATURES`), a launch on
the current stream with its cudaError checked (`launch`, `check_error`),
and the check of the tensors a wrapper hands to a kernel
(`check_tensors`).

The kernel modules (`rasterize_cuda`, `resolve_cuda`, `fused_mlp`) import
this module at their top; it imports nothing of the port. Importing it
builds nothing and needs no nvcc: the library is built at the first
`library()` call, into `_build/`, and kept there under a hash of the flags
and the sources.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
# Every function the library exports: name → (argtypes, restype). A
# `*_launch` takes its kernel's arguments, then the stream, and returns a
# cudaError; a `*_smem` returns the shared memory a block of its kernel
# takes at those sizes.
SIGNATURES = {
    "cull_boxes_launch": ([_P] * 3 + [_I32] * 6 + [_P], _I32),
    "raster_vis_launch": ([_P] * 10 + [_I32] * 9 + [_P], _I32),
    "raster_vis_smem": ([_I32] * 3, _I64),
    "raster_vis_v4_launch": ([_P] * 10 + [_I32] * 9 + [_P], _I32),
    "raster_vis_v4_smem": ([_I32] * 3, _I64),
    "raster_vis_v6_launch": ([_P] * 10 + [_I32] * 11 + [_P], _I32),
    "raster_vis_v6_smem": ([_I32] * 5, _I64),
    "fused_mlp_fwd_bf16_launch": ([_P] * 5 + [_I64] + [_I32] * 3 + [_P],
                                  _I32),
    "fused_mlp_fwd_f32_launch": ([_P] * 6 + [_I64] + [_I32] * 3 + [_P],
                                 _I32),
    "fused_mlp_bwd_f32_launch": ([_P] * 9 + [_I64] + [_I32] * 3 + [_P],
                                 _I32),
    "fused_mlp_bwd_chain_launch": ([_P] * 7 + [_I64] * 3 + [_I32] * 4 + [_P],
                                   _I32),
    "fused_mlp_bwd_wgrad_launch": ([_P] * 2 + [_I64] * 2 + [_I32] * 4 + [_P],
                                   _I32),
    "fused_mlp_bwd_reduce_launch": ([_P, _I32, _P, _I32, _P, _I32, _I32, _P],
                                    _I32),
    "resolve_bwd_launch": ([_P] * 3 + [_I32] * 5 + [_P], _I32),
    "resolve_fwd_launch": ([_P] * 3 + [_I32] * 5 + [_P], _I32),
}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def _sources(suffixes=(".cu",)) -> list:
    """Every kernel source of the package (with `(".cu", ".cuh")`, the
    headers they include too), in a fixed order."""
    csrc = os.path.join(_PKG_DIR, "csrc")
    return [os.path.join(csrc, n) for n in sorted(os.listdir(csrc))
            if n.endswith(suffixes)]


def library_path() -> str:
    """The library's path in `BUILD_DIR`, named by a hash of the compiler
    flags and of every source and header, so that an edit of any builds
    anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources((".cu", ".cuh")):
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile every `csrc/*.cu` into one shared library with a single nvcc
    call (its sources compiled in parallel) unless it is already built.
    Returns the compiler's output (register and shared-memory use).

    nvcc writes to a temporary file of its own in `BUILD_DIR`, renamed into
    place when whole and removed when nvcc fails, so that processes that
    build at once (the ranks of one job on a fresh checkout) neither read a
    half-written library nor lose each other's file."""
    out = library_path()
    if os.path.exists(out):
        return ""
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(out) + ".",
                               suffix=".tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "--threads", "0", "-o",
                               tmp, *_sources()],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {out}:\n{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout


_LIB = None


def library():
    """The loaded kernel library (built at first use), each function in
    `SIGNATURES` typed."""
    global _LIB
    if _LIB is None:
        build()
        lib = ctypes.CDLL(library_path())
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


def check_error(name, err):
    """Raise RuntimeError naming kernel `name` if its launch function
    returned a cudaError other than 0."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def launch(fn, name, *args):
    """Call the launch function `fn` of the library with `args` (tensors as
    their data pointers) and the current stream of args[0]'s device, which
    must be a tensor's; `check_error` under `name`."""
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    check_error(name, err)


def check_tensors(tensors, device):
    """tensors: name → (tensor, dtype, shape); each must match, be
    contiguous and lie on `device`. Raises ValueError naming the first that
    does not."""
    for name, (t, dtype, shape) in tensors.items():
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")
