"""Precision policy of the reference, from `animals3d_tpu_torch.precision`.

Matmul-like layers (the `Dense`/`Conv` wrappers of `networks` and the
lattice sweep) take their operands through `rounded`, which casts them to
`compute_dtype()`. The reference runs "float32" (with TF32 off, which the
benchmark sets). "fp8" is the benchmark's control: every such operand is
rounded to float8 e4m3 with a per-tensor scale (its largest magnitude
maps to 448) and the product is taken in float32, the step below the
bfloat16 that the configurations state.
"""
from __future__ import annotations

import torch

_COMPUTE_DTYPE = torch.float32
_FP8 = False
_E4M3_MAX = 448.0


def set_mixed_precision(mode) -> None:
    global _COMPUTE_DTYPE, _FP8
    _FP8 = mode == "fp8"
    if mode in (None, False, "false", "none", "no", "float32", "fp8"):
        _COMPUTE_DTYPE = torch.float32
    elif mode in ("bf16", "bfloat16", True, "fp16", "float16"):
        _COMPUTE_DTYPE = torch.bfloat16
    else:
        raise ValueError(f"unknown mixed_precision mode: {mode!r}")


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def rounded(x: torch.Tensor) -> torch.Tensor:
    """`x` as a matmul operand: in the compute type, or under "fp8" on the
    float8 e4m3 grid of a per-tensor scale (the gradient passes through)."""
    x = x.to(_COMPUTE_DTYPE)
    if not _FP8:
        return x
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())
