"""Mixed-precision policy, mirroring `animals3d_tpu.precision`.

Matmul-like layers (the `Dense`/`Conv` wrappers of `networks`) compute in
`compute_dtype()` while parameters stay float32; networks cast their
outputs back to float32 at their boundaries. Geometry, rasterization and
shading stay float32. The policy is set once from the run config's
`mixed_precision` key ("bf16" | "fp16" | false).
"""
from __future__ import annotations

import torch

_COMPUTE_DTYPE = torch.float32


def set_mixed_precision(mode) -> None:
    global _COMPUTE_DTYPE
    if mode in (None, False, "false", "none", "no"):
        _COMPUTE_DTYPE = torch.float32
    elif mode in ("bf16", "bfloat16", True, "fp16", "float16"):
        # fp16 configs map to bf16: float32 range, no loss scaling
        _COMPUTE_DTYPE = torch.bfloat16
    else:
        raise ValueError(f"unknown mixed_precision mode: {mode!r}")


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE
