"""Device selection: CUDA by default, the CPU only on request."""
from __future__ import annotations

import torch


def get_device(device="cuda") -> torch.device:
    """Resolve `device`; a CUDA request without a usable card raises
    (there is no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


_CACHED = {}


def cached(key, device, make) -> torch.Tensor:
    """The host tensor `make()` builds, on `device`, made once for each
    `key` and device and kept for the process. A constant copied to a CUDA
    device afresh at every call is a copy from pageable memory: it makes the
    host wait for the card, and a CUDA graph cannot capture it. The tensor
    is shared by every caller: never write to it."""
    k = (key, torch.device(device))
    t = _CACHED.get(k)
    if t is None:
        t = _CACHED[k] = make().to(device)
    return t


def constant(values, device, dtype=None) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` of a number or
    nested tuples of numbers, made once (`cached`)."""
    return cached(("constant", repr(values), dtype), device,
                  lambda: torch.tensor(values, dtype=dtype))
