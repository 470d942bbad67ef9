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
