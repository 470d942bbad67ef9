"""What the entries share: the seeds, the device's clock and memory, and
the weights' hand-over."""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch


def seeds(seed: int, n: int = 4) -> list:
    """`n` independent 32-bit seeds from the run's seed (any integer)."""
    entropy = int(seed) % 2 ** 64
    return [int(s) for s in
            np.random.SeedSequence(entropy).generate_state(n, np.uint32)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def float32_numerics() -> None:
    """float32 stays float32: TF32 off for matrix products and cuDNN
    convolutions, in the program and in the reference alike. The
    configurations state float32 for what is not a bf16 matmul (the ViT's
    patch embedding, the discriminator, geometry); PyTorch's default lets
    cuDNN take float32 convolutions in TF32, and the program does not
    turn that off itself. So every cell times the program with TF32 off,
    as the configurations state, and not as its command line leaves it
    (cuDNN's TF32 on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def host_state(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def flop_counter():
    """A FLOP counter over the aten operations run inside it
    (`get_total_flops()`), with torch's table of counted operations
    (`torch.utils.flop_counter.flop_registry`: matrix products,
    convolutions, attention). Unlike `FlopCounterMode` it tracks no module
    hierarchy, whose backward hooks `torch.autograd.grad` refuses (the
    discriminator's R1 penalty calls it)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            count = flop_registry.get(func._overloadpacket)
            if count is None:
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if count is not None:
                self.total += int(count(*args, **kwargs, out_val=out))
            return out

        def get_total_flops(self) -> int:
            return self.total
    return FlopCount()


@contextlib.contextmanager
def counting(records: list):
    """Count what the block runs of the reference: its model FLOPs (added
    to `records` as ("flops", {"total": n}) at the end) and the shapes its
    probes record (`refmodel.probe`), a rasterization reduced at once to
    K1's bound ("raster_ms")."""
    from harness import bounds
    from refmodel import probe

    def sink(kind, f):
        if kind == "raster":
            records.append(("raster_ms", {"ms": bounds.visibility_ms(**f)}))
        else:
            records.append((kind, f))
    counter = flop_counter()
    probe.SINK = sink
    try:
        with counter:
            yield
    finally:
        probe.SINK = None
    records.append(("flops", {"total": counter.get_total_flops()}))


def counted_flops(records: list) -> int:
    return sum(f["total"] for kind, f in records if kind == "flops")
