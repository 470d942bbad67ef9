"""Data parallelism over `torch.distributed` (the port's counterpart of
`animals3d_tpu.parallel.mesh`).

The JAX package shards the batch over a `dp` mesh axis and lets XLA insert
the gradient sum. Here each rank is one process driving one device, with
its `batch_size // world` slice of the global batch (the loaders' stride,
`data/loaders.py`). After `backward` the trained parameters' gradients are
averaged over the ranks in one flat buffer per dtype (`all_reduce_grads`),
before any optimizer step; the loss is a per-sample mean, so the average
is the gradient of the global batch's loss. The few batch-wide values of
the forward (Fauna's bank mean) go through `all_reduce_mean`, whose
backward averages too, and the random draws of per-sample sites are made
for the global batch from the generator every rank shares, each rank
keeping its own rows (`local_rows`, used by `noise`). Metrics are averaged
for logging (`all_reduce_metrics`); checkpoints, logs and archives are
written by rank 0 (`is_main`), and the visuals it logs come from a
forward of its own rows alone (`local_only`: the JAX trainer's
`_host_local_value` keeps the main host's rows of the global batch).

`torch.nn.parallel.DistributedDataParallel` is not used: netArticulation
and netDeform are switched on by phase, so its bucket hooks would need
`find_unused_parameters`; one flat reduction after `backward` gives the
same average with none of that.

`init_distributed(device)` starts the group from torchrun's environment
(`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) or, with
`store`, from a `FileStore` path (tests, the smoke script): NCCL on CUDA,
gloo on the CPU. Without a group every function here is the one-process
identity.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
from torch.autograd.graph import increment_version

_LOCAL = [False]       # inside `local_only`: no collectives, one rank
_GROUP = [None]        # the first `dp` ranks, where fewer than the world


def active() -> bool:
    """Whether a process group is up and collectives run."""
    return dist.is_available() and dist.is_initialized() and not _LOCAL[0]


def rank() -> int:
    """This process's rank in the data-parallel group (-1 outside it)."""
    return dist.get_rank(_GROUP[0]) if active() else 0


def world_size() -> int:
    """The data-parallel width (-1 outside the group)."""
    return dist.get_world_size(_GROUP[0]) if active() else 1


def is_main() -> bool:
    return rank() == 0


def ranks() -> int:
    """Every process of the group, whatever the data-parallel width."""
    return dist.get_world_size() if active() else 1


def in_group() -> bool:
    return rank() >= 0


def set_width(dp: int) -> None:
    """Make the data-parallel group the first `dp` ranks (all of them
    where `dp` is the world size). Every rank must call it."""
    if not active():
        return
    _GROUP[0] = None if dp == dist.get_world_size() else \
        dist.new_group(list(range(dp)))


def init_distributed(device="cuda", store: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device
    (`cuda:LOCAL_RANK` on CUDA). Rank and size come from `rank` /
    `world_size` where given, else from torchrun's `RANK` / `WORLD_SIZE`;
    the rendezvous is the `FileStore` at `store` where given, else
    torchrun's `MASTER_ADDR` / `MASTER_PORT`. The backend is NCCL on CUDA
    (an error where it is missing, never a fallback) and gloo on the
    CPU. A group already up is kept."""
    device = torch.device(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    r = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    w = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None \
        else int(world_size)
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend")
        backend = "nccl"
    else:
        backend = "gloo"
    kw = {}
    if store is not None:
        kw["store"] = dist.FileStore(store, w)
    else:
        kw["init_method"] = "env://"
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(backend, rank=r, world_size=w, **kw)
    return device


def shutdown():
    """Leave the process group, where one is up."""
    _GROUP[0] = None
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def local_only():
    """Inside the block this process acts as the only rank: no
    collective, rank 0 of 1 (a forward that one rank runs alone, such as
    the main rank's visual logging)."""
    old, _LOCAL[0] = _LOCAL[0], True
    try:
        yield
    finally:
        _LOCAL[0] = old


def dp_size(mesh_shape, batch_size: int, world: int) -> int:
    """The data-parallel width: `mesh_shape`'s `dp` where given (at most
    `world`), else every rank, or, where the batch does not divide over
    them, the largest width that divides it (the JAX trainer's rule)."""
    if mesh_shape:
        (axis, n), = dict(mesh_shape).items()
        if axis != "dp":
            raise ValueError(f"mesh_shape {mesh_shape}: only a dp axis")
        if int(n) > world:
            raise ValueError(f"mesh_shape {mesh_shape}: {world} ranks")
        return int(n)
    if batch_size % world:
        dp = math.gcd(world, batch_size)
        print(f"dp {world} does not divide batch {batch_size}; using "
              f"dp={dp}")
        return dp
    return world


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows of `x`, drawn for the global batch along `dim`:
    the global batch is the ranks' local batches in rank order."""
    w = world_size()
    if w == 1:
        return x
    n = x.shape[dim] // w
    return x.narrow(dim, rank() * n, n)


class _AllReduceMean(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        y = x.detach().clone()
        dist.all_reduce(y, group=_GROUP[0])
        return y / world_size()

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=_GROUP[0])
        return g / world_size()


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x` over the ranks, differentiable: its backward
    averages the incoming gradients over the ranks as well, so that each
    rank's share of the global loss reaches every rank's input."""
    if not active():
        return x
    return _AllReduceMean.apply(x)


def all_reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Average every parameter's gradient over the ranks (zeros where
    `.grad` is None), one flat buffer per dtype; every parameter leaves
    with a gradient."""
    if not active():
        return
    w = world_size()
    by_dtype = {}
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([p.grad.reshape(-1) for p in ps])
        dist.all_reduce(flat, group=_GROUP[0])
        flat /= w
        for p, g in zip(ps, flat.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def all_reduce_metrics(metrics: dict) -> dict:
    """The scalar tensors of `metrics` averaged over the ranks (the global
    batch's means, as the JAX trainer's jit sees them); other entries as
    they are."""
    if not active():
        return metrics
    keys = sorted(k for k, v in metrics.items()
                  if torch.is_tensor(v) and v.ndim == 0)
    if not keys:
        return metrics
    vals = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(vals, group=_GROUP[0])
    vals /= world_size()
    return {**metrics, **dict(zip(keys, vals.unbind()))}


def broadcast_params(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank. Each tensor's
    version moves, as after any in-place write, so that what is kept
    from the old values (netBase's eval prior) is made anew."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=_GROUP[0])
            increment_version(t)

