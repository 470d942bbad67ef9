"""Fused CoordMLP lattice sweep: hand-written CUDA kernels for Hopper
(`csrc/fused_mlp.cu`) and their plain PyTorch versions.

Port of the Pallas kernels `_fwd_kernel` and `_bwd_kernel`
(`animals3d_tpu/ops/fused_mlp.py:59,76`, called through `mlp_sweep`). The
netSDF trunk — in-layer + bias, relu, L-1 bias-free 256-wide layers with a
relu between them, a final 256 → 1 layer — is evaluated at every row of
the embedded lattice (2.1M rows at grid 128) without any (N, 256)
activation of the whole lattice in device memory.

Forward (`fused_mlp_fwd`): one kernel, a tile of rows resident in shared
memory across all layers. Backward (`fused_mlp_bwd`), bf16: per chunk of
at most `CHUNK_ROWS` rows (`bwd_plan`), a chain pass recomputes the
activations per 128-row tile, walks the cotangent back and writes the bf16
operands of the weight gradients and the input rows (4.7 KB per row) to a
scratch reused from chunk to chunk (305 MiB at the default C = 67,584
rows), then a weight-gradient pass multiplies them out as GEMMs over the
chunk's rows into fixed per-block float32 partials; one reduce sums the
partials in a fixed order. Both passes run on the tensor cores (wgmma)
from shared memory; the chain pass reads the weights as `weight_stream`
lays them out.
float32: one kernel with per-block partials and its reduce (the first
design; the float32 policy's references only). The kernels are bound by
operations: 2·N·(D·256 + (L-1)·256² + 256) forward and about three times
that backward, 1.20 and 3.53 ms in bf16 on an H100 at full width.

Numerics (the Pallas kernels'): operands in the compute type of the
precision policy, float32 accumulation, every layer's output and every
masked cotangent rounded to the compute type. Two calls give the same
bits: every sum has a fixed order and no float atomics.

Positions are not differentiated: `mlp_sweep` raises if the embedded input
requires grad. The Function has no double backward; the eikonal term goes
through the plain `CoordMLP`.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from animals3d_tpu_torch.precision import compute_dtype

NF = 256             # hidden width the kernels are written for
KPAD = 64            # the input width is zero-padded to a multiple of this
NUM_BLOCKS = 132     # fixed grid: one block per SM of an H100
TILE_ROWS = 128      # rows per tile of the bf16 chain pass
# rows per chunk: 4 tiles per block of the chain pass (the scratch, 305
# MiB, stays under 512 MiB; fewer, larger chunks cut the partials'
# read-modify-write and the launches, 32 chunks at full width)
CHUNK_ROWS = 4 * NUM_BLOCKS * TILE_ROWS
WGRAD_SPLITS = 14    # row splits per weight-gradient tile (9 x 14 blocks)
_PLAIN_ROWS = 1 << 18


@dataclass(frozen=True)
class BwdPlan:
    """`bwd_plan`'s result. chunks: (first row, rows) per chunk; C: rows
    per chunk (the scratch's plane height); plane_offsets: the element
    offset of each scratch plane; scratch_elems; chain_blocks: the chain
    pass's grid; splits: the weight-gradient pass's row splits."""
    chunks: tuple
    C: int
    plane_offsets: tuple
    scratch_elems: int
    chain_blocks: int
    splits: int


def _check(e, win, b, ws, wlast):
    cd = e.dtype
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute type {cd} is not float32 or bfloat16")
    dp = e.shape[1]
    if e.ndim != 2 or dp % KPAD:
        raise ValueError(f"e: want (N, multiple of {KPAD}), got "
                         f"{tuple(e.shape)}")
    want = {"win": (win, cd, (dp, NF)), "b": (b, torch.float32, (NF,)),
            "ws": (ws, cd, (ws.shape[0], NF, NF)),
            "wlast": (wlast, cd, (NF,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("e", e), ("win", win), ("b", b), ("ws", ws),
                    ("wlast", wlast)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != e.device:
            raise ValueError(f"{name} is on {t.device}, e on {e.device}")


def _acts(e, win, b, ws):
    """a_0 .. a_{L-1} of a block of rows, rounded as the kernels round."""
    cd = e.dtype
    a = torch.relu((e @ win) + b.to(cd))
    acts = [a]
    for w in ws:
        a = torch.relu(a @ w)
        acts.append(a)
    return acts


def fused_mlp_fwd_reference(e, win, b, ws, wlast):
    """Plain PyTorch version of `fused_mlp_fwd`, in blocks of rows."""
    _check(e, win, b, ws, wlast)
    out = []
    for r0 in range(0, e.shape[0], _PLAIN_ROWS):
        a = _acts(e[r0:r0 + _PLAIN_ROWS], win, b, ws)[-1]
        out.append((a @ wlast[:, None])[:, 0].float())
    return torch.cat(out) if out else e.new_zeros((0,), dtype=torch.float32)


def fused_mlp_bwd_reference(e, g, win, b, ws, wlast):
    """Plain PyTorch version of `fused_mlp_bwd`: the float32 gradients
    (dwin (DP, 256), db (256,), dws (L-1, 256, 256), dwlast (256,)) of
    sum(out · g). Products take the rounded operands in float32."""
    _check(e, win, b, ws, wlast)
    cd = e.dtype
    f32 = torch.float32
    dwin = torch.zeros(win.shape, dtype=f32, device=e.device)
    db = torch.zeros((NF,), dtype=f32, device=e.device)
    dws = torch.zeros(ws.shape, dtype=f32, device=e.device)
    dwlast = torch.zeros((NF,), dtype=f32, device=e.device)
    for r0 in range(0, e.shape[0], _PLAIN_ROWS):
        eb = e[r0:r0 + _PLAIN_ROWS]
        acts = _acts(eb, win, b, ws)
        gd = g[r0:r0 + _PLAIN_ROWS].to(cd).float()
        a = acts[-1].float()
        dwlast += a.T @ gd
        d = torch.where(a > 0, gd[:, None] * wlast.float()[None, :],
                        torch.zeros_like(a)).to(cd)
        for li in range(ws.shape[0] - 1, -1, -1):
            a = acts[li].float()
            dws[li] += a.T @ d.float()
            da = d.float() @ ws[li].float().T
            d = torch.where(a > 0, da, torch.zeros_like(da)).to(cd)
        dwin += eb.float().T @ d.float()
        db += d.float().sum(0)
    return dwin, db, dws, dwlast


def fused_mlp_fwd(e, win, b, ws, wlast):
    """Trunk output (N,) float32 for embedded rows e (N, DP).

    e, win (DP, 256), ws (L-1, 256, 256) and wlast (256,) are in the
    compute type with rows = input feature; b (256,) is float32. The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Adds one to
    `fused_mlp_fwd.launches` per kernel launch."""
    dev = e.device
    if dev.type == "cpu":
        return fused_mlp_fwd_reference(e, win, b, ws, wlast)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(e, win, b, ws, wlast)
    from animals3d_tpu_torch.ops.rasterize_cuda import _launch, library
    N, dp = e.shape
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    _launch("fused_mlp_fwd", library().fused_mlp_fwd_launch, e, win, b, ws,
            wlast, out, N, dp, ws.shape[0] + 1, NUM_BLOCKS,
            int(e.dtype == torch.bfloat16))
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def bwd_plan(N: int, L: int, dp: int = KPAD,
             chunk_rows: int = CHUNK_ROWS) -> BwdPlan:
    """How the bf16 backward walks N rows of an L-layer trunk with inputs
    of width dp: chunks of at most C rows (C = `chunk_rows`, cut to N
    rounded up to a tile when N is smaller), each run by one chain-pass
    launch and one weight-gradient launch through one scratch, reused from
    chunk to chunk: 2L - 1 planes (C, 256) bf16 (a_0 .. a_{L-2}, d_0 ..
    d_{L-1}) and one (C, dp) plane of the input rows. Pure: no tensor, no
    device."""
    if chunk_rows <= 0 or chunk_rows % TILE_ROWS:
        raise ValueError(f"chunk_rows {chunk_rows}: want a positive "
                         f"multiple of {TILE_ROWS}")
    if N < 0 or L < 2:
        raise ValueError(f"N {N}, L {L}")
    C = min(chunk_rows, -(-N // TILE_ROWS) * TILE_ROWS)
    chunks = tuple((r0, min(C, N - r0)) for r0 in range(0, N, C or 1))
    offsets = tuple(p * C * NF for p in range(2 * L))
    chain_blocks = min(NUM_BLOCKS, C // TILE_ROWS) if C else 0
    return BwdPlan(chunks, C, offsets, offsets[-1] + C * dp, chain_blocks,
                   WGRAD_SPLITS)


SLICE_ROWS = 32      # rows of a weight matrix per slice of the stream


def slice_layout() -> torch.Tensor:
    """Where element (k, n) of a (32, 256) weight slice sits in the chain
    pass's shared-memory image of it: wgmma's MN-major layout with the
    128-byte swizzle (atoms of 8 rows x 64 columns, 1024 bytes; the 16-byte
    chunk j of atom row i at chunk j ^ i). (8192,) int64, row-major (k, n)."""
    k = torch.arange(SLICE_ROWS)[:, None]
    n = torch.arange(NF)[None, :]
    return ((k >> 3) * (8 * NF) + (n >> 6) * 512 + (k & 7) * 64
            + ((((n >> 3) & 7) ^ (k & 7)) << 3) + (n & 7)).reshape(-1)


@functools.lru_cache(maxsize=None)
def _slice_gather(device) -> torch.Tensor:
    """The slice element that lands at each position of the image."""
    return torch.argsort(slice_layout()).to(device)


def weight_stream(win, ws) -> torch.Tensor:
    """The weights in the order the chain pass reads them — win, ws[0 ..
    L-2] (recomputed forward), ws[L-2 .. 0]^T (the cotangent's way back) —
    cut into (32, 256) slices, each in its shared-memory image
    (`slice_layout`), so that one bulk copy brings a slice. A layout
    change of 0.5 MB; no arithmetic."""
    rows = torch.cat([win.reshape(-1, SLICE_ROWS * NF),
                      ws.reshape(-1, SLICE_ROWS * NF),
                      ws.flip(0).transpose(1, 2).reshape(-1, SLICE_ROWS * NF)])
    return rows.index_select(1, _slice_gather(win.device))


class BwdRun:
    """The device work of one bf16 `fused_mlp_bwd` call on a plan: its
    buffers, and one launch function per pass (`chain(i)` and `wgrad(i)`
    for chunk i, `reduce()`), each one kernel on the current stream."""

    def __init__(self, e, g, win, b, ws, wlast, plan):
        from animals3d_tpu_torch.ops.rasterize_cuda import library
        dev = e.device
        self.plan, self.lib = plan, library()
        N, self.dp = e.shape
        self.L = ws.shape[0] + 1
        self.psz = self.dp * NF + NF + (self.L - 1) * NF * NF + NF
        self.out = torch.empty((self.psz,), dtype=torch.float32, device=dev)
        self.scratch = torch.empty((plan.scratch_elems,), dtype=e.dtype,
                                   device=dev)
        self.part = torch.empty((plan.splits, self.psz), dtype=torch.float32,
                                device=dev)
        self.part2 = torch.empty((plan.chain_blocks, 2 * NF),
                                 dtype=torch.float32, device=dev)
        self.wstream = weight_stream(win, ws)
        with torch.cuda.device(dev):
            self.stream = torch.cuda.current_stream(dev).cuda_stream
        self.chain_args = [t.data_ptr() for t in (e, g, self.wstream, b,
                                                  wlast, self.scratch,
                                                  self.part2)]

    def _check(self, name, err):
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")

    def chain(self, i):
        r0, rows = self.plan.chunks[i]
        self._check("fused_mlp_bwd_chain", self.lib.fused_mlp_bwd_chain_launch(
            *self.chain_args, r0, rows, self.plan.C, self.dp, self.L,
            self.plan.chain_blocks, int(i == 0), self.stream))

    def wgrad(self, i):
        _r0, rows = self.plan.chunks[i]
        self._check("fused_mlp_bwd_wgrad", self.lib.fused_mlp_bwd_wgrad_launch(
            self.scratch.data_ptr(), self.part.data_ptr(), rows, self.plan.C,
            self.dp, self.L, self.plan.splits, int(i == 0), self.stream))

    def reduce(self):
        self._check("fused_mlp_bwd_reduce",
                    self.lib.fused_mlp_bwd_reduce_launch(
                        self.part.data_ptr(), self.plan.splits,
                        self.part2.data_ptr(), self.plan.chain_blocks,
                        self.out.data_ptr(), self.dp, self.L, self.stream))

    def launches(self) -> int:
        """Device launches of one call: two per chunk and the reduce."""
        return 2 * len(self.plan.chunks) + 1


def _grads(out, dp, nl):
    """dwin, db, dws, dwlast from the kernels' layout (the transposes,
    rows = output feature)."""
    o0, o1, o2 = dp * NF, dp * NF + NF, dp * NF + NF + nl * NF * NF
    return (out[:o0].view(NF, dp).T, out[o0:o1],
            out[o1:o2].view(nl, NF, NF).transpose(1, 2), out[o2:])


def fused_mlp_bwd(e, g, win, b, ws, wlast):
    """Gradients of sum(out · g) with respect to the weights, as
    `fused_mlp_bwd_reference` returns them; g (N,) float32. The CUDA
    kernels for CUDA tensors, the plain version for CPU tensors. bf16: the
    chain pass and the weight-gradient pass per chunk of at most
    `CHUNK_ROWS` rows (`bwd_plan`), then the reduce; float32: one kernel and
    its reduce.
    Both have a fixed grid and a fixed reduction order: the result does
    not change from run to run. Adds one to `fused_mlp_bwd.launches` per
    call that launches kernels."""
    dev = e.device
    if dev.type == "cpu":
        return fused_mlp_bwd_reference(e, g, win, b, ws, wlast)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check(e, win, b, ws, wlast)
    N, dp = e.shape
    if g.dtype != torch.float32 or tuple(g.shape) != (N,) \
            or not g.is_contiguous() or g.device != dev:
        raise ValueError(f"g: want contiguous float32 ({N},) on {dev}")
    from animals3d_tpu_torch.ops.rasterize_cuda import _launch, library
    nl = ws.shape[0]
    if e.dtype == torch.bfloat16:
        plan = bwd_plan(N, nl + 1, dp, CHUNK_ROWS)
        if not plan.chunks:
            return _grads(torch.zeros((dp * NF + NF + nl * NF * NF + NF,),
                                      dtype=torch.float32, device=dev),
                          dp, nl)
        run = BwdRun(e, g, win, b, ws, wlast, plan)
        for i in range(len(plan.chunks)):
            run.chain(i)
            run.wgrad(i)
        run.reduce()
        fused_mlp_bwd.launches += 1
        return _grads(run.out, dp, nl)
    psz = dp * NF + NF + nl * NF * NF + NF
    out = torch.empty((psz,), dtype=torch.float32, device=dev)
    partial = torch.zeros((NUM_BLOCKS, psz), dtype=torch.float32, device=dev)
    wts = ws.transpose(1, 2).contiguous()
    _launch("fused_mlp_bwd", library().fused_mlp_bwd_f32_launch, e, g, win,
            b, ws, wts, wlast, partial, out, N, dp, nl + 1, NUM_BLOCKS)
    fused_mlp_bwd.launches += 1
    return _grads(out, dp, nl)


fused_mlp_bwd.launches = 0


class _Sweep(torch.autograd.Function):
    """The trunk over every row of e, differentiable in the weights only.
    Inputs are the float32 parameters in `nn.Linear` layout; the casts to
    the compute type happen inside, so autograd stores nothing of size
    (N, 256)."""

    @staticmethod
    def forward(ctx, e, in_w, in_b, *layer_ws):
        cd = compute_dtype()
        d = in_w.shape[1]
        dp = -(-d // KPAD) * KPAD
        ep = torch.zeros((e.shape[0], dp), dtype=cd, device=e.device)
        ep[:, :d] = e
        win = torch.zeros((dp, NF), dtype=cd, device=e.device)
        win[:d] = in_w.detach().T
        ws = torch.stack([w.detach().T for w in layer_ws[:-1]]).to(cd) \
            .contiguous()
        wlast = layer_ws[-1].detach()[0].to(cd).contiguous()
        b = in_b.detach().float().contiguous()
        ctx.save_for_backward(ep, win, b, ws, wlast)
        ctx.d = d
        return fused_mlp_fwd(ep, win, b, ws, wlast)

    @staticmethod
    def backward(ctx, g):
        ep, win, b, ws, wlast = ctx.saved_tensors
        dwin, db, dws, dwlast = fused_mlp_bwd(
            ep, g.float().contiguous(), win, b, ws, wlast)
        grads = [dwin[:ctx.d].T, db] + [dw.T for dw in dws] + [dwlast[None]]
        return (None, *grads)


def coordmlp_sweep_params_ok(net, num_layers: int) -> bool:
    """Gate: the kernels cover the shipped netSDF shape — a `CoordMLP` with
    no conditioning whose trunk is 256-wide, bias-free and ends in one
    output."""
    mlp = getattr(net, "mlp", None)
    if mlp is None or getattr(net, "extra_feat_dim", 0) or num_layers < 2 \
            or getattr(mlp, "num_layers", None) != num_layers:
        return False
    if net.in_layer.weight.shape[0] != NF or net.in_layer.bias is None:
        return False
    for i in range(num_layers - 1):
        if tuple(getattr(mlp, f"layer_{i}").weight.shape) != (NF, NF):
            return False
    return tuple(getattr(mlp, f"layer_{num_layers - 1}").weight.shape) \
        == (1, NF)


def mlp_sweep(net, e, *, num_layers: int) -> torch.Tensor:
    """Evaluate the trunk of the `CoordMLP` `net` (in_layer + bias-free
    MLP, one output) at every row of the embedded input e (N, D). Returns
    (N,) float32, the raw MLP output. Differentiable with respect to the
    parameters only: an input that requires grad raises."""
    if e.requires_grad:
        raise ValueError(
            "mlp_sweep does not differentiate its input: the lattice "
            "positions must not require grad (use CoordMLP for that)")
    if not coordmlp_sweep_params_ok(net, num_layers):
        raise ValueError("mlp_sweep covers the 256-wide unconditional "
                         "CoordMLP trunk with one output only")
    layer_ws = [getattr(net.mlp, f"layer_{i}").weight
                for i in range(num_layers)]
    return _Sweep.apply(e, net.in_layer.weight, net.in_layer.bias, *layer_ws)
