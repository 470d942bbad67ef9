"""Fused CoordMLP lattice sweep: hand-written CUDA kernels for Hopper
(`csrc/fused_mlp.cu`) and their plain PyTorch versions.

Port of the Pallas kernels `_fwd_kernel` and `_bwd_kernel`
(`animals3d_tpu/ops/fused_mlp.py:59,76`, called through `mlp_sweep`). The
netSDF trunk — in-layer + bias, relu, L-1 bias-free 256-wide layers with a
relu between them, a final 256 → 1 layer — is evaluated at every row of
the embedded lattice (2.1M rows at grid 128) with a tile of rows resident
in shared memory across all layers, so no (N, 256) activation reaches
device memory; the backward recomputes the activations per tile and
accumulates the weight gradients.

Numerics (the Pallas kernels'): operands in the compute type of the
precision policy, float32 accumulation, every layer's output rounded to
the compute type. The kernels are bound by operations (tensor cores in
bf16); see the note in the source for the design.

Positions are not differentiated: `mlp_sweep` raises if the embedded input
requires grad. The Function has no double backward; the eikonal term goes
through the plain `CoordMLP`.

On CPU tensors the wrappers run the plain versions; on CUDA tensors they
launch the kernels or raise.
"""
from __future__ import annotations

import torch

from animals3d_tpu_torch.precision import compute_dtype

NF = 256             # hidden width the kernels are written for
KPAD = 64            # the input width is zero-padded to a multiple of this
NUM_BLOCKS = 132     # fixed grid: one block per SM of an H100
_PLAIN_ROWS = 1 << 18


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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


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
    from animals3d_tpu_torch.ops.rasterize_cuda import library
    lib = library()
    N, dp = e.shape
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    with torch.cuda.device(dev):
        err = lib.fused_mlp_fwd_launch(
            e.data_ptr(), win.data_ptr(), b.data_ptr(), ws.data_ptr(),
            wlast.data_ptr(), out.data_ptr(), N, dp, ws.shape[0] + 1,
            NUM_BLOCKS, int(e.dtype == torch.bfloat16), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mlp_fwd kernel launch failed: cudaError "
                           f"{err}")
    fused_mlp_fwd.launches += 1
    return out


fused_mlp_fwd.launches = 0


def fused_mlp_bwd(e, g, win, b, ws, wlast):
    """Gradients of sum(out · g) with respect to the weights, as
    `fused_mlp_bwd_reference` returns them; g (N,) float32. The CUDA kernel
    for CUDA tensors (a fixed grid and a fixed reduction order: the result
    does not change from run to run), the plain version for CPU tensors.
    Adds one to `fused_mlp_bwd.launches` per kernel launch."""
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
    from animals3d_tpu_torch.ops.rasterize_cuda import library
    lib = library()
    nl = ws.shape[0]
    psz = dp * NF + NF + nl * NF * NF + NF
    out = torch.empty((psz,), dtype=torch.float32, device=dev)
    partial = torch.zeros((NUM_BLOCKS, psz), dtype=torch.float32, device=dev)
    wts = ws.transpose(1, 2).contiguous()
    with torch.cuda.device(dev):
        err = lib.fused_mlp_bwd_launch(
            e.data_ptr(), g.data_ptr(), win.data_ptr(), b.data_ptr(),
            ws.data_ptr(), wts.data_ptr(), wlast.data_ptr(),
            partial.data_ptr(), out.data_ptr(), N, dp, nl + 1, NUM_BLOCKS,
            int(e.dtype == torch.bfloat16), _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_mlp_bwd kernel launch failed: cudaError "
                           f"{err}")
    fused_mlp_bwd.launches += 1
    o0, o1, o2 = dp * NF, dp * NF + NF, dp * NF + NF + nl * NF * NF
    # the kernel accumulates the transposes (rows = output feature)
    return (out[:o0].view(NF, dp).T, out[o0:o1],
            out[o1:o2].view(nl, NF, NF).transpose(1, 2), out[o2:])


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
