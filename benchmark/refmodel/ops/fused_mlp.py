"""The netSDF trunk over the lattice, plain PyTorch.

In-layer + bias, relu, L-1 bias-free 256-wide layers with a relu between
them, a final 256 -> 1 layer, at every row of the embedded lattice, in
blocks of rows, forward and the weights' gradients.

Frozen copy of the plain versions in `animals3d_tpu_torch/ops/fused_mlp.py`
(`fused_mlp_fwd_reference`, `fused_mlp_bwd_reference`, `_Sweep`,
`mlp_sweep`) for the benchmark's reference; the kernels, their weight
stream and their launch plan are taken out. Operands are in the compute
type of the precision policy (`rounded`), products accumulate in float32.
"""
from __future__ import annotations

import torch

from refmodel import probe
from refmodel.precision import compute_dtype, rounded

NF = 256             # hidden width of the trunk
KPAD = 64            # the input width is zero-padded to a multiple of this
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
        ep[:, :d] = rounded(e)
        win = torch.zeros((dp, NF), dtype=cd, device=e.device)
        win[:d] = rounded(in_w.detach()).T
        ws = torch.stack([rounded(w.detach()).T for w in layer_ws[:-1]]) \
            .contiguous()
        wlast = rounded(layer_ws[-1].detach()[0]).contiguous()
        b = in_b.detach().float().contiguous()
        ctx.save_for_backward(ep, win, b, ws, wlast)
        ctx.d = d
        probe.record("sweep_fwd", N=e.shape[0], d=d, dp=dp,
                     L=len(layer_ws))
        return fused_mlp_fwd_reference(ep, win, b, ws, wlast)

    @staticmethod
    def backward(ctx, g):
        ep, win, b, ws, wlast = ctx.saved_tensors
        probe.record("sweep_bwd", N=ep.shape[0], d=ctx.d, dp=ep.shape[1],
                     L=ws.shape[0] + 1)
        dwin, db, dws, dwlast = fused_mlp_bwd_reference(
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
