"""A function of tensors replayed as CUDA graphs: its forward, and with grad
on its backward, captured once for each key and replayed after.

    graphs = GraphCache("netinstance", module)
    out = graphs(key, fn, (images, mesh, draws))   # None: run fn eagerly

A call returns None, and the caller runs `fn` eagerly, unless its key
is the one last captured in its grad mode (the call replays that graph) or
the key of the call just before it in that grad mode (the call captures a
graph and replays it). So a key seen once, such as an evaluation's odd
last batch, never costs a capture, and forwards without grad between
training steps (logging, evaluation) neither stop the steps' capture nor
replace their graph; a key's first call has warmed up what a capture
cannot do (cuDNN's and cuBLAS's first calls, the constants of
`device.cached`). The cache holds one graph with grad and one without, and
a new one replaces the old. Every later call copies its
inputs into the graph's own buffers and replays; an input on the host (a
pinned tensor of scalars) goes to the card by a copy that does not
synchronize. `key` holds the caller's switches; the cache adds the grad
mode, the precision policy, TF32, and each input's shape, dtype, device and
whether it requires grad and is the same tensor as another input. It
forgets every graph when a parameter or buffer of `module` moves (`.to`,
`init_params`) or changes whether it requires grad; one replaced by a new
tensor (`load_state_dict(..., assign=True)`) is not seen, and needs a new
cache. Under autograd's anomaly detection every call runs eagerly (its
checks read the card).

The graphs of one cache share one memory pool, which the cache holds:
they cost the larger working set, not the sum. A graph's working set is therefore only its own
from its forward's replay to its backward's, so a forward with grad must
get its backward before any graph of the cache replays again (a backward
after that raises), or be dropped.

`fn` takes trees (tuples, lists, dicts, dataclasses such as `Mesh`, None)
of tensors, and must draw no random number (a graph would replay its
value), read no device value on the host and copy nothing from pageable
host memory (a capture fails on either). Its outputs come back fresh, as a
graph's own are overwritten at its next replay: an output that is an input
is the caller's tensor, the others copies. With grad on, the gradients
reach the inputs and the module's parameters through the captured backward,
as fresh tensors too.

Counters (`tracing.count`): `<name>.graph_captures`, `<name>.graph_replays`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import torch
from torch.autograd.function import once_differentiable

from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.precision import compute_dtype

_LEAF = "leaf"


def _flatten(tree, leaves: list):
    """Append the tensors of `tree` to `leaves`; returns its structure
    (hashable)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, (tuple, list)):
        return type(tree), tuple(_flatten(t, leaves) for t in tree)
    if isinstance(tree, dict):
        return dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items())
    if dataclasses.is_dataclass(tree):
        return type(tree), tuple((f.name, _flatten(getattr(tree, f.name),
                                                   leaves))
                                 for f in dataclasses.fields(tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return None, tree
    raise TypeError(f"a graphed function's tree holds a {type(tree)}")


def _unflatten(spec, leaves):
    return _build(spec, iter(leaves))


def _build(spec, it):
    # a module-level function: a nested one that calls itself would make a
    # reference cycle that keeps the leaves alive until the collector runs
    if spec is _LEAF:
        return next(it)
    kind, body = spec
    if kind is None:
        return body
    if kind in (tuple, list):
        return kind(_build(c, it) for c in body)
    if issubclass(kind, tuple):                      # a named tuple
        return kind(*(_build(c, it) for c in body))
    if kind is dict:
        return {k: _build(c, it) for k, c in body}
    return kind(**{k: _build(c, it) for k, c in body})


def _distinct(leaves):
    """(each leaf's index among the distinct tensors, the distinct
    tensors)."""
    first, index, uniq = {}, [], []
    for x in leaves:
        j = first.get(id(x))
        if j is None:
            j = first[id(x)] = len(uniq)
            uniq.append(x)
        index.append(j)
    return tuple(index), uniq


@contextlib.contextmanager
def _fresh_leaves(module, params):
    """`params` of `module` each swapped in its module for a new leaf on the
    same memory for the block's duration; yields the new leaves, in order.
    Autograd keeps one node a leaf for its gradient, bound to the stream of
    the forward that made it: one made on the default stream by an eager
    forward whose graph something still holds would make the captured
    backward wait on that stream, which a capture cannot do."""
    fresh = {id(p): torch.nn.Parameter(p.detach()) for p in params}
    swapped = []
    for m in module.modules():
        for name, p in m._parameters.items():
            if p is not None and id(p) in fresh:
                swapped.append((m, name, p))
    for m, name, p in swapped:
        m._parameters[name] = fresh[id(p)]
    try:
        yield [fresh[id(p)] for p in params]
    finally:
        for m, name, p in swapped:
            m._parameters[name] = p


class _Graphs:
    """One key's captured forward, and backward where grad is on, with the
    buffers they read and write."""

    def __init__(self, fn, spec, index, inputs, cache):
        self.cache = cache
        self.inputs = []
        device = torch.device("cuda", torch.cuda.current_device())
        for x in inputs:
            # on the card, host inputs too: a host tensor in a captured op
            # would be read once, at the capture
            buf = torch.empty_like(x, device=device)
            if x.requires_grad:
                buf.requires_grad_(True)
            self.inputs.append(buf)
        module = cache.module
        self.params = [p for p in module.parameters() if p.requires_grad] \
            if torch.is_grad_enabled() else []
        if cache.pool is None:
            # held by the cache: a pool whose last graph is gone cannot
            # take another capture
            cache.pool = torch.cuda.MemPool()
        with _fresh_leaves(module, self.params) as leaves:
            self.capture(fn, spec, index, leaves, cache.pool.id)

    def capture(self, fn, spec, index, leaves, pool):
        """Capture the forward and, where grad reaches `leaves` (the
        parameters' stand-ins) or an input, the backward, in `pool`."""
        grad = torch.is_grad_enabled()
        self.fwd = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.fwd, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn(*_unflatten(spec, [self.inputs[j] for j in index]))
        outs = []
        self.out_spec = _flatten(out, outs)
        # each output: ("in", j) is input j given back, ("out", k) the
        # graph's computed output k
        is_input = {id(b): j for j, b in enumerate(self.inputs)}
        computed, seen, self.out_src = [], {}, []
        for o in outs:
            if id(o) in is_input:
                self.out_src.append(("in", is_input[id(o)]))
                continue
            k = seen.get(id(o))
            if k is None:
                k = seen[id(o)] = len(computed)
                computed.append(o)
            self.out_src.append(("out", k))
        self.diff_out = [k for k, o in enumerate(computed) if o.requires_grad]
        self.nondiff = [k for k, o in enumerate(computed)
                        if not o.requires_grad]
        self.diff_in = [j for j, b in enumerate(self.inputs)
                        if b.requires_grad]
        self.bwd = None
        if grad and self.diff_out and (self.diff_in or leaves):
            self.grad_outs = [torch.empty_like(computed[k])
                              for k in self.diff_out]
            self.bwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.bwd, pool=pool,
                                  capture_error_mode="thread_local"):
                self.grads = torch.autograd.grad(
                    [computed[k] for k in self.diff_out],
                    [self.inputs[j] for j in self.diff_in] + leaves,
                    self.grad_outs, allow_unused=True)
        self.outs = [o.detach() for o in computed]

    def copy_in(self, inputs):
        with torch.no_grad():
            for buf, x in zip(self.inputs, inputs):
                buf.copy_(x, non_blocking=True)

    def __call__(self, inputs):
        self.copy_in(inputs)
        self.cache.replays += 1
        if self.bwd is None:
            self.fwd.replay()
            fresh = [o.clone() for o in self.outs]
        else:
            fresh = _Replay.apply(self, *[inputs[j] for j in self.diff_in],
                                  *self.params)
        return _unflatten(self.out_spec,
                          [inputs[i] if src == "in" else fresh[i]
                           for src, i in self.out_src])


class _Replay(torch.autograd.Function):
    """The forward graph's replay as one autograd node whose backward
    replays the backward graph."""

    @staticmethod
    def forward(ctx, g, *args):
        g.fwd.replay()
        outs = [o.clone() for o in g.outs]
        ctx.graphs, ctx.replay = g, g.cache.replays
        ctx.mark_non_differentiable(*[outs[k] for k in g.nondiff])
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        g = ctx.graphs
        if g.cache.replays != ctx.replay:
            raise RuntimeError(
                f"{g.cache.name}: a graph of the cache replayed between "
                f"this forward and its backward, over the memory the "
                f"backward reads")
        for buf, k in zip(g.grad_outs, g.diff_out):
            buf.copy_(grads[k])
        g.bwd.replay()
        # the parameters' gradients in fresh memory, so that no `.grad`
        # holds the graph's buffer into the next replay
        got = [t for t in g.grads if t is not None]
        fresh = iter(torch._foreach_mul(got, 1.0) if got else ())
        return (None,) + tuple(None if t is None else next(fresh)
                               for t in g.grads)


class GraphCache:
    """The graphs of one function, one with grad and one without (see the
    module's docstring); `module` owns the parameters the function reads,
    `name` prefixes its counters."""

    def __init__(self, name: str, module: torch.nn.Module):
        self.name = name
        self.module = module
        self.graphs = {}            # grad mode: (key, _Graphs)
        self.seen = {}              # grad mode: the key of its last call
        self.pool = None
        self.replays = 0
        self.tensors = None
        self.where = None

    def _where(self):
        """Where each of the module's parameters and buffers lies, and
        whether it requires grad (the tensors listed once: walking the
        module takes a millisecond)."""
        if self.tensors is None:
            self.tensors = list(itertools.chain(self.module.parameters(),
                                                self.module.buffers()))
        return tuple((t.data_ptr(), t.requires_grad) for t in self.tensors)

    def __call__(self, key, fn, inputs):
        if torch.is_anomaly_enabled():
            return None
        leaves = []
        spec = _flatten(inputs, leaves)
        index, uniq = _distinct(leaves)
        where = self._where()
        if self.where != where:
            self.graphs.clear()
            self.seen.clear()
            self.where = where
        grad = torch.is_grad_enabled()
        key = (key, spec, index, grad, compute_dtype(),
               torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32,
               tuple((x.shape, x.dtype, x.device, x.requires_grad)
                     for x in uniq))
        seen, self.seen[grad] = self.seen.get(grad), key
        held = self.graphs.get(grad)
        if held is not None and held[0] == key:
            tracing.count(self.name + ".graph_replays", 1)
            return held[1](uniq)
        if key != seen:
            return None
        # the old graph's memory goes back to the pool before the capture
        del held
        self.graphs.pop(grad, None)
        g = _Graphs(fn, spec, index, uniq, self)
        self.graphs[grad] = (key, g)
        tracing.count(self.name + ".graph_captures", 1)
        return g(uniq)
