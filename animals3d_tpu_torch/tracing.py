"""The port's tracer: spans at its layer boundaries and counters where the
work happens, on the clock of `torch.profiler`.

    with tracing.span("backward"):          # recorded as "a3d.backward"
        loss.backward()
    if tracing.on():                          # the value only when on
        tracing.count("mesh.faces", mesh.num_faces)

Off (the default), `span` returns one shared no-op context after a flag
check: no tensor operation, no CUDA event, no synchronize. Tracing is on
after `enable()`, and while a `torch.profiler` session records. Each
switch from off to on starts a fresh recording, so a snapshot covers one
traced window. A profiler session's end is seen at the next span or
counter call: two sessions with no call between make one recording.

On, a span enters `torch.profiler.record_function("a3d.<name>")`, so that
a profiler trace shows it beside the kernels it launches, and records its
host start and end from `time.time_ns()` (the profiler's clock: a chrome
trace event's `ts` plus the trace's `baseTimeNanoseconds`), its parent
(the innermost open span) and its iteration (the id of its root span).
On a CUDA device it also records a CUDA event on the current stream at
entry and at exit; their interval is the span's stream time, its device
work and any device idle between. Events are read when a snapshot is
taken, or when many are pending and the oldest have completed (a query,
never a synchronize).

Memory stays bounded over any run length: per span name, the calls, host
time, host self time (what no child span covers) and stream time of the
whole recording; raw spans for the last `RING` iterations. Counters add up
Python ints on the host and device tensors on the device (read at the
snapshot). The kernel wrappers' `launches` integers are registered
(`register_launches`) and reported as `launches.<wrapper>`, counted from
the recording's start.

Spans are entered on the thread that drives the model; autograd's own
device thread enters none.
"""
from __future__ import annotations

import collections
import json
import os
import time

import torch
from torch.autograd import profiler as _prof

PREFIX = "a3d."
RING = 64          # iterations (root spans) whose raw spans are kept
HARVEST = 512      # pending event pairs before the completed are read


class _Null:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Tracer:
    """The recording: open spans, per-name aggregates, the raw ring, the
    counters and the CUDA events."""

    def __init__(self):
        self.enabled = False
        self.live = False        # whether the last call found tracing on
        self.launch_fns = []
        self._events = []        # free CUDA events
        self.fresh()

    def fresh(self):
        """Start a new recording."""
        self.live = True
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.start_ns = time.time_ns()
        self.stack = []
        self.aggs = {}           # name -> [calls, host ns, self ns,
        #                                   stream ms, stream calls]
        self.ring = collections.deque(maxlen=RING)
        self.roots = 0
        self.ids = 0
        for s in getattr(self, "pending", ()):
            self._events += s.ev
        self.pending = collections.deque()
        self.counts = {}         # name -> [host total, device total]
        self.launch0 = {f.__name__: f.launches for f in self.launch_fns}

    def event_pair(self):
        ev = self._events
        while len(ev) < 2:
            ev.append(torch.cuda.Event(enable_timing=True))
        return [ev.pop(), ev.pop()]

    def harvest(self, wait: bool = False):
        """Read the stream times of pending spans, oldest first: all of
        them after a synchronize (`wait`), else those whose exit event has
        completed."""
        if wait and self.pending:
            torch.cuda.synchronize()
        while self.pending:
            s = self.pending[0]
            if not (wait or s.ev[1].query()):
                break
            self.pending.popleft()
            s.stream_ms = s.ev[0].elapsed_time(s.ev[1])
            agg = self.aggs[s.name]
            agg[3] += s.stream_ms
            agg[4] += 1
            self._events += s.ev
            s.ev = None


_T = Tracer()


def on() -> bool:
    """Whether spans and counters record now."""
    return _T.enabled or _prof._is_profiler_enabled


def _live():
    if not _T.live:
        _T.fresh()


class _Span:
    __slots__ = ("name", "id", "parent", "iteration", "group", "rf", "ev",
                 "t0", "t1", "child_ns", "stream_ms")

    def __init__(self, name):
        self.name = name
        self.ev = None
        self.child_ns = 0
        self.stream_ms = None

    def __enter__(self):
        T = _T
        _live()
        T.ids += 1
        self.id = T.ids
        parent = T.stack[-1] if T.stack else None
        self.parent = parent
        if parent is None:
            self.iteration = self.id
            self.group = []
            T.ring.append(self.group)
            T.roots += 1
        else:
            self.iteration = parent.iteration
            self.group = parent.group
        T.stack.append(self)
        if T.cuda:
            self.ev = T.event_pair()
        # the profiler's event encloses the host interval, tightly
        self.rf = _prof.record_function(self.name)
        self.rf.__enter__()
        if self.ev is not None:
            self.ev[0].record()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record()
        self.t1 = time.time_ns()
        self.rf.__exit__(*exc)
        T = _T
        if self.ev is not None:
            T.pending.append(self)
        if T.stack and T.stack[-1] is self:
            T.stack.pop()
        dur = self.t1 - self.t0
        agg = T.aggs.get(self.name)
        if agg is None:
            agg = T.aggs[self.name] = [0, 0, 0, 0.0, 0]
        agg[0] += 1
        agg[1] += dur
        agg[2] += dur - self.child_ns
        self.group.append(self)
        if self.parent is not None:
            self.parent.child_ns += dur
        elif len(T.pending) > HARVEST:
            T.harvest()
        return False


def span(name: str):
    """A context that records the span `a3d.<name>` where tracing is on,
    and a shared no-op one where it is off."""
    if not (_T.enabled or _prof._is_profiler_enabled):
        _T.live = False
        return _NULL
    return _Span(PREFIX + name)


def count(name: str, value) -> None:
    """Add `value` (a Python number, or a device tensor summed on its
    device without a synchronize) to the counter `name`."""
    if not (_T.enabled or _prof._is_profiler_enabled):
        _T.live = False
        return
    _live()
    c = _T.counts.get(name)
    if c is None:
        c = _T.counts[name] = [0, None]
    if isinstance(value, torch.Tensor):
        v = value.detach().sum()
        c[1] = v if c[1] is None else c[1] + v
    else:
        c[0] += value


def register_launches(fn) -> None:
    """Report `fn.launches` (a kernel wrapper's launch count) in every
    snapshot as `launches.<fn.__name__>`."""
    _T.launch_fns.append(fn)
    _T.launch0[fn.__name__] = fn.launches


def enable() -> None:
    """Turn tracing on; a fresh recording starts where it was off."""
    if not on():
        _T.fresh()
    _T.enabled = True


def disable() -> None:
    """Turn `enable`'s tracing off; the recording stays for `snapshot`."""
    _T.enabled = False
    _T.live = on()


def snapshot() -> dict:
    """The recording, after one synchronize: `spans` {name: calls, host_ms,
    self_ms, stream_ms (None without a CUDA device), stream_calls},
    `counters` {name: total}, `roots` (the root spans' count), `ring` (the
    raw spans of the last `RING` iterations: id, name, parent, iteration,
    start_ns, end_ns, stream_ms) and `start_ns`."""
    T = _T
    T.harvest(wait=True)
    spans = {n: {"calls": a[0], "host_ms": a[1] / 1e6, "self_ms": a[2] / 1e6,
                 "stream_ms": a[3] if a[4] else None, "stream_calls": a[4]}
             for n, a in T.aggs.items()}
    counters = {}
    for n, (host, dev) in T.counts.items():
        counters[n] = host + (dev.item() if dev is not None else 0)
    for f in T.launch_fns:
        counters["launches." + f.__name__] = \
            f.launches - T.launch0.get(f.__name__, 0)
    ring = [{"id": s.id, "name": s.name,
             "parent": s.parent.id if s.parent is not None else None,
             "iteration": s.iteration, "start_ns": s.t0, "end_ns": s.t1,
             "stream_ms": s.stream_ms}
            for group in T.ring for s in group]
    ring.sort(key=lambda r: r["start_ns"])
    return {"spans": spans, "counters": counters, "roots": T.roots,
            "ring": ring, "start_ns": T.start_ns}


def write(path: str) -> dict:
    """Write the snapshot as a Chrome trace (`traceEvents`: the ring's
    spans on the profiler's clock, `ts` in µs after `baseTimeNanoseconds`;
    the aggregates and counters under `metadata`); returns the snapshot."""
    snap = snapshot()
    base = snap["start_ns"] // 10 ** 9 * 10 ** 9
    pid = os.getpid()
    events = [{"ph": "X", "cat": "a3d", "name": r["name"], "pid": pid,
               "tid": 0, "ts": (r["start_ns"] - base) / 1e3,
               "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
               "args": {"id": r["id"], "parent": r["parent"],
                        "iteration": r["iteration"],
                        "stream_ms": r["stream_ms"]}}
              for r in snap["ring"]]
    out = {"traceEvents": events, "displayTimeUnit": "ms",
           "baseTimeNanoseconds": base,
           "metadata": {"spans": snap["spans"],
                        "counters": snap["counters"],
                        "roots": snap["roots"]}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f)
    return snap
