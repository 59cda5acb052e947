"""Profiling helpers: synchronized timing, roofline counters, torch traces.

The port of tpufem/utils/profiling.py.  The reference's only
instrumentation is GPU-memory prints and residual lines (SURVEY.md
section 5).  Here:
* :func:`timed` — wall-times a callable with its result reduced and read
  back to the host, and a two-point slope option that cancels constant
  launch latency.
* :class:`StageClock` — the seconds of a set-up's stages, each ending in
  a device synchronise.
* :class:`Roofline` — nnz/s, elements/s, GB/s counters for kernels.
* :func:`trace` — context manager around torch.profiler that writes a
  Chrome trace.
* :func:`span`, :func:`spanned` — the program's spans
  (``tpufem_torch.<layer>.<what>``) at its layer boundaries, and
  :func:`count` / :func:`counters` — its counters; :func:`recording`
  keeps the spans and the counters' changes in memory.

Tracing is off unless a :func:`recording` is open or torch's profiler is
on (``trace``, or any ``torch.profiler.profile``).  While it is off,
``span`` returns one shared no-op context.
While the profiler is on, each span is also a ``record_function``, so it
lies in the profiler's trace on the trace's own clock.  A recording keeps
each span as (name, id, parent id, start ns, end ns) with the start and
end read from ``time.time_ns()``: the epoch clock in which the profiler's
events are stamped, within the time that entering a ``record_function``
takes.  Counters are plain integers, always on; no span or counter
synchronises the device, allocates on it or launches anything, and none
belongs inside a captured CUDA graph body (it would run once, at the
capture).  The state is the process's: the program's host paths run on
one thread.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _sync_scalar(x) -> float:
    """x reduced to one host float.  A tensor is summed and read back with
    `.item()`, which on a CUDA tensor waits for the stream's work: the
    timer then stops after the device finished, not after the launch."""
    if isinstance(x, torch.Tensor):
        return float(x.sum().item())
    return float(np.sum(np.asarray(x)) if hasattr(x, "shape") else x)


def timed(fn: Callable, *args, reps: int = 3) -> float:
    """Median wall time of fn(*args); result is reduced + read to host."""
    _sync_scalar(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync_scalar(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def timed_slope(make_fn: Callable[[int], Callable], lo: int, hi: int,
                *args, reps: int = 3) -> float:
    """Per-iteration time via two loop lengths (cancels constant latency).

    make_fn(iters) must return a callable running `iters` iterations.
    """
    t1 = timed(make_fn(lo), *args, reps=reps)
    t2 = timed(make_fn(hi), *args, reps=reps)
    return max((t2 - t1) / (hi - lo), 1e-12)


class StageClock:
    """A set-up's stage clock: `tick(name)` ends a stage.  It synchronises
    the device (a CUDA card), adds the seconds since the last tick (or
    since the clock was made) to timings[name] when a dict was given, and
    starts the next stage."""

    def __init__(self, device, timings: Optional[dict] = None):
        self.device = torch.device(device)
        self.timings = timings
        self.t0 = time.perf_counter()

    def tick(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self.timings is not None:
            self.timings[name] = self.timings.get(name, 0.0) + now - self.t0
        self.t0 = now


@dataclasses.dataclass
class Roofline:
    """Throughput bookkeeping for a kernel measurement."""

    seconds: float
    flops: float = 0.0
    bytes_moved: float = 0.0
    items: float = 0.0

    @property
    def gflops(self) -> float:
        return self.flops / self.seconds / 1e9

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds

    def report(self, name: str = "kernel") -> str:
        return (f"{name}: {self.seconds*1e3:.3f} ms | "
                f"{self.gflops:.1f} GFLOP/s | {self.gbps:.1f} GB/s | "
                f"{self.items_per_s:.3g} items/s")


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler trace of the block, written as a Chrome trace
    (chrome://tracing, Perfetto) into `logdir` (default: a
    tpufem_torch_trace directory under the temporary directory).

    Records CPU activity, and CUDA activity where a CUDA device is
    available (the device is synchronized before the trace stops).
    Yields the profiler, whose `trace_path` names the file once the block
    has ended.  Errors are not swallowed: torch's profiler can trace on
    every backend it runs on."""
    from torch.profiler import ProfilerActivity, profile

    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "tpufem_torch_trace")
    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path


# -- spans and counters -------------------------------------------------------

PREFIX = "tpufem_torch."
# (name, id, parent id or None, start ns, end ns)
SpanRecord = Tuple[str, int, Optional[int], int, int]


class Recording:
    """What one `recording()` block saw: `spans`, each span that began and
    ended inside it (SpanRecord, in the order they ended), and `counts`,
    each counter's change over the block (the counters that changed;
    filled when the block ends)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.counts: Dict[str, int] = {}
        self._before = counters()


_REC: Optional[Recording] = None      # the open recording
_STACK: List[int] = []                # the ids of the open spans
_IDS = itertools.count(1)
_COUNTS: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


def _tracing() -> bool:
    return _REC is not None or torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "id", "parent", "t0", "rf", "rec")

    def __init__(self, name: str):
        self.name = PREFIX + name

    def __enter__(self):
        self.parent = _STACK[-1] if _STACK else None
        self.id = next(_IDS)
        self.rec = _REC
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.t0 = time.time_ns()
            self.rf.__enter__()
        else:
            self.t0 = time.time_ns()
        _STACK.append(self.id)
        return self

    def __exit__(self, *exc):
        _STACK.pop()
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.rec is not None and self.rec is _REC:
            self.rec.spans.append((self.name, self.id, self.parent, self.t0,
                                   t1))


def span(name: str):
    """A context manager that spans `name` (recorded as
    ``tpufem_torch.<name>``) while tracing is on, and the shared no-op
    context while it is off."""
    return _Span(name) if _tracing() else _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name`."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A snapshot of every counter, and ``launches.<kernel>`` for each
    hand-written kernel (its launch count, graph replays included, read
    from ops.cuda's registry)."""
    from ..ops.cuda import REGISTRY
    out = dict(_COUNTS)
    out.update((f"launches.{k.name}", k.launches) for k in REGISTRY)
    return out


@contextlib.contextmanager
def recording():
    """Keep the spans and the counters' changes of the block in memory:
    yields a Recording.  One recording is open at a time."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is already open")
    rec = _REC = Recording()
    try:
        yield rec
    finally:
        _REC = None
        after = counters()
        rec.counts = {k: v - rec._before.get(k, 0) for k, v in after.items()
                      if v != rec._before.get(k, 0)}
