"""Profiling helpers: synchronized timing, roofline counters, torch traces.

The port of tpufem/utils/profiling.py.  The reference's only
instrumentation is GPU-memory prints and residual lines (SURVEY.md
section 5).  Here:
* :func:`timed` — wall-times a callable with its result reduced and read
  back to the host, and a two-point slope option that cancels constant
  launch latency.
* :class:`Roofline` — nnz/s, elements/s, GB/s counters for kernels.
* :func:`trace` — context manager around torch.profiler that writes a
  Chrome trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

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
