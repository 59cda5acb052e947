"""Reading torch.profiler's trace of the card: busy time, the heaviest
device operations and the longest idle gaps with what the host was doing.

The benchmark's own spans are ``record_function`` annotations named
``portbench.<what>``: ``portbench.traced`` around the traced solve,
``portbench.solve`` around each solve, ``portbench.apply`` around each
operator call of the apply timing.  Times here are the trace's own clock
(microseconds), converted to seconds on the way out.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

NAME_CHARS = 160
TOP = 10

Interval = Tuple[str, float, float]       # (name, start us, end us)


def profile():
    """A profiler of the host and the card (the card alone has the
    device records)."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _rows(prof):
    """(name, start us, end us, device type, is an annotation) of every
    event, from the profiler's raw records (its parsed events take a
    hundred times longer to build)."""
    for e in prof.profiler.kineto_results.events():
        ann = getattr(e, "is_user_annotation", None)
        yield (e.name(), e.start_ns() * 1e-3, e.end_ns() * 1e-3,
               e.device_type(), bool(ann()) if callable(ann) else False)


def split(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device operations, host operations) of a finished profile.  The
    device's copy of an annotation (the span of the kernels launched inside
    a record_function) is no operation and is left out."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for name, s, e, kind, annotation in _rows(prof):
        if kind == DeviceType.CUDA:
            if not (annotation or name.startswith("portbench.")):
                dev.append((name, s, e))
        elif kind == DeviceType.CPU:
            host.append((name, s, e))
    return dev, host


def merge(ivs: List[Interval], lo: float, hi: float):
    """The union of the intervals clipped to [lo, hi], as sorted
    non-overlapping (start, end) pairs."""
    out = []
    for _, s, e in sorted(ivs, key=lambda t: t[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_label(host: List[Interval], t: float) -> str:
    """What the host was doing at trace time t: the innermost benchmark
    span and the innermost operation that cover t."""
    inner = annot = None
    for iv in host:
        _, s, e = iv
        if not s <= t <= e:
            continue
        if inner is None or (s, -e) > (inner[1], -inner[2]):
            inner = iv
        if iv[0].startswith("portbench.") and (
                annot is None or s > annot[1]):
            annot = iv
    if inner is None:
        return "host code outside any traced operation"
    if annot is None or annot is inner:
        return inner[0][:NAME_CHARS]
    return f"{annot[0]} > {inner[0]}"[:NAME_CHARS]


@dataclasses.dataclass
class Window:
    busy_s: float
    window_s: float
    device_ops: list        # [[name, seconds]], the heaviest first
    idle_gaps: list         # [[host activity, seconds]], the longest first


def window(prof, span: str = "portbench.traced") -> Optional[Window]:
    """The traced window of `span` (its first occurrence) in a finished
    profile; None without such a span."""
    return summarize(*split(prof), span)


def summarize(dev: List[Interval], host: List[Interval],
              span: str) -> Optional[Window]:
    """window() on the device and host operations of a profile."""
    spans = [iv for iv in host if iv[0] == span]
    if not spans:
        return None
    _, lo, hi = spans[0]
    busy = merge(dev, lo, hi)
    by_name = {}
    for name, s, e in dev:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return Window(
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        window_s=(hi - lo) * 1e-6,
        device_ops=[[n[:NAME_CHARS], d * 1e-6] for n, d in ops],
        idle_gaps=[[host_label(host, 0.5 * (s + e)), (e - s) * 1e-6]
                   for s, e in gaps])


def device_seconds(prof) -> float:
    """The device time of every operation in a profile, in seconds."""
    return sum(e - s for _, s, e in split(prof)[0]) * 1e-6
