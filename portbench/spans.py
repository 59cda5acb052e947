"""The program's own spans and counters in one cell, beside the card's
trace: block-boundary idle, host reads per solve, the refinement's own
time, the set-up stages, and what tracing costs.

    python3 -m portbench.spans --workload <cell> --seed <n> [--solves <k>]
    python3 -m portbench.spans --plan-sizes 55 95 119

The first builds the cell's path as a run does, under ``profiling.recording()`` (so
the plan's, the static model's and the graph captures' stage spans are
kept), runs its warm solve, then solves the traffic's first case k times
in each of three ways, in turns: with tracing off, under a recording, and
under a recording with torch's profiler on (the benchmark's traced solve,
inside a ``portbench.traced`` span).  The first profiled solve is read:

* its counters' changes (``host_syncs``, ``cg.blocks``, each kernel's
  launches per iteration);
* the refinement's own time, ``refine.solve`` less its ``refine.inner``
  children (refined paths only);
* every idle gap of the card in the traced window, put down to the
  innermost program span (``tpufem_torch.*``, the profiler's annotation
  events, on the trace's own clock) that covers the gap's midpoint;
  ``boundary_idle_pct`` is the share under ``tpufem_torch.cg.launch``.

Stage lines and readings go to standard error; the last line of standard
output is a JSON object of them.  The second prints, for each n, a JSON
line of PackedPlan.build's stage spans on the mesh of the cell's
configuration (of BENCHMARK.json's first cell without --workload) at the
counts (n, n, n).

The harness reads the program's counters of its traced solve
(``host_syncs_per_solve``) but not yet the spans beside the trace.  Once
harness.py and trace.py read those themselves (idle by span,
``boundary_idle_pct``, ``refine_self_ms``), this module and its tests go.
"""
from __future__ import annotations

import argparse
import bisect
import importlib
import json
import statistics
import sys
import time
from typing import Dict, List, Optional

from . import harness
from . import loads as loadsmod
from . import mesh as meshmod
from . import spec
from . import trace as tracemod

PREFIX = "tpufem_torch."
BENCH = "portbench."
OUTSIDE = "outside the program's spans"
BOUNDARY = PREFIX + "cg.launch"
MODES = ("off", "recording", "profiler")


def split(prof):
    """(device operations, host events, copies) of a finished profile:
    tracemod.split with the device copies of the program's annotations
    left out too.  copies: [how many such copies, how many of them the
    profiler marks as annotations] (tracemod.split leaves out only the
    marked ones and the benchmark's own)."""
    from torch.autograd import DeviceType
    dev, host, copies = [], [], [0, 0]
    for name, s, e, kind, annotation in tracemod._rows(prof):
        if kind == DeviceType.CUDA:
            if name.startswith(PREFIX):
                copies[0] += 1
                copies[1] += annotation
            elif not (annotation or name.startswith(BENCH)):
                dev.append((name, s, e))
        elif kind == DeviceType.CPU:
            host.append((name, s, e))
    return dev, host, copies


def gaps(dev: List[tracemod.Interval], lo: float, hi: float):
    """The card's idle gaps in [lo, hi] (trace us), sorted."""
    edges = [lo] + [x for iv in tracemod.merge(dev, lo, hi) for x in iv] \
        + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_by_span(dev, host, lo: float, hi: float) -> Dict[str, list]:
    """{span: [seconds, gaps]} of every idle gap in [lo, hi], each put
    down to the innermost program span of `host` that covers its midpoint
    (OUTSIDE where none does).  One sweep over the gaps and the spans, both
    sorted: the spans of one thread nest, so the open ones form a stack."""
    spans = sorted((s, -e, name) for name, s, e in host
                   if name.startswith(PREFIX))
    out: Dict[str, list] = {}
    stack: list = []                    # (end, name), innermost last
    j = 0
    for s, e in gaps(dev, lo, hi):
        t = 0.5 * (s + e)
        while j < len(spans) and spans[j][0] <= t:
            start, neg_end, name = spans[j]
            j += 1
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((-neg_end, name))
        while stack and stack[-1][0] < t:
            stack.pop()
        v = out.setdefault(stack[-1][1] if stack else OUTSIDE, [0.0, 0])
        v[0] += (e - s) * 1e-6
        v[1] += 1
    return out


def launch_gaps(dev, host, lo: float, hi: float,
                op: str = "cudaGraphLaunch") -> List[float]:
    """Seconds of each idle gap in [lo, hi] in which the host began a call
    `op`: with a graph launch, the card's whole wait between one PCG block
    and the next, wherever its midpoint lies."""
    every = gaps(dev, lo, hi)
    starts = [s for s, _ in every]
    out = []
    for name, t, _ in host:
        if name != op:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < every[i][1]:
            out.append((every[i][1] - every[i][0]) * 1e-6)
    return out


def boundary_idle_pct(idle: Dict[str, list], window_s: float) -> float:
    """The idle seconds under cg.launch over the window, in percent."""
    return 100.0 * idle.get(BOUNDARY, [0.0])[0] / window_s


def self_ms(spans, name: str, child: str) -> Optional[float]:
    """Milliseconds of the spans `name` of a recording less those of their
    direct children `child`, summed; None without such a span."""
    ids = {s[1] for s in spans if s[0] == PREFIX + name}
    if not ids:
        return None
    whole = sum(s[4] - s[3] for s in spans if s[1] in ids)
    parts = sum(s[4] - s[3] for s in spans
                if s[0] == PREFIX + child and s[2] in ids)
    return (whole - parts) * 1e-6


def span_seconds(spans) -> Dict[str, list]:
    """{span name less the prefix: [seconds summed, count]}."""
    out: Dict[str, list] = {}
    for name, _, _, t0, t1 in spans:
        v = out.setdefault(name[len(PREFIX):], [0.0, 0])
        v[0] += (t1 - t0) * 1e-9
        v[1] += 1
    return out


def measure(cell: spec.Cell, seed: int, solves: int, device) -> dict:
    """The readings of the module's docstring for one cell on `device`
    (a JSON-ready dict; the stderr lines as it goes)."""
    import torch
    from tpufem_torch.utils import profiling

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    cfg, tr = cell.config, cell.traffic
    stages = harness.Stages(dev)
    with profiling.recording() as built:
        coords, conn = meshmod.make(cfg["mesh"])
        fixed = meshmod.boundary_nodes(coords, cfg["fixed"]["axis"],
                                       cfg["fixed"]["value"])
        loads = loadsmod.LoadStream(tr, coords, seed)
        pm = importlib.import_module("portbench.paths."
                                     + spec.module_name(cell.path))
        path = pm.Path(harness.Mesh(coords, conn, fixed), cfg, tr, dev,
                       stages, False)
        with stages("warm"):
            path.warm(loads.warm)
    out = {"workload": cell.name, "seed": seed,
           "device": (torch.cuda.get_device_name(dev) if on_card
                      else dev.type),
           "build_spans": span_seconds(built.spans),
           "solve_s": {m: [] for m in MODES}}
    for name, (sec, n) in sorted(out["build_spans"].items()):
        harness.log(f"span {name}: {sec:.4f} s ({n})")

    _, _, b = loads.case(0)
    first = None
    for k in range(solves):
        order = MODES if k % 2 == 0 else MODES[::-1]
        for mode in order:
            if mode == "off":
                t = time.perf_counter()
                _, conv, iters, _ = path.solve(b)
                dt = time.perf_counter() - t
            elif mode == "recording":
                with profiling.recording():
                    t = time.perf_counter()
                    _, conv, iters, _ = path.solve(b)
                    dt = time.perf_counter() - t
            else:
                with profiling.recording() as rec, \
                        tracemod.profile() as prof:
                    with torch.profiler.record_function("portbench.traced"):
                        t = time.perf_counter()
                        _, conv, iters, _ = path.solve(b)
                        sync()
                        dt = time.perf_counter() - t
            if not conv:
                raise RuntimeError(f"{mode} solve {k} did not converge")
            out["solve_s"][mode].append(dt)
            harness.log(f"solve {k} {mode}: {dt:.4f} s, {iters} iterations")
            if mode == "profiler" and first is None:
                first = (rec, prof, iters)
    for mode in MODES:
        out[f"median_s.{mode}"] = statistics.median(out["solve_s"][mode])

    rec, prof, iters = first
    t = time.perf_counter()
    dev_ops, host, copies = split(prof)
    (_, lo, hi), = [iv for iv in host if iv[0] == "portbench.traced"]
    idle = idle_by_span(dev_ops, host, lo, hi)
    window_s = (hi - lo) * 1e-6
    busy = sum(e - s for s, e in tracemod.merge(dev_ops, lo, hi)) * 1e-6
    every = gaps(dev_ops, lo, hi)
    launches = launch_gaps(dev_ops, host, lo, hi)
    read_s = time.perf_counter() - t
    # what the harness's reading (portbench.trace) makes of the same trace
    w = tracemod.window(prof)
    # the recording's clock against the trace's: the same spans, in order
    ours = sorted((s[3], s[0]) for s in rec.spans)
    theirs = sorted((s, n) for n, s, _ in host if n.startswith(PREFIX))
    offsets = sorted(th[0] - o[0] * 1e-3 for o, th in zip(ours, theirs)
                     if o[1] == th[1])
    out.update(
        iterations=iters, window_s=window_s, busy_s=busy,
        device_idle_pct=100.0 * (1.0 - busy / window_s),
        harness_device_idle_pct=100.0 * (1.0 - w.busy_s / w.window_s),
        harness_device_ops=w.device_ops, harness_idle_gaps=w.idle_gaps,
        idle_by_span=idle, boundary_idle_pct=boundary_idle_pct(idle,
                                                               window_s),
        gaps=len(every), launch_gaps=launches,
        annotation_copies=copies, counts=rec.counts,
        clock_offset_us=([offsets[0], statistics.median(offsets),
                          offsets[-1], len(offsets), len(ours)]
                         if offsets else None), spans=span_seconds(rec.spans),
        refine_self_ms=self_ms(rec.spans, "refine.solve", "refine.inner"),
        launches_per_iteration={
            k[len("launches."):]: v / iters for k, v in rec.counts.items()
            if k.startswith("launches.") and iters},
        read_s=read_s)
    harness.log(f"traced window read in {out['read_s']:.2f} s; "
                f"{out['gaps']} gaps")
    harness.log(f"traced solve: host reads {rec.counts.get('host_syncs')}, "
                f"blocks {rec.counts.get('cg.blocks')}, {iters} iterations")
    harness.log("launches per iteration: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["launches_per_iteration"].items()))
    for name, (sec, n) in sorted(idle.items(), key=lambda kv: -kv[1][0]):
        harness.log(f"idle {sec:.6f} s ({100 * sec / window_s:.3f}%) in {n} "
                    f"gaps under {name}")
    blocks = rec.counts.get("cg.blocks")
    if blocks:
        harness.log(f"idle under cg.launch a block "
                    f"{idle.get(BOUNDARY, [0.0])[0] / blocks * 1e3:.4f} ms")
    if launches:
        harness.log(f"{len(launches)} gaps hold a graph launch's start: "
                    f"{sum(launches):.6f} s "
                    f"({100 * sum(launches) / window_s:.3f}%), median "
                    f"{statistics.median(launches) * 1e3:.4f} ms")
    if out["refine_self_ms"] is not None:
        harness.log(f"refinement's own time {out['refine_self_ms']:.3f} ms")
    path.close()
    return out


def plan_split(mesh: dict, n: int, device) -> dict:
    """PackedPlan.build's stage spans on a configuration's "mesh" entry at
    the counts (n, n, n), seconds."""
    import torch
    from tpufem_torch.ops.packed import PackedPlan
    from tpufem_torch.utils import profiling

    coords, conn = meshmod.make(dict(mesh, n=[n, n, n]))
    with profiling.recording() as rec:
        t = time.perf_counter()
        PackedPlan.build(coords, conn, coords.shape[0], device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t
    return {"n": n, "elements": int(conn.shape[0]), "wall_s": wall,
            "spans": {k: v[0] for k, v in span_seconds(rec.spans).items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.spans")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--plan-sizes", type=int, nargs="*", default=[],
                    help="also split PackedPlan.build on the cell's mesh "
                         "at the counts (n, n, n) for each n (one JSON "
                         "line each)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device: the benchmark runs on the card only")
        return 3
    if args.plan_sizes:
        mesh = spec.load(args.workload or spec.workloads()[0]).config["mesh"]
    for n in args.plan_sizes:
        print(json.dumps(plan_split(mesh, n, "cuda:0")), flush=True)
    if args.workload:
        out = measure(spec.load(args.workload), args.seed, args.solves,
                      "cuda:0")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
