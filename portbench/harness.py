"""One run of one cell: set-up, the measured window, the reference's
judgement and the result line.

    set-up   import the program, open the card, make the mesh and the
             load cases from the configuration, the traffic and the seed,
             build the cell's path (its stages timed and synchronised),
             run the path's capped warm solve on the traffic's first case
    window   solve the cases one after another from a cold start, each to
             the traffic's accuracy, in the traffic's order, until
             --seconds have passed; the solve in flight is finished, so
             the window ends at the end of a whole solve.  With --trace 1
             the window's first solve runs under the profiler and inside
             the program's recording (tpufem_torch.utils.profiling), which
             keeps its spans and its counters' changes for the metrics
    after    read the device's peak memory; check that no JAX module is
             loaded; with --trace 1 time the operator's apply under the
             profiler; take the path's diagonal; free the program's state;
             let the reference judge every answer; print the result

Everything but the result line goes to standard error: the stages, each
solve, and last the numbers compared beside their limits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import sys
import time
from typing import Callable, Optional

import numpy as np

from . import judge as judgemod
from . import loads as loadsmod
from . import mesh as meshmod
from . import trace as tracemod
from .spec import Cell, module_name

# top-level module names that must not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "tpufem")
APPLY_REPS = 20


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def loaded_banned() -> list:
    """The banned top-level names among the loaded modules (whole names:
    tpufem_torch is not tpufem)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


class Stages:
    """Seconds of named set-up stages, each ending in a device sync."""

    def __init__(self, device):
        self.device = device
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t
        self.times[name] = self.times.get(name, 0.0) + dt
        log(f"stage {name}: {dt:.4f} s")


@dataclasses.dataclass
class Mesh:
    coords: np.ndarray
    conn: np.ndarray
    fixed: np.ndarray


@dataclasses.dataclass
class Context:
    """What a metric's reader may read."""
    config: dict
    operator: str               # the path's OPERATOR
    dtype: str                  # the path's DTYPE
    setup_s: float
    stages: dict
    window_s: float
    solves: list                # [{"case", "sign", "iterations", "detail",
                                #   ...}]
    peak_bytes: int
    trace: Optional[tracemod.Window] = None
    traced_iterations: int = 0
    apply_s: Optional[float] = None
    # the program's recording of the traced solve (--trace 1 only): its
    # `spans` and `counts` (each counter's change over the solve)
    recording: Optional[object] = None


def _metrics(entries, ctx):
    out = {}
    for m in entries:
        mod = importlib.import_module("portbench.metrics."
                                      + module_name(m["name"]))
        v = mod.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, control: bool = False,
             fault: Optional[Callable] = None):
    """Returns (result dict, exit code); the result is None when the run
    must print none.  `fault`, when given, is called with the built path
    (the tests plant faults through it)."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    stages = Stages(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    with stages("import"):
        import tpufem_torch  # noqa: F401
    with stages("device"):
        if on_card:
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
    cfg, tr = cell.config, cell.traffic
    with stages("mesh"):
        coords, conn = meshmod.make(cfg["mesh"])
        fixed = meshmod.boundary_nodes(coords, cfg["fixed"]["axis"],
                                       cfg["fixed"]["value"])
    if (conn.shape[0], coords.shape[0]) != (cfg["elements"], cfg["nodes"]):
        raise ValueError(f"mesh has {conn.shape[0]} elements, "
                         f"{coords.shape[0]} nodes; the configuration says "
                         f"{cfg['elements']}, {cfg['nodes']}")
    with stages("loads"):
        loads = loadsmod.LoadStream(tr, coords, seed)
    pm = importlib.import_module("portbench.paths." + module_name(cell.path))
    path = pm.Path(Mesh(coords, conn, fixed), cfg, tr, dev, stages, control)
    if fault is not None:
        fault(path)
    with stages("warm"):
        path.warm(loads.warm)
    setup_s = time.perf_counter() - t0
    log(f"setup {setup_s:.4f} s ({cell.name}, seed {seed}, "
        f"{'control' if control else 'program'})")

    # the measured window
    solves, answers = [], []
    prof = rec = None
    tw = time.perf_counter()
    i = 0
    while True:
        name, sign, b = loads.case(i)
        ts = time.perf_counter()
        if trace and i == 0:
            from tpufem_torch.utils import profiling
            with tracemod.profile() as prof, profiling.recording() as rec:
                with torch.profiler.record_function("portbench.traced"):
                    u, conv, iters, detail = path.solve(b)
                    sync()
        else:
            u, conv, iters, detail = path.solve(b)
        te = time.perf_counter()
        solves.append(dict(case=name, sign=sign, iterations=iters,
                           converged=conv, seconds=te - ts, detail=detail))
        answers.append((b, u))
        log(f"solve {i}: {name} {'+-'[sign < 0]} iterations {iters} "
            f"converged {conv} {te - ts:.4f} s {detail}")
        i += 1
        if te - tw >= seconds:
            break
    window_s = te - tw
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    banned = loaded_banned()
    if banned:
        log(f"loaded modules that the benchmark must not load: {banned}")
        return None, 4

    ctx = Context(config=cfg, operator=pm.OPERATOR, dtype=pm.DTYPE,
                  setup_s=setup_s, stages=dict(stages.times),
                  window_s=window_s, solves=solves, peak_bytes=peak,
                  recording=rec)
    if trace:
        t = time.perf_counter()
        ctx.trace = tracemod.window(prof)
        ctx.traced_iterations = solves[0]["iterations"]
        log(f"traced window read in {time.perf_counter() - t:.2f} s; the "
            f"traced solve's span {ctx.trace.window_s:.4f} s")
        t = time.perf_counter()
        fn = path.apply_call()
        fn()
        sync()
        with tracemod.profile() as p2:
            for _ in range(APPLY_REPS):
                with torch.profiler.record_function("portbench.apply"):
                    fn()
            sync()
        dsec = tracemod.device_seconds(p2)
        ctx.apply_s = dsec / APPLY_REPS if dsec > 0 else None
        del fn, p2, prof
        log(f"apply timed in {time.perf_counter() - t:.2f} s: "
            f"{ctx.apply_s!r} s an apply")
    diag = path.diagonal()
    path.close()
    del path
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_j = time.perf_counter()
    nums, resid = judgemod.judge(coords, conn, fixed, cfg["element"],
                                 cfg["material"], answers, diag,
                                 tr["tol_rel"], pm.DIAG_LIMIT, dev)
    for k, r in enumerate(resid):
        log(f"reference: solve {k} relative residual {r!r}")
    log(f"reference judged {len(answers)} answers in "
        f"{time.perf_counter() - t_j:.2f} s")
    failed = sum(1 for s, r in zip(solves, resid)
                 if not s["converged"] or not r <= tr["tol_rel"])
    correct = bool(answers) and all(n.ok for n in nums)

    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(solves),
              "failed": failed,
              "metrics": _metrics(cell.per_layer if trace
                                  else cell.end_to_end, ctx),
              "device": device_info}
    if trace and ctx.trace is not None:
        device_info.update(busy_s=ctx.trace.busy_s,
                           window_s=ctx.trace.window_s)
        result["breakdown"] = {"device_ops": ctx.trace.device_ops,
                               "idle_gaps": ctx.trace.idle_gaps}
    compared = {n.name: {"value": n.value, "limit": n.limit}
                for n in nums if n.limit is not None}
    for n in nums:
        if n.limit is None:
            log(f"printed {n.name} {n.value!r} (not compared)")
    for n in nums:
        if n.limit is not None:
            log(f"compared {n.name} {n.value!r} limit {n.limit!r} "
                f"{'ok' if n.ok else 'FAILED'}")
    result["compared"] = compared
    return result, 0
