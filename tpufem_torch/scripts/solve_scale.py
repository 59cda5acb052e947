"""Converged solve at scale: c3d10 box, f64-verified residual.

The port of tpufem's scripts/solve_scale.py: the mixed-precision refined
solve (solvers/refine.py: f32 packed PCG inner solves, each PCG block a
CUDA graph, under the f64 true-residual outer loop) on box_tet10(n), fixed
at z = 0, -1e3 in z on the top face.  Prints a JSON summary: the setup
stages, the solve seconds, inner iterations, refinement cycles, the f64
true relative residual, the tip deflection and the peak device memory.

Usage: python -m tpufem_torch.scripts.solve_scale [n=95] [precond=block]
           [tol_rel=1e-6]
  n=95  -> 5.14M elements / 6.97M nodes; n=119 -> 10.11M / 13.65M.
  SOLVE_INNER_TOL (5e-3), SOLVE_EVERY (250 at n >= 100, else 500) and
  SOLVE_INNER_MAX (2000 at n >= 100, else 1500) set the inner solves.
Mesh, plan and the f64 operator's geometry are kept in
.bench_cache/torch_tet10_n{n}/ of the repository (built and written when
absent).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

E, NU = 200e9, 0.3
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def settings(n: int) -> dict:
    """The inner solves' settings for box_tet10(n), from the environment
    (tpufem's names and defaults)."""
    return dict(
        inner_tol=float(os.environ.get("SOLVE_INNER_TOL", "5e-3")),
        every=int(os.environ.get("SOLVE_EVERY",
                                 "250" if n >= 100 else "500")),
        inner_max=int(os.environ.get("SOLVE_INNER_MAX",
                                     "2000" if n >= 100 else "1500")))


def run(n: int = 95, precond: str = "block", tol_rel: float = 1e-6,
        cache: bool = True, device=None, log=print):
    """The flow of the script; returns its summary, the PackedSystem and
    the f64 solution u (flat [3N], node-major, on the device).  cache=False builds everything
    afresh and writes nothing; device=None is the card."""
    from tpufem_torch import (PackedPartialOperator, PackedPlan,
                              PackedSystem, RefinedSystem, meshgen,
                              resolve_device)

    dev = resolve_device(device)
    cfg = settings(n)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    stages = {}
    cdir = os.path.join(ROOT, ".bench_cache", f"torch_tet10_n{n}")
    cached = cache and os.path.exists(os.path.join(cdir, "plan",
                                                   "meta.json"))
    t00 = t0 = time.perf_counter()
    if cached:
        coords = np.load(os.path.join(cdir, "coords.npy"))
        conn = np.load(os.path.join(cdir, "conn.npy"))
    else:
        coords, conn = meshgen.box_tet10(n, n, n)
    stages["mesh"] = time.perf_counter() - t0
    N, M = coords.shape[0], conn.shape[0]
    t0 = time.perf_counter()
    if cached:
        plan = PackedPlan.load(os.path.join(cdir, "plan"), device=dev)
    else:
        plan = PackedPlan.build(coords, conn, N, device=dev)
        if cache:
            os.makedirs(cdir, exist_ok=True)
            np.save(os.path.join(cdir, "coords.npy"), coords)
            np.save(os.path.join(cdir, "conn.npy"), conn)
            plan.save(os.path.join(cdir, "plan"))
    sync()
    stages["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = PackedPartialOperator.build(coords, conn, "c3d10", E, NU, plan=plan,
                                     dtype=torch.float32, device=dev)
    sync()
    stages["operator_geometry"] = time.perf_counter() - t0
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    top = meshgen.boundary_nodes(coords, 2, 1.0)
    t0 = time.perf_counter()
    system = PackedSystem(op, fixed_nodes=fixed, precondition=precond)
    sync()
    stages["system"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = RefinedSystem(system, coords, conn, "c3d10", E, NU,
                        cache_path=os.path.join(cdir, "refine_geom.npz")
                        if cache else None)
    sync()
    stages["refinement_geometry"] = time.perf_counter() - t0
    t_setup = time.perf_counter() - t00
    log(f"setup: box_tet10({n}) {M} elements, {N} nodes "
        f"({'cache' if cached else 'built'}): "
        + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()))

    b = np.zeros((N, 3), np.float32)
    b[top, 2] = -1e3
    bnorm = float(np.linalg.norm(b))
    # capture the chunk's PCG blocks as CUDA graphs, running nothing
    t0 = time.perf_counter()
    system.warm_chunked(b, tol=cfg["inner_tol"], every=cfg["every"])
    sync()
    stages["warm"] = time.perf_counter() - t0
    log(f"warm (graph capture): {stages['warm']:.2f} s")

    t0 = time.perf_counter()
    u, info = ref.solve(
        b, tol_rel=tol_rel, inner_tol=cfg["inner_tol"],
        inner_max_iter=cfg["inner_max"], every=cfg["every"],
        progress=lambda cy, it, rr: log(
            f"  cycle {cy} (inner iterations {it}): f64 true rel residual "
            f"{rr:.3e} [{time.perf_counter() - t0:.1f} s]"))
    sync()
    t_solve = time.perf_counter() - t0
    uz = u.reshape(N, 3)[torch.as_tensor(top, device=dev).long(), 2]
    summary = {
        "mesh": f"box_tet10({n})", "elements": M, "nodes": N,
        "precondition": precond, "tol_rel": tol_rel, **cfg,
        "b_norm": bnorm,
        "true_residual_norm": info.residual_norm,
        "rel_residual": info.rel_residual,
        "converged": info.converged,
        "cycles": info.cycles,
        "iterations": info.inner_iterations,
        "solve_seconds": t_solve,
        "iters_per_s": (info.inner_iterations / t_solve
                        if t_solve > 0 else None),
        "setup_seconds": t_setup,
        "setup_stages": stages,
        "tip_uz_mean": float(uz.mean()),
        "tip_uz_min": float(uz.min()),
        "outer_history_rel": [float(x) / bnorm for x in info.outer_history],
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None),
    }
    return summary, system, u


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 95
    precond = argv[1] if len(argv) > 1 else "block"
    tol_rel = float(argv[2]) if len(argv) > 2 else 1e-6
    print(json.dumps(run(n, precond, tol_rel)[0]), flush=True)


if __name__ == "__main__":
    main()
