"""Config-4 hybrid (Schur substructuring) benchmark: subdivision.ipynb
cells 9-15 at real scale.

The port of tpufem's scripts/bench_hybrid.py, with command arguments in
place of its environment variables: box_tet(n) c3d4 (E = 200e9, nu = 0.3)
fixed at z = 0, 1e3 in x on the top face, partitioned into n_parts; the
build by stage, the interface size and the resident blocks, one Schur
matvec, the chunked interface PCG run twice (the first run captures its
CUDA graphs), and the displacement against a reference solve.

Usage: python -m tpufem_torch.scripts.bench_hybrid [n=26] [n_parts=32]
           [--part rcb|morton|grow] [--precond bdd|nn|jacobi]
           [--no-slim] [--no-inverse] [--no-mf] [--tol 1e-4]
           [--tol-rel R] [--max-iter 800] [--every N]
           [--ref packed|refined|none]
           [--ref-tol-rel 1e-5] [--ref-max-iter 20000] [--device cpu]
  n=26 -> 105k elements (tpufem's record: 32 parts); n=55 -> 998,250
  elements, BASELINE config 4 (512 parts).
ref="packed" is tpufem's reference: the f32 packed operator's chunked
Jacobi PCG to ref_tol_rel ||b||; "refined" puts that under the f64
true-residual loop (solvers.refine.RefinedSystem) to ref_tol_rel.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

E, NU = 200e9, 0.3


def partition_labels(coords, conn, n_parts: int, how: str = "rcb"):
    """Element labels by tpufem's script's three partitioners."""
    from tpufem_torch.parallel import partition as part
    if how == "rcb":
        return part.rcb_partition(coords, conn, n_parts)
    if how == "morton":
        return part.morton_partition(coords, conn, n_parts)
    return part.partition_elements(conn, "c3d4", n_parts, 0,
                                   balanced=True)[0]


def run(n: int = 26, n_parts: int = 32, part: str = "rcb",
        precond: str = "bdd", slim: bool = True,
        interior_inverse: bool = True, matrix_free_gg: bool = True,
        tol: float = 1e-4, max_iter: int = 800, every=None,
        tol_rel=None,
        ref: str = "packed", ref_tol_rel: float = 1e-5,
        ref_max_iter: int = 20000, solves: int = 2, device=None,
        log=print):
    """The script's flow; returns (summary dict, with the labels and each
    solve's history; the HybridSystem; the hybrid displacement [N, 3];
    the reference displacement or None).  tol is absolute on the
    interface residual, or tol_rel times ||g|| (the condensed right-hand
    side) when tol_rel is given.  every: the chunk length of
    solve_chunked, max_iter unless given (a chunk restart near the float32
    floor can diverge).  device=None is the card."""
    from tpufem_torch import build_hybrid, meshgen, resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    out = {"n": n, "parts": n_parts, "partitioner": part,
           "precondition": precond, "slim": slim,
           "interior_inverse": interior_inverse,
           "matrix_free_gg": matrix_free_gg, "tol": tol,
           "max_iter": max_iter}
    t0 = time.perf_counter()
    coords, conn = meshgen.box_tet(n, n, n)
    N, M = coords.shape[0], conn.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    out.update(elements=M, nodes=N, mesh_seconds=time.perf_counter() - t0)
    log(f"mesh: M={M} c3d4, N={N}, parts={n_parts}")

    t0 = time.perf_counter()
    labels = partition_labels(coords, conn, n_parts, part)
    sizes = np.bincount(labels, minlength=n_parts)
    out.update(partition_seconds=time.perf_counter() - t0,
               part_sizes=(int(sizes.min()), int(sizes.max())),
               labels=labels)
    log(f"partition: {out['partition_seconds']:.2f}s  part sizes min/max="
        f"{sizes.min()}/{sizes.max()}")

    t0 = time.perf_counter()
    stages = {}
    sys_ = build_hybrid(coords, conn, "c3d4", E, NU, n_parts,
                        fixed_nodes=fixed, labels=labels,
                        dtype=torch.float32, precondition=precond,
                        slim=slim, interior_inverse=interior_inverse,
                        matrix_free_gg=matrix_free_gg, device=dev,
                        timings=stages)
    sync()
    m = sys_.meta
    out.update(build_seconds=time.perf_counter() - t0, build_stages=stages,
               n_interface=m.n_interface, nI_max=m.nI_max, nG_max=m.nG_max,
               resident_bytes=sys_.resident_bytes())
    log(f"build: {out['build_seconds']:.2f}s "
        f"({ {k: round(v, 3) for k, v in stages.items()} })  interface "
        f"nodes={m.n_interface}  nI_max={m.nI_max} nG_max={m.nG_max}")

    b = np.zeros((N, 3), np.float32)
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 1e3
    bt = torch.as_tensor(b, device=dev)
    bt[torch.as_tensor(fixed, device=dev).long()] = 0.0
    v0 = torch.zeros((m.n_interface, 3), dtype=torch.float32, device=dev)
    v0[0, 0] = 1.0
    sys_.schur_matvec(v0)
    sync()
    t0 = time.perf_counter()
    sys_.schur_matvec(v0)
    sync()
    t_mv = time.perf_counter() - t0
    if every is None:
        every = max_iter
    if tol_rel is not None:
        g = sys_._condense(sys_._force(bt))[1]
        tol = tol_rel * float(torch.linalg.norm(g))
    out.update(schur_matvec_ms=t_mv * 1e3, every=every, tol=tol,
               tol_rel=tol_rel)
    log(f"schur_matvec: warm {t_mv * 1e3:.2f} ms; chunk length {every}")

    runs = []
    for k in range(solves):
        t0 = time.perf_counter()
        u, info = sys_.solve_chunked(bt, tol=tol, max_iter=max_iter,
                                     every=every)
        rn = float(info.residual_norm)
        sync()
        h = np.asarray(info.history)
        runs.append(dict(seconds=time.perf_counter() - t0,
                         iterations=int(info.iterations),
                         status=int(info.status), residual_norm=rn,
                         history_last_rel=float(h[-1] / h[0]),
                         history=h))
        log(f"solve {k}: {runs[-1]['seconds']:.2f}s interface-CG iters="
            f"{int(info.iterations)} status={int(info.status)} "
            f"||r_S||={rn:.3e} (history {h[-1]:.3e}, {h[-1] / h[0]:.3e} "
            f"of ||g|| {h[0]:.3e})")
    out["solves"] = runs
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    u_ref = None
    if ref in ("packed", "refined"):
        from tpufem_torch import (PackedPartialOperator, PackedSystem,
                                  RefinedSystem)
        t0 = time.perf_counter()
        pop = PackedPartialOperator.build(coords, conn, "c3d4", E, NU,
                                          n_nodes=N, dtype=torch.float32,
                                          device=dev)
        psys = PackedSystem(pop, fixed_nodes=fixed)
        nb = float(np.linalg.norm(b.astype(np.float64)))
        if ref == "packed":
            u_ref, info_ref = psys.solve_chunked(
                b, tol=ref_tol_rel * nb, max_iter=ref_max_iter, every=500)
            ref_out = dict(iterations=int(info_ref.iterations),
                           status=int(info_ref.status))
        else:
            refined = RefinedSystem(psys, coords, conn, "c3d4", E, NU)
            u64, rinfo = refined.solve(b, tol_rel=ref_tol_rel)
            u_ref = u64.reshape(N, 3)
            ref_out = dict(iterations=rinfo.inner_iterations,
                           cycles=rinfo.cycles,
                           rel_residual=rinfo.rel_residual)
        sync()
        ur = u_ref.double()
        err = float((u.double() - ur).abs().max() / ur.abs().max())
        ref_out.update(kind=ref, seconds=time.perf_counter() - t0,
                       rel_displacement_diff=err)
        out["reference"] = ref_out
        log(f"vs {ref} reference ({ref_out}): rel displacement diff "
            f"{err:.2e}")
    return out, sys_, u, u_ref


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=26)
    ap.add_argument("n_parts", type=int, nargs="?", default=32)
    ap.add_argument("--part", default="rcb", choices=("rcb", "morton",
                                                      "grow"))
    ap.add_argument("--precond", default="bdd",
                    choices=("bdd", "nn", "jacobi"))
    ap.add_argument("--no-slim", dest="slim", action="store_false")
    ap.add_argument("--no-inverse", dest="inverse", action="store_false")
    ap.add_argument("--no-mf", dest="mf", action="store_false")
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--tol-rel", type=float, default=None,
                    help="tolerance relative to ||g|| (replaces --tol)")
    ap.add_argument("--max-iter", type=int, default=800)
    ap.add_argument("--every", type=int, default=None)
    ap.add_argument("--ref", default="packed",
                    choices=("packed", "refined", "none"))
    ap.add_argument("--ref-tol-rel", type=float, default=1e-5)
    ap.add_argument("--ref-max-iter", type=int, default=20000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    out, *_ = run(a.n, a.n_parts, a.part, a.precond, a.slim, a.inverse,
                  a.mf, a.tol, a.max_iter, a.every, a.tol_rel,
                  a.ref, a.ref_tol_rel, a.ref_max_iter, device=a.device)
    for r in out["solves"]:
        del r["history"]
    del out["labels"]
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
