#!/usr/bin/env python3
"""Drive tpufem_torch's two ported paths on one CUDA card: the refined
packed c3d10 solve and the assembled-stiffness static solve.

    python3 chip_smoke.py            # box_tet10(55): 1.00M elements, 4.1M DOF
    python3 chip_smoke.py --n 10     # a quick check at 6k elements

Phases (any failure exits non-zero, and the last line is then not
printed):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: every CUDA kernel from tpufem_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all at once;
  The refined packed solve:
  3. setup: mesh, packed plan and the f32 operator's geometry;
  4. parity: each kernel against its plain PyTorch version on the mesh's
     real tables, every bucket, seeded random inputs: bitwise in f32 (the
     kernels are built with -fmad=false), <= 1e-13 relative in f64; and
     the times of one sweep (all buckets) of each kernel and of its plain
     version from CUDA events (the kernel's includes the gaps while the
     host launches), beside the least time the card could take;
  5. main path, with every launch count set to 0 first: Jacobi system,
     f64 refinement, the refined solve (scripts/solve_scale.py's settings);
     fails unless the f64 true relative residual is <= 1e-6, the tip
     deflection is finite and negative, and every kernel launched;
  6. the operator-apply time (median of >= 20 applies) and each kernel's
     launches per apply; the f32 kernel operator against the independent
     f64 operator on the whole mesh, and the f64 operator's time;
  7. torch.profiler: a window of 100 PCG iterations (device time per
     iteration by kernel, and the device's busy share of the wall time),
     then each kernel's device time per sweep, the "ms" of the JSON line.
  The assembled-stiffness static solve (the same mesh and load: E =
  200e9, nu = 0.3, z = 0 fixed, -1e3 in z on the top face):
  8a. stiffness_fused (K6) against its plain version, bitwise, in f32 and
      f64: c3d10 on every element, c3d4, c3d8 and c3d6 on small curved
      meshes;
  8b. cluster_expand and cluster_compress (K7a, K7b) against their plain
      versions on every cluster, bitwise, f32 and f64;
  8c. f64 cross-checks (<= 1e-12 relative, max-norm): MatrixFreeOperator
      against the independent F64Operator, ClusteredOperator (apply and
      diagonal) against MatrixFreeOperator;
  8d. device time (torch.profiler) of K6, K7a, K7b and of both operators'
      applies, f32 and f64, beside their bounds; the plain versions' and
      the library yardsticks' times (torch.gather for K7a, scatter_add_
      for K7b) by CUDA events;
  8e. main path, every launch count set to 0 first:
      static_structure_solver(operator="clustered", f64, Jacobi, tol
      1e-6 ||b||); fails unless the status is CONVERGED, the F64Operator
      true relative residual is <= 1e-6, the tip deflection is finite and
      negative, and K6, K7a and K7b all launched;
  8f. torch.profiler over a window of 20 of its PCG iterations.
It then prints {"kernels": [...]} (the static kernels' numbers are
float64, the main path's type, with the float32 ones beside them), the
card's name and power limit, and, last, {"ok": true, "device": ...}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

E, NU = 200e9, 0.3
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
F32_FLOPS = 67e12                  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12                  # H100 SXM float64 outside the tensor cores
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `reps` runs, from CUDA events."""
    return statistics.median(event_times(fn, reps, warmup))


def event_times(fn, reps: int, warmup: int = 2):
    """Milliseconds of each of `reps` runs of fn(), from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def ptxas_digest(kernel) -> str:
    try:
        with open(kernel.log_path()) as f:
            lines = [ln.strip() for ln in f if "registers" in ln]
    except OSError:
        return "(no build log)"
    return "; ".join(ln.split("ptxas info    : ")[-1] for ln in lines)


def flops_per_element(dN: np.ndarray) -> int:
    """Floating-point operations of the partial-assembly action for one
    element, counted from the reference gradients' nonzero pattern as
    csrc/fused_yc.cu executes them (zero weights skipped)."""
    nz = dN != 0.0                                   # [q, k, 3]
    per_q = []
    for qi in range(dN.shape[0]):
        hhat = 3 * sum(2 * int(nz[qi, :, a].sum()) - 1 for a in range(3))
        h, tr, sig, t = 9 * 5, 2, 9 * 2 + 3 * 2 + 1, 9 * 6
        fe = 3 * sum(2 * int(nz[qi, kk, :].sum()) for kk in range(dN.shape[1]))
        per_q.append(hhat + h + tr + sig + t + fe)
    return int(sum(per_q))


def bounds(op, itemsize: int, n_elements: int):
    """(bytes, flops) each kernel's sweep must move / do on these tables:
    every input read once, every output written once; only the table
    columns a bucket uses (its window width, its incidence words)."""
    p = op.plan
    m = p.meta
    k, E_c = m.nodes_per_elem, m.elems_per_cluster
    qJ, q = op.Jinv.shape[1] // 9, op.W.shape[1]
    fy = cg = 0
    for gi, (s, n, wk) in enumerate(m.c_groups):
        if wk == 0 or n == 0:
            continue
        words = p.cinc[gi].shape[1] * 128 * 4
        fy += n * (wk * 4 + 2 * 128 * 4 + k * E_c * 4 + words
                   + (qJ * 9 + q) * E_c * itemsize + 384 * itemsize)
        cg += n * (3 * k * E_c * itemsize + words + 384 * itemsize)
    fy += m.n_blocks * 384 * itemsize                 # X, read once
    cb = m.n_clusters * 384 * itemsize + m.n_blocks * 384 * itemsize
    entries = 0
    for (s, n, wk) in m.b_groups:
        if wk == 0 or n == 0:
            continue
        cb += n * (wk * 4 + -(-wk // 4) * 128 * 4)
        si = p.slotidx[s:s + n, :-(-wk // 4)]
        entries += int(sum(((si >> (8 * b)) & 0xFF).ne(0).sum().item()
                           for b in range(4)))
    slots = sum(int(((c >> (8 * b)) & 0xFF).ne(0).sum().item())
                for c in p.cinc for b in range(4))
    fl_fy = n_elements * flops_per_element(op.dN) + 3 * slots
    return {"fused_yc": (fy, fl_fy), "combine": (cb, 3 * entries),
            "compress_gather": (cg, 3 * slots)}


def device_times(fn, reps: int):
    """[(kernel, ms, launches)] summed over `reps` calls of fn from
    torch.profiler's device records, longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])


def bound_ms(nbytes: int, flops: int):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def packed_phase(args, dev):
    """The refined packed c3d10 solve (phases 3-7 of the module
    docstring).  Returns its {"kernels"} rows and the refined tip uz
    mean."""
    import tpufem_torch as tt
    from tpufem_torch.ops import fused_kernels as fk, packed_kernels as pk

    # 3. setup
    n = args.n
    t0 = time.perf_counter()
    coords, conn = tt.meshgen.box_tet10(n, n, n)
    N, M = coords.shape[0], conn.shape[0]
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = tt.PackedPlan.build(coords, conn, N, device=dev)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                        plan=plan, dtype=torch.float32,
                                        device=dev)
    torch.cuda.synchronize()
    t_geom = time.perf_counter() - t0
    m = plan.meta
    log(f"setup: box_tet10({n}) {M} elements, {N} nodes, {3 * N} DOF; "
        f"mesh {t_mesh:.2f} s, plan {t_plan:.2f} s, geometry {t_geom:.2f} s")
    log(f"  plan: B={m.n_clusters} Nb={m.n_blocks} Rp={m.lanes} "
        f"Wn={m.win_n} Wc={m.win_c} c_groups={list(m.c_groups)} "
        f"b_groups={list(m.b_groups)} cv_widths={list(m.cv_widths)} "
        f"qJ={op.Jinv.shape[1] // 9}")

    # 4. parity and kernel times: each kernel's stage of the operator (one
    # sweep over all of its buckets), through the kernel or its plain version
    ops = {torch.float32: op, torch.float64: tt.PackedPartialOperator(
        plan, op.Jinv.double(), op.W.double(), op.dN, *op.lam_mu)}
    rng = np.random.default_rng(args.seed)
    X = torch.as_tensor(rng.standard_normal((m.n_blocks, 384)),
                        dtype=torch.float32, device=dev)
    Yr = torch.as_tensor(rng.standard_normal((m.n_clusters, 384)),
                         dtype=torch.float32, device=dev)
    Fe = torch.as_tensor(rng.standard_normal((m.n_clusters, 3, m.lanes)),
                         dtype=torch.float32, device=dev)
    stages = {"fused_yc": ("fused_stage", X, fk.fused_yc_plain),
              "combine": ("combine_stage", Yr, pk.combine_plain),
              "compress_gather": ("compress_stage", Fe,
                                  pk.compress_gather_plain)}

    def sweep(name, dt=torch.float32, plain=False):
        """One sweep of kernel `name` (or of its plain version) as a
        callable, on the seeded input in dtype dt."""
        method, x, plain_fn = stages[name]
        fn, xd = getattr(ops[dt], method), x.to(dt)
        if plain:
            return lambda: fn(xd, kernel=plain_fn)
        return lambda: fn(xd)

    parity = {}
    for K in tt.PACKED_KERNELS:
        got, want = sweep(K.name)(), sweep(K.name, plain=True)()
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"{K.name} f32 differs from its plain version: "
                 f"max |d| {err32:.3e} (max |ref| "
                 f"{float(want.abs().max()):.3e})")
        got = sweep(K.name, torch.float64)()
        want = sweep(K.name, torch.float64, plain=True)()
        torch.cuda.synchronize()
        rel64 = float((got - want).abs().max() / want.abs().max())
        if not rel64 <= 1e-13:
            fail(f"{K.name} f64 relative error {rel64:.3e} > 1e-13")
        parity[K.name] = (err32, rel64)
        log(f"parity {K.name}: f32 bitwise equal (max |d| {err32:.1e}), "
            f"f64 max rel {rel64:.1e}")
    del got, want, ops[torch.float64]

    times = {}
    nb = bounds(op, 4, M)
    for K in tt.PACKED_KERNELS:
        sweep_ms = time_ms(sweep(K.name), args.reps)
        plain_ms = time_ms(sweep(K.name, plain=True), 3, warmup=1)
        b_ms, b_by = bound_ms(*nb[K.name])
        times[K.name] = (sweep_ms, plain_ms, b_ms, b_by)
        log(f"time {K.name}: {sweep_ms:.4f} ms per sweep by CUDA events, "
            f"host launches included (plain {plain_ms:.3f} ms); bound "
            f"{b_ms:.4f} ms by {b_by} ({nb[K.name][0]} bytes, "
            f"{nb[K.name][1]} flops)")

    # 5. main path: every count 0 just before, read just after
    fixed = tt.meshgen.boundary_nodes(coords, 2, 0.0)
    top = tt.meshgen.boundary_nodes(coords, 2, 1.0)
    b = np.zeros((N, 3), np.float32)
    b[top, 2] = -1e3
    for K in tt.PACKED_KERNELS:
        K.launches = 0
    t0 = time.perf_counter()
    system = tt.PackedSystem(op, fixed_nodes=fixed, precondition="jacobi")
    ref = tt.RefinedSystem(system, coords, conn, "c3d10", E, NU)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    u, info = ref.solve(
        b, tol_rel=1e-6, inner_tol=5e-3, inner_max_iter=1500, every=500,
        progress=lambda cy, it, rr: log(
            f"  cycle {cy} (inner iterations {it}): f64 true rel residual "
            f"{rr:.3e} [{time.perf_counter() - t0:.1f} s]"))
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {K.name: K.launches for K in tt.PACKED_KERNELS}
    uz = u.reshape(N, 3)[torch.as_tensor(top, device=dev).long(), 2]
    tip = float(uz.mean())
    log(f"main path: system+refinement setup {t_setup:.2f} s, solve "
        f"{t_solve:.2f} s, cycles {info.cycles}, inner iterations "
        f"{info.inner_iterations}, outer history (rel) "
        f"{[float(h / info.outer_history[0]) for h in info.outer_history]}, "
        f"f64 true rel residual {info.rel_residual:.3e}, tip uz mean "
        f"{tip:.6e}, launches {launches}")
    if not info.rel_residual <= 1e-6:
        fail(f"f64 true relative residual {info.rel_residual:.3e} > 1e-6")
    if not (np.isfinite(tip) and tip < 0):
        fail(f"tip uz mean {tip} is not finite and negative")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")

    # 6. apply time, launches per apply, kernel operator vs f64 operator
    X0 = plan.pack_flat(u.to(torch.float32))
    apply_ms = time_ms(lambda: op(X0), max(args.reps, 20))
    for K in tt.PACKED_KERNELS:
        K.launches = 0
    op(X0)
    per_apply = {K.name: K.launches for K in tt.PACKED_KERNELS}
    uf = torch.as_tensor(rng.standard_normal(3 * N), device=dev)
    F64 = ref.op64(uf)
    F32 = plan.unpack_flat(op(plan.pack_flat(uf, torch.float32)),
                           torch.float64)
    op_rel = float((F32 - F64).abs().max() / F64.abs().max())
    f64_ms = time_ms(lambda: ref.op64(uf), 3, warmup=1)
    log(f"apply: {apply_ms:.4f} ms median of {max(args.reps, 20)}; launches "
        f"per apply {per_apply}; f32 kernel operator vs f64 operator max "
        f"rel {op_rel:.2e}; f64 operator (refinement residual) "
        f"{f64_ms:.3f} ms median of 3")
    if not op_rel <= 1e-4:
        fail(f"kernel operator disagrees with the f64 operator: {op_rel:.2e}")

    # 7. device time from torch.profiler, last: a profiler leaves the
    # host's later launches slower.  A PCG window of the main path's chunk
    # solve (tol 0: every iteration runs), then each kernel's sweep.
    iters = 100
    bX = plan.pack(torch.as_tensor(b, device=dev))
    bX = bX / torch.linalg.norm(bX)

    def pcg():
        system.solve_chunked_packed(bX, tol=0.0, max_iter=iters, every=iters)

    pcg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcg()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_times(pcg, 1)
    if not prof:
        fail("torch.profiler recorded no device time")
    dev_ms = sum(r[1] for r in prof)
    by = {K.name: sum(r[1] for r in prof if f"{K.name}_kernel" in r[0])
          for K in tt.PACKED_KERNELS}
    by["other"] = dev_ms - sum(by.values())
    log(f"profile: {iters} PCG iterations, {wall_ms / iters:.4f} ms per "
        f"iteration (host clock, unprofiled); device {dev_ms / iters:.4f} ms "
        f"per iteration, busy {dev_ms / wall_ms:.1%}; device ms per "
        f"iteration by kernel "
        f"{ {k: round(v / iters, 4) for k, v in by.items()} }")
    for name, ms, count in prof[:8]:
        log(f"  {ms / iters:.4f} ms/it  {count / iters:.1f} launches/it  "
            f"{name[:90]}")
    kernel_ms = {}
    for K in tt.PACKED_KERNELS:
        rows_k = device_times(sweep(K.name), args.reps)
        kernel_ms[K.name] = sum(r[1] for r in rows_k
                                if f"{K.name}_kernel" in r[0]) / args.reps
        if not kernel_ms[K.name] > 0:
            fail(f"torch.profiler recorded no device time for {K.name}")
        share = times[K.name][2] / kernel_ms[K.name]
        log(f"device time {K.name}: {kernel_ms[K.name]:.4f} ms per sweep "
            f"(torch.profiler, {args.reps} sweeps); the bound is {share:.1%}"
            f" of it")

    rows = []
    for K in tt.PACKED_KERNELS:
        sweep_ms, plain_ms, b_ms, b_by = times[K.name]
        rows.append(dict(
            name=K.name, route="cuda",
            source=f"tpufem_torch/csrc/{K.source}", replaces=K.replaces,
            launches=launches[K.name], max_abs_err=parity[K.name][0],
            ms=kernel_ms[K.name], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, sweep_ms=sweep_ms,
            launches_per_apply=per_apply[K.name],
            f64_max_rel_err=parity[K.name][1]))
    return rows, tip


# the other k <= 10 instantiations of K6, each on a small curved mesh
K6_SMALL = {"c3d4": ("box_tet", (20, 20, 20)), "c3d8": ("box_hex", (24, 24, 24)),
            "c3d6": ("box_wedge", (20, 20, 20))}


def stiffness_flops(dN: np.ndarray) -> int:
    """Floating-point operations of K6 for one element, counted from the
    reference gradients' nonzero pattern as csrc/stiffness.cu executes
    them, over the k (k + 1) / 2 node pairs the function needs (the
    kernel recomputes the mirrored pairs)."""
    q, k, _ = dN.shape
    nz = dN != 0.0
    total = 0
    for qi in range(q):
        jac = 3 * sum(2 * int(nz[qi, :, a].sum()) - 1 for a in range(3))
        inv = 9 * 3 + 5 + 1 + 9 + 2          # cofactors, det, 1/det, J^-1, W
        grad = 3 * sum(2 * int(nz[qi, kk].sum()) - 1 for kk in range(k))
        pair = 6 + 9 * 6 + 3 + (9 if qi else 0)
        total += jac + inv + grad + pair * k * (k + 1) // 2
    return total


def bound_ms_dt(nbytes: int, flops: int, dt):
    peak = F32_FLOPS if dt == torch.float32 else F64_FLOPS
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def kernel_device_ms(fn, reps: int, key: str, tries: int = 3) -> float:
    """Device ms per call of fn in the kernels whose name holds `key`
    (torch.profiler).  A profile that holds no record of the kernel is
    taken again, up to `tries` times in all."""
    for attempt in range(tries):
        rows = device_times(fn, reps)
        ms = sum(r[1] for r in rows if key in r[0]) / reps
        if ms > 0:
            return ms
        log(f"  torch.profiler recorded no {key} (attempt {attempt + 1}); "
            f"device records: {[r[0][:60] for r in rows[:4]]}")
    fail(f"torch.profiler recorded no device time for {key}")


def total_device_ms(fn, reps: int) -> float:
    return sum(r[1] for r in device_times(fn, reps)) / reps


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def static_phase(args, dev, tip_packed):
    """The assembled-stiffness static solve (phase 8 of the module
    docstring).  Returns its {"kernels"} rows."""
    import tpufem_torch as tt
    from tpufem_torch.ops import cluster_kernels as ck
    from tpufem_torch.ops import stiffness_kernels as sk

    f32, f64 = torch.float32, torch.float64
    n = args.n
    t0 = time.perf_counter()
    coords, conn = tt.meshgen.box_tet10(n, n, n)
    N, M = coords.shape[0], conn.shape[0]
    conn_t = torch.as_tensor(conn, device=dev)
    log(f"static: box_tet10({n}) {M} c3d10 elements, {N} nodes, "
        f"{6 * N} DOF in the [N, 6] state; mesh "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(args.seed + 1)
    res = {K.name: {} for K in tt.STATIC_KERNELS}

    # 8a. K6 against its plain version: c3d10 on every element, then the
    # other instantiations on small curved meshes; both dtypes, bitwise
    Ks = {}
    for dt in (f64, f32):
        ct = torch.as_tensor(coords, dtype=dt, device=dev)
        got = sk.stiffness_fused(ct, conn_t, "c3d10", E, NU)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sk.stiffness_fused_plain(ct, conn_t, "c3d10", E, NU)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"stiffness_fused c3d10 {dt} differs from its plain "
                 f"version: max |d| {err:.3e} (max |K| "
                 f"{float(want.abs().max()):.3e})")
        del want
        res["stiffness_fused"][dt] = dict(err=err, plain_ms=plain_ms)
        Ks[dt] = got
        log(f"parity stiffness_fused c3d10 {str(dt)[6:]}: bitwise equal on "
            f"{M} elements; plain version {plain_ms:.1f} ms (host clock)")
    torch.cuda.empty_cache()
    for et, (gen, dims) in K6_SMALL.items():
        c, cn = getattr(tt.meshgen, gen)(*dims)
        c = c.copy()
        c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
        for dt in (f32, f64):
            ct = torch.as_tensor(c, dtype=dt, device=dev)
            got = sk.stiffness_fused(ct, cn, et, E, NU)
            want = sk.stiffness_fused_plain(ct, cn, et, E, NU)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"stiffness_fused {et} {dt} differs from its plain "
                     f"version: max |d| "
                     f"{float((got - want).abs().max()):.3e}")
        log(f"parity stiffness_fused {et}: bitwise equal in f32 and f64 on "
            f"{cn.shape[0]} elements")
    del got, want

    # 8b. K7a/K7b against their plain versions on every cluster
    t0 = time.perf_counter()
    cplan = tt.ClusterPlan.build(conn, N, 3, device=dev)
    torch.cuda.synchronize()
    t_cplan = time.perf_counter() - t0
    B, L, E_c = cplan.n_clusters, cplan.l_max, cplan.elems_per_cluster
    lc = cplan.lconn.reshape(B, -1)
    R = lc.shape[1]
    log(f"  cluster plan: {t_cplan:.2f} s; B={B} E_c={E_c} L={L} R={R} "
        f"combine widths {cplan.combine.widths}")
    Uc0 = rng.standard_normal((B, L, 3))
    Fe0 = rng.standard_normal((B, R, 3))
    ins = {}
    for dt in (f64, f32):
        Uc = torch.as_tensor(Uc0, dtype=dt, device=dev)
        Fe = torch.as_tensor(Fe0, dtype=dt, device=dev)
        ins[dt] = (Uc, Fe)
        for name, got, want in (
                ("cluster_expand", ck.cluster_expand(lc, Uc),
                 ck.cluster_expand_plain(lc, Uc)),
                ("cluster_compress", ck.cluster_compress(lc, Fe, L),
                 ck.cluster_compress_plain(lc, Fe, L))):
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                fail(f"{name} {dt} differs from its plain version: "
                     f"max |d| {err:.3e}")
            res[name][dt] = dict(err=err)
        log(f"parity cluster_expand, cluster_compress {str(dt)[6:]}: bitwise "
            f"equal on {B} clusters")

    # 8c. cross-checks in f64: the assembled operator against the
    # independent geometry-factor operator, the clustered one against it
    t0 = time.perf_counter()
    splan = tt.ScatterPlan.build(conn, N, 3, device=dev)
    torch.cuda.synchronize()
    t_splan = time.perf_counter() - t0
    mfs = {dt: tt.MatrixFreeOperator(Ks[dt], splan) for dt in (f64, f32)}
    cops = {dt: tt.ClusteredOperator.build(Ks[dt], conn, N, 3, plan=cplan)
            for dt in (f64, f32)}
    del Ks
    t0 = time.perf_counter()
    op64 = tt.F64Operator(coords, conn, "c3d10", E, NU,
                          geometry_dtype=f64, device=dev)
    t_op64 = time.perf_counter() - t0
    u0 = rng.standard_normal((N, 3))
    u = torch.as_tensor(u0, dtype=f64, device=dev)
    F_mf = mfs[f64](u)
    F_ref = op64(u.reshape(-1)).reshape(N, 3)
    F_cl = cops[f64](u)
    rel_mf = max_rel(F_mf, F_ref)
    rel_cl = max_rel(F_cl, F_mf)
    rel_dg = max_rel(cops[f64].diagonal(), mfs[f64].diagonal())
    log(f"cross-check f64: scatter plan {t_splan:.2f} s, F64Operator "
        f"{t_op64:.2f} s; MatrixFreeOperator vs F64Operator max rel "
        f"{rel_mf:.2e}; ClusteredOperator vs MatrixFreeOperator apply "
        f"{rel_cl:.2e}, diagonal {rel_dg:.2e}")
    for what, rel in (("MatrixFreeOperator vs F64Operator", rel_mf),
                      ("ClusteredOperator apply", rel_cl),
                      ("ClusteredOperator diagonal", rel_dg)):
        if not rel <= 1e-12:
            fail(f"{what}: max rel {rel:.3e} > 1e-12")
    del F_mf, F_ref, F_cl

    # 8d. times (torch.profiler device time; plain versions and the
    # library yardsticks by CUDA events), both dtypes
    reps = max(args.reps // 4, 3)
    lcl = lc.long().unsqueeze(-1).expand(-1, -1, 3)
    ops_ms = {}
    for dt in (f64, f32):
        item = 4 if dt == f32 else 8
        ct = torch.as_tensor(coords, dtype=dt, device=dev)
        Uc, Fe = ins[dt]
        k6 = lambda: sk.stiffness_fused(ct, conn_t, "c3d10", E, NU)  # noqa: E731
        ms6 = kernel_device_ms(k6, 10, "stiffness_kernel")
        ev6 = event_times(k6, 10, warmup=1)
        log(f"  stiffness_fused {str(dt)[6:]} per call by CUDA events, 10 "
            f"calls: min {min(ev6):.4f}, median "
            f"{statistics.median(ev6):.4f}, max {max(ev6):.4f} ms")
        msa = kernel_device_ms(lambda: ck.cluster_expand(lc, Uc), reps,
                               "cluster_expand_kernel")
        msb = kernel_device_ms(lambda: ck.cluster_compress(lc, Fe, L), reps,
                               "cluster_compress_kernel")
        res["stiffness_fused"][dt].update(
            ms=ms6, library_ms=None, bound=bound_ms_dt(
                M * 10 * 4 + N * 3 * item + M * 900 * item,
                M * stiffness_flops(tt.element_table("c3d10").dN), dt))
        res["cluster_expand"][dt].update(
            ms=msa, plain_ms=time_ms(lambda: ck.cluster_expand_plain(lc, Uc),
                                     3, warmup=1),
            library_ms=time_ms(lambda: torch.gather(Uc, 1, lcl), reps),
            bound=bound_ms_dt(B * R * 4 + B * L * 3 * item
                              + B * R * 3 * item, 0, dt))
        res["cluster_compress"][dt].update(
            ms=msb, plain_ms=time_ms(
                lambda: ck.cluster_compress_plain(lc, Fe, L), 1, warmup=0),
            library_ms=time_ms(
                lambda: Fe.new_zeros((B, L, 3)).scatter_add_(1, lcl, Fe),
                reps),
            bound=bound_ms_dt(B * R * 4 + B * R * 3 * item
                              + B * L * 3 * item, B * R * 3, dt))
        ud = u.to(dt)
        k_bytes = M * 900 * item
        mf_ms = total_device_ms(lambda: mfs[dt](ud), reps)
        cl_ms = total_device_ms(lambda: cops[dt](ud), reps)
        ops_ms[dt] = (mf_ms, cl_ms, k_bytes / HBM_BYTES_PER_S * 1e3)
        for name in ("stiffness_fused", "cluster_expand", "cluster_compress"):
            r = res[name][dt]
            b_ms, b_by = r["bound"]
            log(f"time {name} {str(dt)[6:]}: {r['ms']:.4f} ms device "
                f"(torch.profiler); bound {b_ms:.4f} ms by {b_by} "
                f"({b_ms / r['ms']:.1%} of it); plain {r['plain_ms']:.3f} ms"
                + (f"; library {r['library_ms']:.4f} ms"
                   if r["library_ms"] is not None else ""))
        log(f"time apply {str(dt)[6:]}: MatrixFreeOperator {mf_ms:.4f} ms, "
            f"ClusteredOperator {cl_ms:.4f} ms device per apply (all "
            f"kernels, torch.profiler); streaming K alone takes "
            f"{ops_ms[dt][2]:.4f} ms at 3.35 TB/s")
    del mfs, cops, ins, ct, Uc, Fe, lcl, u, ud, splan
    torch.cuda.empty_cache()

    # 8e. main path: the clustered static solve through the entry point,
    # every count 0 just before, read just after
    fixed = tt.meshgen.boundary_nodes(coords, 2, 0.0)
    top = tt.meshgen.boundary_nodes(coords, 2, 1.0)
    force = np.zeros((N, 6))
    force[top, 2] = -1e3
    bnorm = float(np.linalg.norm(force))
    material = {"E": E, "nu": NU}
    torch.cuda.reset_peak_memory_stats(dev)
    for K in tt.KERNELS:
        K.launches = 0
    timings = {}
    t0 = time.perf_counter()
    u6, info = tt.static_structure_solver(
        coords, force, fixed, material=material, c3d10=conn,
        operator="clustered", precondition=True, dtype=f64,
        tol=1e-6 * bnorm, max_iter=10000, device=dev, timings=timings)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = {K.name: K.launches for K in tt.STATIC_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    status, iters = int(info.status), int(info.iterations)
    # the true residual through the independent f64 operator, the fixed
    # DOFs projected out
    mask = torch.ones((N, 3), dtype=f64, device=dev)
    mask[torch.as_tensor(fixed, device=dev).long()] = 0.0
    b3 = torch.as_tensor(force[:, :3], device=dev) * mask
    u3 = u6[:, :3].contiguous()
    r = (b3 - op64(u3.reshape(-1)).reshape(N, 3)) * mask
    true_rel = float(torch.linalg.norm(r) / torch.linalg.norm(b3))
    tip = float(u3[torch.as_tensor(top, device=dev).long(), 2].mean())
    tip_d = abs(tip - tip_packed) / abs(tip_packed)
    setup_s = sum(timings[k] for k in ("stiffness", "plans", "operator",
                                       "jacobi"))
    log(f"main path (static): status {status}, iterations {iters}, "
        f"recurrence residual {float(info.residual_norm) / bnorm:.3e} of "
        f"||b||, F64Operator true rel residual {true_rel:.3e}; setup "
        f"{setup_s:.2f} s (stiffness {timings['stiffness']:.2f}, cluster "
        f"plan {timings['plans']:.2f}, operator {timings['operator']:.2f}, "
        f"Jacobi {timings['jacobi']:.2f}), solve {timings['solve']:.2f} s "
        f"({timings['solve'] / max(iters, 1) * 1e3:.3f} ms per iteration, "
        f"derived), entry point {t_total:.2f} s; peak device memory "
        f"{peak_gb:.2f} GB; tip uz mean {tip:.6e} (refined packed solve "
        f"{tip_packed:.6e}, rel diff {tip_d:.2e}); launches {launches}")
    if status != 1:
        fail(f"static solve status {status} (1 = CONVERGED)")
    if not true_rel <= 1e-6:
        fail(f"static solve true relative residual {true_rel:.3e} > 1e-6")
    if not (np.isfinite(tip) and tip < 0):
        fail(f"static solve tip uz mean {tip} is not finite and negative")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the static path")
    del u6, u3, r, b3, mask

    # 8f. where a solve iteration's time goes: a profiled window of 20 PCG
    # iterations on the same model (tol 0: every iteration runs)
    model = tt.build_static_model(coords, {"c3d10": conn}, material,
                                  dtype=f64, operator="clustered", device=dev)
    b6 = torch.as_tensor(force, device=dev)
    d6 = model.diagonal6()
    live = (d6.abs() > 0).to(f64)
    Minv = model.jacobi_preconditioner(d6)
    cons = tt.Constraints.fixed(N, fixed, 6)
    iters_w = 20

    def pcg():
        tt.cg(model, b6 * live, constraints=cons, M_inv=Minv, tol=0.0,
              max_iter=iters_w)

    pcg()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcg()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = device_times(pcg, 1)
    dev_ms = sum(r[1] for r in prof)
    log(f"profile (static): {iters_w} PCG iterations, "
        f"{wall_ms / iters_w:.4f} ms per iteration (host clock, "
        f"unprofiled); device {dev_ms / iters_w:.4f} ms per iteration, busy "
        f"{dev_ms / wall_ms:.1%}")
    for name, ms, count in prof[:10]:
        log(f"  {ms / iters_w:.4f} ms/it  {count / iters_w:.1f} launches/it  "
            f"{name[:90]}")
    for K in tt.STATIC_KERNELS:
        K.launches = 0
    model(b6)
    per_apply = {K.name: K.launches for K in tt.STATIC_KERNELS}
    del model

    rows = []
    for K in tt.STATIC_KERNELS:
        r64, r32 = res[K.name][f64], res[K.name][f32]
        rows.append(dict(
            name=K.name, route="cuda",
            source=f"tpufem_torch/csrc/{K.source}", replaces=K.replaces,
            launches=launches[K.name], max_abs_err=r64["err"],
            ms=r64["ms"], plain_ms=r64["plain_ms"], bound_ms=r64["bound"][0],
            bound_by=r64["bound"][1], library_ms=r64["library_ms"],
            dtype="float64", launches_per_apply=per_apply[K.name],
            f32=dict(ms=r32["ms"], plain_ms=r32["plain_ms"],
                     bound_ms=r32["bound"][0], library_ms=r32["library_ms"],
                     max_abs_err=r32["err"])))
    log(f"static applies (device ms per apply; bound = streaming K): "
        f"{ {str(dt)[6:]: [round(x, 4) for x in v] for dt, v in ops_ms.items()} }")
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=55,
                    help="box_tet10(n, n, n): 6 n^3 c3d10 elements")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card")
    import tpufem_torch as tt
    from tpufem_torch.ops import cuda

    # 1. device
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(f"device: {kind} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)                      # name, power limit (as nvidia-smi gives them)

    # 2. build
    t0 = time.perf_counter()
    built = cuda.build(tt.KERNELS)
    log(f"build: {time.perf_counter() - t0:.2f} s for {built or 'none'} "
        f"(nvcc {' '.join(cuda.NVCC_FLAGS)})")
    for K in tt.KERNELS:
        log(f"  ptxas {K.name}: {ptxas_digest(K)}")

    t0 = time.perf_counter()
    rows, tip = packed_phase(args, dev)
    torch.cuda.empty_cache()
    log(f"phase packed: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows += static_phase(args, dev, tip)
    log(f"phase static: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
