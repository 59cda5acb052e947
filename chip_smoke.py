#!/usr/bin/env python3
"""Drive tpufem_torch's ported paths and its three probes on one CUDA
card: the refined packed c3d10 solve, the assembled-stiffness static
solve, the staged packed pipeline under the block-Jacobi refined solve,
the relayout, row-read and planar-I/O probes, the converged refined solve
at tpufem's largest size, the rest of the solver family with the mixed
solid + shell driver, Schur substructuring at BASELINE config 4 with
the remaining operators, the reference's end-to-end SimJEB workload
with the io, profiling and checkpoint tools and the examples, and the
four distributed systems on a part mesh (the packed halo system at
box_tet10(95) in four parts).  Every PCG
and BiCGStab solve runs its 32-iteration blocks, and GMRES each restart
cycle, as CUDA graphs.

    python3 chip_smoke.py            # box_tet10(55): 1.00M elements, 4.1M
                                     # DOF; phase 11 at box_tet10(119)
    python3 chip_smoke.py --n 10 --scale-n 20 --mixed-n 8 --plate-n 16 \
        --hybrid-n 12 --hybrid-parts 32 --bsr-n 6 --workload-n 10 \
        --dist-n 20                  # a quick check
    python3 chip_smoke.py --phases staged   # some paths (packed, static,
                    # staged, probes, scale, family, hybrid, workload, dist)
    python3 chip_smoke.py --phases turns    # K6, K5b and K3 alone (run
                        # from copies of two trees in turns to compare them)

Phases (any failure exits non-zero, and the last line is then not
printed):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: every CUDA kernel from tpufem_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all at once; each instantiation's demangled name,
     registers, shared memory and spills (-Xptxas -v); fails if an
     instantiation of fused_yc (f32 or f64) or an f32 one of combine,
     cluster_expand, cluster_compress, stiffness_fused or compress_planar
     spills;
  The refined packed solve:
  3. setup: mesh, packed plan and the f32 operator's geometry;
  4. parity: each kernel against its plain PyTorch version on the mesh's
     real tables, every bucket, seeded random inputs: bitwise in f32 (the
     kernels are built with -fmad=false), <= 1e-13 relative in f64 (combine,
     one launch over all rows at the plan's row widths, also bitwise in
     f64, and its plain version bitwise against the plain version bucket
     by bucket); and
     the times of one sweep (all buckets) of each kernel and of its plain
     version from CUDA events (the kernel's includes the gaps while the
     host launches), beside the least time the card could take;
  5. main path, with every launch count set to 0 first: Jacobi system,
     f64 refinement, the refined solve (scripts/solve_scale.py's settings),
     its PCG blocks replayed as CUDA graphs; fails unless the f64 true
     relative residual is <= 1e-6, the tip deflection is finite and
     negative, every kernel launched, and fused_yc and combine were
     launched by graph replays (each replay adds the launches its capture
     recorded); prints the counters cg.blocks, cg.fused_blocks and the
     cg kernels' launches, and fails unless every block ran cg's fused
     step (cg_pap, cg_update_r, cg_update_p once each an iteration slot);
  6. the operator-apply time (median of >= 20 applies) and each kernel's
     launches per apply; the f32 kernel operator against the independent
     f64 operator on the whole mesh, and the f64 operator's time;
  7. torch.profiler: a window of 100 PCG iterations through the CUDA
     graphs, and the same window with the blocks run eagerly (device time
     per iteration by kernel, the device's busy share of the wall time,
     the median host clock of five unprofiled windows, and host over
     device for both); cg's fused graphed loop against the unfused body
     (the same system, M^-1 as a callable), f32 and then f64 (an f64
     system on the same plan), profiler windows in turns (fused, unfused,
     unfused, fused): device ms an iteration by kernel and `other`; the
     three cg kernels against their plain versions at the mesh's size
     (bitwise over a running, a NOT_SPD and a stopped step, f32 and f64),
     each one's device ms a launch, plain ms and bound (their rows in the
     JSON line, f64 beside);
     then each kernel's device time per sweep, the "ms" of the JSON line;
     K1's sweep against the K4 expand + K3 compress_gather sweeps on the
     same tables, six profiler windows each taken in turns (min, median,
     max; K1's "ms" is the median), and the registers, blocks and warps
     an SM of its c3d10 instantiations on the plan (f32, f64) and the
     registers of the others; K2's sweep in
     turns with its index_add_ yardstick the same way (its "ms" and
     "library_ms" are the medians of the device times).
  The assembled-stiffness static solve (the same mesh and load: E =
  200e9, nu = 0.3, z = 0 fixed, -1e3 in z on the top face):
  8a. stiffness_fused (K6) against its plain version, bitwise, in f32 and
      f64: c3d10 on every element, c3d4, c3d8 and c3d6 on small curved
      meshes; each of the four at M = 1 and at M one past three times the
      kernel's elements per block, and M = 0 without a launch;
  8b. cluster_expand and cluster_compress (K7a, K7b) against their plain
      versions on every cluster, bitwise, f32 and f64; and with 6 values
      per node on a box_tet10(20) cluster plan;
  8c. f64 cross-checks (<= 1e-12 relative, max-norm): MatrixFreeOperator
      against the independent F64Operator, ClusteredOperator (apply and
      diagonal) against MatrixFreeOperator;
  8d. device time (torch.profiler) of K6 (median of five windows, and
      its instantiations' registers and spills), K7a, K7b and of both
      operators' applies, f32 and f64, beside their bounds; K7a and K7b
      in turns with
      their library yardsticks (torch.gather, scatter_add_: library,
      kernel, kernel, library), six profiler windows each (min, median,
      max; "ms" and "library_ms" are the medians); the plain versions'
      times by CUDA events;
  8e. main path, every launch count set to 0 first:
      static_structure_solver(operator="clustered", f64, Jacobi, tol
      1e-6 ||b||); fails unless the status is CONVERGED, the F64Operator
      true relative residual is <= 1e-6, the tip deflection is finite and
      negative, K6, K7a and K7b all launched, and K7a and K7b by graph
      replays;
  8f. torch.profiler over a window of 20 of its PCG iterations (the
      median host clock of five unprofiled windows beside it).
  The staged packed pipeline (same mesh, plan and load; f32 operator with
  fuse=""):
  9a. expand, expand_planar and compress_planar (K4, K5a, K5b) against
      their plain versions on every bucket: bitwise in f32, <= 1e-13
      relative in f64 (K5b bitwise in f64 too, and bitwise equal to
      compress_gather on the transposed input); expand also on a
      box_tet10(10) plan with
      elems_per_cluster=24 (lanes straddle the 128-lane chunks); fused_yc's
      c3d4 and c3d8 instantiations bitwise on small curved meshes;
  9b. the staged operator against the fused one (apply, diagonal, block
      diagonal: <= 1e-6 relative), and the planar pipeline
      (probe_fused.fused_apply "planar", which counts K5a's and K5b's
      launches) bitwise equal to the staged one;
  9c. main path, every launch count set to 0 first: PackedSystem
      (precondition="block") under RefinedSystem, the settings of phase 5;
      fails unless the f64 true relative residual is <= 1e-6, the tip
      deflection is finite, negative and within 1e-4 (relative) of phase
      5's, and expand, compress_gather and combine all launched, each by
      graph replays;
  9d. device and host-clock ms per apply of the staged, planar and fused
      pipelines and of the element math (pa_apply_planar) alone;
      torch.profiler over 20 block-Jacobi PCG iterations; each new
      kernel's device ms per sweep, bound, plain ms and library yardstick
      (torch.take for K4/K5a, index_add_ for K5b; phase 4 adds index_add_
      for K2/K3); K5b's sweep in turns with K3's on the same tables (six
      windows each; K5b's "ms" is the median) and its registers and
      spills; 9a adds K1's c3d4 and c3d8 device ms and bounds on
      curved box_tet(n) and box_hex(m) meshes of about 6 n^3 elements,
      with their registers, blocks and warps an SM on those plans.
  The probes (no mesh; B = 39,360, box_tet10(55)'s cluster count):
  10a. relayout_fwd (every variant), relayout_inv (every variant),
       row_accumulate, planar_write and planar_read against their plain
       versions, bitwise: the relayouts on one f32 [B, 3, 384] field
       (22,140 tiles), the row kernel at the row probe's defaults (and
       embedding_bag to 1e-6 relative), the planar kernels at B = 2688
       and B with E_c = 32 and 16, with the zero-filled round trip;
  10b. main path, every launch count set to 0 first: the mains of
       ops.probe_reshape, ops.probe_rowdma and ops.probe_planar_io at their
       defaults; fails unless every relayout candidate is right, both
       planar errors are 0 and every probe kernel launched;
  10c. each kernel's device ms per launch (torch.profiler) at the 10a
       sizes, bound (bytes over 3.35 TB/s), plain ms and one library
       call's ms (CUDA events): clone() of the reshaped view, embedding_bag,
       the permuted view's contiguous(), copy_ into a zeroed output; for
       row_accumulate also every indexed row from memory, and in the log
       an estimate: that less the share of the source the L2 holds.
  The converged solve at scale:
  11. tpufem_torch.scripts.solve_scale's flow at box_tet10(--scale-n,
      default 119: 10.11M elements, 41M DOF) from a fresh build, without
      its cache, scalar Jacobi, every count 0 first:
      each setup stage (mesh, plan, operator geometry, system, refinement
      geometry, graph capture), the solve seconds, cycles, inner
      iterations and outer history beside tpufem's record, the f64 true
      relative residual, the peak device memory, the tip deflection and
      K1-K3's launches (K1, K2 by graph replays); fails above 1e-6, at a
      cycle count other than 3, on a tip that is not finite and negative,
      or on a kernel with no launch.
  The solver family and the mixed driver (f64; every count 0 just before
  each solve and read just after it; the launches of K1, K2, K3 and K6
  and the share of them by graph replays, the peak device memory, the
  setup stages and the solve seconds printed for each):
  12a. box_tet10(--n), z = 0 fixed, -1e3 in z on the top face, the f64
       packed operator with scalar Jacobi (K3 in its diagonal): the first
       64 BiCGStab iterations and the first GMRES(50) cycle through K1/K2
       (CUDA graphs) bitwise equal to the same with their plain versions
       (eager) on the same tables, the Jacobi diagonal through K3 too;
       then solve_bicgstab (tol 1e-6 relative, at most 4000),
       solve_gmres (left Jacobi, tol 1e-6 ||M^-1 b||, restart 50, at most
       3000) and modal (lumped mass, rho 7800, 5 modes, 12 subspace
       iterations, inner tol 1e-8, at most 800), with the Ritz values of
       each iteration and each mode's f64 eigen-residual
       ||K phi - lam M phi|| / (lam ||M phi||);
  12b. BASELINE config 3 at n = --mixed-n (default 64: box_tet below
       z = 0.5, box_wedge above, an s4 skin on the top face; tpufem's
       tests/test_solvers.py loads and material), through
       static_structure_solver operator="packed" (PackedMixedSystem: K1-K3
       for the tets, K6 for the wedges) and "assembled" (K6 for both),
       Jacobi, tol 1e-6 ||b||; then, after the counts were read, K1 and
       K2 (the packed primary applied to the solution on its own plan),
       K3 (its Jacobi diagonal) and K6 (the tets' and wedges' K as the
       assembled model and the packed system hold them) bitwise against
       their plain versions at these sizes;
  12c. s4 and s3 plates, grid --plate-n (default 128), clamped at x = 0,
       a transverse force, an end moment and an in-plane pull at x = 1,
       assembled, Jacobi, tol 1e-6 ||b||, at most 20000 iterations.
  Fails on NAN_INF or BREAKDOWN; when a reported residual and the one
  recomputed in f64 (F64Operator for c3d10, the assembled f64 model for
  the mixed and shell models) or its history's last entry differ by more
  than 1e-6 relative to the larger; when a converged solve's recomputed
  residual lies above its bar (1e-6 of its norm); on a kernel of a path
  without launches; on the bitwise comparisons above; when the packed and
  assembled config-3 solutions differ by more than rtol 2e-5, atol 1e-7
  max|u|; on a mode non-zero on a fixed node or an eigen-residual above
  1e-3; and on a plate DOF without stiffness (w, theta_z) that is
  non-zero.  MAX_ITER alone is not a failure.
  Schur substructuring and the remaining operators (phase 13, hybrid):
  13a. BASELINE config 4: box_tet(--hybrid-n, default 55: 998,250 c3d4
       elements) in --hybrid-parts (512) RCB parts, E = 200e9, nu = 0.3,
       z = 0 fixed, 1e3 in x on the top face, through
       tpufem_torch.scripts.bench_hybrid (f32, precondition="bdd", slim,
       interior_inverse, matrix_free_gg: tpufem's round-5 configuration),
       every count 0 first: the partition statistics (fails unless the
       interface count, nI_max and nG_max are tpufem's host rule's on the
       same labels, and 94,883, 289, 542 at the default size), the build by
       stage, the resident blocks, the peak memory; the interface PCG
       (one chunk of at most 800 iterations to 1e-7 ||g||) twice, failing
       unless each is CONVERGED and the two histories are bitwise equal;
       its float32 solution's f64 true relative residual (through the f64
       PartialAssemblyOperator, reported) and its displacement against
       the refined packed c3d4 solve (RefinedSystem, K1-K3, failing
       unless its f64 true relative residual is <= 1e-6), failing at a
       max relative difference above 1e-4; and K6 on the config's mesh
       in float64 (the build's type) bitwise against its plain version;
       fails unless K1, K2, K3 and K6 launched;
  13b. tpufem's hybrid record row: box_tet(26), 32 balanced region-grown
       parts, Jacobi (dense K_GG, the factor's triangular solves), tol
       1e-4 absolute and then 1e-6 ||g||: the interface count, iterations
       and displacement against the packed f32 reference beside tpufem's
       7.9k, 410 and 2e-5 (report only);
  13c. box_tet10(--n): ClusteredPartialOperator f32 on K7a/K7b (the
       kernels bitwise against their plain versions on its tables; the
       apply and diagonal within 1e-5 relative of PartialAssemblyOperator
       and PackedPartialOperator; ms per apply; fails unless K7a and K7b
       launched in its applies); static_structure_solver(operator=
       "partial") f64, phase 8's load and tolerance (fails unless
       CONVERGED and, when phase 8 ran, its tip within 1e-4 of phase 8's);
       assemble_bsr and bsr_matvec at box_tet10(--bsr-n, default 20)
       against ClusteredOperator on the same K6 element matrices (1e-12
       relative, apply and diagonal).
  The reference's end-to-end SimJEB workload and the host tools (phase
  14, workload; SimJEB's material, E = 113.8e9, nu = 0.342):
  14a. find_spec of h5py, yaml and plotly (without h5py a line says so and
       the sample's datasets stay in memory: the same pipeline,
       workloads.simjeb._run_mesh_file, runs from them); the bundle
       box_tet10(--workload-n, default 44: 44, 44, 88; 1,022,208 c3d10
       elements, 1,402,017 nodes) synthesized on the card in float64
       (z = 0 the rbe2 set, -1e4 in z on the z = 2 rbe3 set, PCG to 1e-8
       ||F|| capped at tpufem's 4000 iterations), its mesh.vtu written;
       run B (f64, cold start, tol 1e-8, at most 20000 iterations),
       every count 0 first; fails unless CONVERGED, residual_solve < 1e-3
       residual_zero and <= 1.5 residual_truth + 1e-6 residual_zero
       (tpufem's bars), equilibrium < 1, equilibrium_mean < 0.35, vm_max
       finite and positive, the result .vtu reads back with the mesh's
       points and connectivity, and K1-K3 launched; run A, the
       notebook's flow (f32, warm start, tol 1e-6, at most 2000), under
       torch.profiler, whose device records count K1-K3: the same gates
       but CONVERGED or MAX_ITER in place of CONVERGED and the residual
       ratios reported, not gated (tpufem's bars are f64 bars: its own f32
       workload misses them), beside the f32 solution's distance from
       run B's; each run's stage seconds (read, operator, solve, stress,
       faces, result write);
       then, on the phase's own plan, one apply (K1, K2) and the Jacobi
       diagonal (K3, K2) against the plain versions: bitwise in f32,
       <= 1e-13 relative in f64;
  14b. checkpointed_cg on the f64 packed system (tol 1e-11 ||b||, chunks
       of 2000 iterations): a one-shot cg, a first call stopped at 1000
       iterations (half the one-shot count where that is fewer),
       a second resumed from the file to CONVERGED, within 1e-8
       (relative, max-norm) of the one-shot; profiling.timed of one f32
       apply beside its torch.profiler device time (median of three
       windows); profiling.trace's Chrome trace of five applies, taken up
       to three times, failing unless an event names fused_yc; the three
       examples (static_cantilever, simjeb_workload, packed_solve) at
       their defaults, failing on NAN_INF (NOT_SPD too for the first
       two) and unless static_cantilever launched K6.
  The four distributed systems of tpufem_torch.parallel on a part mesh
  (phase 15, dist; E = 200e9, nu = 0.3, z = 0 fixed, -1e3 in z on the top
  face; K4, K3, K2 and K6 counted over the distributed systems' builds,
  applies and solves, the kernel comparisons and the single-card
  references not counted):
  15a. box_tet10(--dist-n, default 95: 5,144,250 c3d10, 6,967,871 nodes),
       f32, PackedHaloFEM on PartMesh(--dist-parts, default 4) with block
       Jacobi, over one window_buckets=0 plan: the setup stages (mesh,
       plan, partition tables, geometry, block diagonal), Bp, Nbp, Gx, Gc,
       the X and Yc rounds, interior_cut against Bp, the ghost bytes an
       apply, the single-card staged apply's rate and
       scripts/dist_cost_model's row for the part count at that rate
       (fails unless its ghost rows are Gx and Gc); K4, K3, K2 on part 0's
       remapped tables bitwise against their plain versions; the part-mesh
       apply against PackedPartialOperator(fuse="") on the same plan
       (the largest relative difference; fails above 1e-6); a 200-
       iteration PCG window (tol 1e-30) as CUDA graphs beside the same
       window of the single-card staged PackedSystem (fails unless the
       first 20 history entries agree within 1e-5; the largest difference
       over the 200 and both ms per iteration printed);
  15b. box_tet10(--n), f64, PackedHaloFEM on PartMesh(4), scalar Jacobi,
       tol 1e-6 ||b||: fails unless CONVERGED, within 1% of the
       single-card f64 PackedSystem's iterations and 1e-8 of its
       displacement, with an F64Operator true relative residual <= 1e-6;
       then (last in the phase, after every capture) a GroupMesh on one
       NCCL rank (a FileStore in a temporary directory): 64 iterations
       bitwise PartMesh(1)'s;
  15c. DistFEM and HaloFEM on the same mesh, f64, 4 parts by
       partition_elements, K by K6, scalar Jacobi, the same tolerance:
       fails unless both CONVERGED within 1% of 15b's count and within
       1e-8 of each other; their ms per iteration and rows exchanged an
       apply;
  15d. HaloPartialFEM, f64, part_shape (2, 2) by hierarchical_partition:
       fails unless its rounds are partial permutations with the
       cross-host rounds first, its geometry <= 160 B an element, and a
       100-iteration window within 1e-8 of 15b's (partial assembly too)
       and within 1e-12 of DistFEM's first 20 history entries (K6's
       element stiffness: the difference grows past 1e-8 by iteration
       100, printed).
  With --phases turns (not in the default): the timings of 8d (K6) and
  9d (K5b in turns with K3), by the same helpers, on box_tet10(n) alone.
  For before/after figures, copy this
  script beside another commit's tpufem_torch (a git-ignored directory of
  the repo) and run it there and here in turns (parent, change, change,
  parent); the build step names the package it imported.
It then prints {"kernels": [...]} (the static kernels' numbers are
float64, the main path's type, with the float32 ones beside them; K1,
K5b, K6, K7a and K7b add ms_min and ms_max; K1-K3 and K6 add
family_launches and family_replayed, phase 12's; K1-K3, K6, K7a and K7b
add hybrid_launches and hybrid_replayed, phase 13's; K1-K3 add
workload_launches, run A's by torch.profiler, and workload_run_b_launches,
run B's by the wrappers' counts, and K6 workload_launches, the
static_cantilever example's; K2, K3, K4 and K6 add dist_launches and
dist_replayed, phase 15's), the card's name and power limit, and, last,
{"ok": true, "device": ...}.
"""
from __future__ import annotations

import argparse
import json
import os
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


def time_ms(fn, reps: int, warmup: int = 2, before=None) -> float:
    """Median milliseconds of fn() over `reps` runs, from CUDA events."""
    return statistics.median(event_times(fn, reps, warmup, before))


def event_times(fn, reps: int, warmup: int = 2, before=None):
    """Milliseconds of each of `reps` runs of fn(), from CUDA events;
    before(), if given, runs ahead of each run, untimed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in evs]


def _demangle(names):
    """C++ names demangled by the CUDA toolkit's cu++filt (or c++filt);
    the names as they are where neither is found."""
    import shutil

    from tpufem_torch.ops import cuda
    tools = [os.path.join(os.path.dirname(cuda.nvcc_path()), "cu++filt"),
             shutil.which("c++filt") or ""]
    for tool in tools:
        if names and os.path.exists(tool):
            res = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
            out = res.stdout.splitlines()
            if res.returncode == 0 and len(out) == len(names):
                return out
    return list(names)


def ptxas_entries(kernel):
    """[{name, registers, smem, spill_stores, spill_loads, stack}] of each
    kernel instantiation in the source's `-Xptxas -v` build log, names
    demangled and cut before their arguments; None without a log."""
    import re
    try:
        with open(kernel.log_path()) as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    entries, props, cur, prop = [], {}, None, None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = dict(mangled=m.group(1), registers=None, smem=0, stack=0)
            entries.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            prop = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and prop is not None:
            props[prop] = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(sm.group(1)) if sm else 0
            st = re.search(r"(\d+) bytes cumulative stack size", ln)
            cur["stack"] = int(st.group(1)) if st else 0
    names = _demangle([e["mangled"] for e in entries])
    for e, name in zip(entries, names):
        frame, stores, loads = props.get(e["mangled"], (0, 0, 0))
        e.update(name=_strip_params(name), spill_stores=stores,
                 spill_loads=loads, stack=max(e["stack"], frame))
        del e["mangled"]
    # a source's library holds its sibling kernels too: keep this one's
    own = [e for e in entries
           if re.search(rf"::{kernel.name}_kernel\b", e["name"])]
    return own or entries


def _strip_params(name: str) -> str:
    """A demangled function name without its parameter list (template
    arguments may hold parentheses, as in cu++filt's "(int)10")."""
    name = name.strip()
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def ptxas_digest(kernel) -> str:
    entries = ptxas_entries(kernel)
    if entries is None:
        return "(no build log)"
    return "".join(
        f"\n    {e['name']}: {e['registers']} registers, {e['smem']} B "
        f"static shared memory, spills {e['spill_stores']} B stored / "
        f"{e['spill_loads']} B loaded, stack {e['stack']} B"
        for e in entries)


def k1_registers(kq=None) -> str:
    """Registers and spill bytes of fused_yc's instantiations (of (k, q)
    kq only, if given), from the build log."""
    import tpufem_torch as tt
    out = []
    for e in ptxas_entries(tt.FUSED_YC) or []:
        name = e["name"].split("fused_yc_kernel")[-1]
        if kq is None or f"(int){kq[0]}, (int){kq[1]}>" in name:
            out.append(f"{name} {e['registers']} registers, spills "
                       f"{e['spill_stores']} B")
    return "; ".join(out) or "(no build log)"


def k1_blocks(plan, k: int, q: int) -> dict:
    """{dtype name: blocks of fused_yc an SM} in f32 and f64 on the plan's
    launched buckets (the least over them, as the operator's
    fused_yc.warps_per_sm counter)."""
    from tpufem_torch.ops import fused_kernels as fk
    return {str(dt)[6:]: fk.warps_per_sm(dt, k, q, plan) // fk.WARPS_PER_BLOCK
            for dt in (torch.float32, torch.float64)}


def k1_residency(plan, k: int, q: int) -> str:
    """fused_yc's registers, blocks and warps an SM in f32 and f64 on the
    plan (k1_blocks)."""
    from tpufem_torch.ops import fused_kernels as fk
    res = [f"{name} {b} blocks, {b * fk.WARPS_PER_BLOCK} warps an SM"
           for name, b in k1_blocks(plan, k, q).items()]
    return f"{k1_registers((k, q))}; " + ", ".join(res)


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
    # combine: each row's windows up to its width (PackedPlan.row_wk)
    cb = m.n_clusters * 384 * itemsize + m.n_blocks * 384 * itemsize
    rw = p.row_wk.long()
    cb += int((rw * 4 + (rw + 3) // 4 * 128 * 4).sum()) + m.n_blocks * 4
    entries = int(sum(((p.slotidx >> (8 * b)) & 0xFF).ne(0).sum().item()
                      for b in range(4)))
    slots = sum(int(((c >> (8 * b)) & 0xFF).ne(0).sum().item())
                for c in p.cinc for b in range(4))
    fl_fy = n_elements * flops_per_element(op.dN) + 3 * slots
    return {"fused_yc": (fy, fl_fy), "combine": (cb, 3 * entries),
            "compress_gather": (cg, 3 * slots)}


def device_times(fn, reps: int):
    """[(kernel, ms, launches)] summed over `reps` calls of fn from
    torch.profiler's device records, longest first.  The device copies of
    the program's spans (tpufem_torch.*, user annotations whose length is
    the span's) are left out: they are no device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("tpufem_torch.")),
                  key=lambda r: -r[1])


def bound_ms(nbytes: int, flops: int):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def library_tables(plan):
    """Index tables (int64, built once and not timed) for the library
    yardsticks: one torch.take or index_add_ that computes what a kernel
    computes.  Gathers read X with a zero row appended (row Nb, where
    empty slots point); sums send the values no slot or node takes to
    one extra dump entry at the end."""
    m = plan.meta
    B, Nb, k, E_c, Rp = (m.n_clusters, m.n_blocks, m.nodes_per_elem,
                         m.elems_per_cluster, m.lanes)
    dev = plan.device
    c3 = torch.arange(3, device=dev)[None, :, None] * 128
    wn, ws, js = (plan.win_nodes.long(), plan.wslot.long(),
                  plan.jslot.long())
    Wn = wn.shape[1]
    row = torch.gather(wn, 1, ws.clamp(max=Wn - 1))
    valid = (ws < Wn) & (row < Nb)
    row = torch.where(valid, row, Nb)                        # [B, 128]
    slot_src = row[:, None, :] * 384 + c3 + js[:, None, :]   # [B, 3, 128]
    lc = plan.lconn.long()
    take = torch.gather(slot_src, 2, lc[:, None, :].expand(B, 3, Rp))
    ev = (plan.esrc.reshape(B, E_c) >= 0).repeat(1, k)       # lane kk*E_c+e
    lane_ok = torch.zeros((B, Rp), dtype=torch.bool, device=dev)
    lane_ok[:, :k * E_c] = ev
    bb = torch.arange(B, device=dev)[:, None, None] * 384
    dst = torch.where(lane_ok[:, None, :], bb + c3 + lc[:, None, :], B * 384)

    def planar(t):                   # [B, 3, Rp] -> [3, k, B, E_c]
        return t[:, :, :k * E_c].reshape(B, 3, k, E_c).permute(
            1, 2, 0, 3).contiguous().reshape(-1)

    node = torch.where(valid[:, None, :], slot_src, Nb * 384)  # [B, 3, 128]
    return {"expand": take.reshape(-1), "expand_planar": planar(take),
            "compress": dst.reshape(-1), "compress_planar": planar(dst),
            "combine": node.reshape(-1)}


def packed_phase(args, dev):
    """The refined packed c3d10 solve (phases 3-7 of the module
    docstring).  Returns its {"kernels"} rows and the refined tip uz
    mean."""
    import tpufem_torch as tt
    from tpufem_torch.ops import fused_kernels as fk, packed_kernels as pk
    from tpufem_torch.solvers.cg import CGBlock

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
        if K.name == "combine" and not torch.equal(got, want):
            fail(f"combine f64 differs from its plain version: max rel "
                 f"{rel64:.3e}")
        parity[K.name] = (err32, rel64)
        log(f"parity {K.name}: f32 bitwise equal (max |d| {err32:.1e}), "
            f"f64 max rel {rel64:.1e}")
    # combine's plain version over all rows at their widths against the
    # plain version bucket by bucket (tpufem's kernel's widths)
    buckets = torch.cat([pk.combine_plain(
        Yr, plan.winc[s:s + n], plan.slotidx[s:s + n], torch.full(
            (n,), wk, dtype=torch.int32, device=dev))
        for (s, n, wk) in m.b_groups])
    if not torch.equal(buckets, op.combine_stage(Yr, kernel=pk.combine_plain)):
        fail("combine's plain version over all rows differs from the same "
             "bucket by bucket")
    log(f"parity combine: one launch over {m.n_blocks} rows "
        f"({int(plan.row_wk.sum())} row windows; the buckets' widths give "
        f"{sum(n * wk for (_, n, wk) in m.b_groups)}) bitwise equal to the "
        f"plain version bucket by bucket")
    del got, want, buckets, ops[torch.float64]

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
    for K in tt.PACKED_KERNELS + tt.SOLVER_KERNELS:
        K.launches = K.replayed = 0
    from tpufem_torch.utils import profiling
    counts0 = profiling.counters()
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
    replayed = {K.name: K.replayed for K in tt.PACKED_KERNELS}
    log(f"main path: system+refinement setup {t_setup:.2f} s, solve "
        f"{t_solve:.2f} s, cycles {info.cycles}, inner iterations "
        f"{info.inner_iterations}, outer history (rel) "
        f"{[float(h / info.outer_history[0]) for h in info.outer_history]}, "
        f"f64 true rel residual {info.rel_residual:.3e}, tip uz mean "
        f"{tip:.6e}, launches {launches} (of them by CUDA graph replays "
        f"{replayed})")
    if not info.rel_residual <= 1e-6:
        fail(f"f64 true relative residual {info.rel_residual:.3e} > 1e-6")
    if not (np.isfinite(tip) and tip < 0):
        fail(f"tip uz mean {tip} is not finite and negative")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for name in ("fused_yc", "combine"):
        if replayed[name] <= 0:
            fail(f"kernel {name} was not launched by a CUDA graph replay")
    # cg's fused step: one launch of each kernel an iteration of a block
    counts = {k: v - counts0.get(k, 0)
              for k, v in profiling.counters().items()
              if k in ("cg.blocks", "cg.fused_blocks", "host_syncs")
              or k.startswith("launches.cg_")}
    cg_launches = {K.name: K.launches for K in tt.SOLVER_KERNELS}
    log(f"counters (main path): {counts}; cg kernels' launches an inner "
        f"iteration {cg_launches['cg_pap'] / info.inner_iterations:.4f} "
        f"(a block that stops early still runs its graph to the end)")
    if (counts.get("cg.fused_blocks", 0) != counts["cg.blocks"]
            or len(set(cg_launches.values())) != 1
            or not cg_launches["cg_pap"] >= info.inner_iterations):
        fail(f"the fused step did not run every block once an iteration: "
             f"{counts}")
    launches.update(cg_launches)

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
    # solve (tol 0: every iteration runs) through its CUDA graphs, and the
    # same window with the blocks run eagerly (op by op, as before the
    # graphs); then each kernel's sweep.
    iters = 100
    bX = plan.pack(torch.as_tensor(b, device=dev))
    bX = bX / torch.linalg.norm(bX)
    eager = CGBlock(system.op, bX, constraints=system.pc,
                    M_inv=system.M_inv, tol=0.0)
    eager.graphed = False            # for the comparison only

    def pcg():
        system.solve_chunked_packed(bX, tol=0.0, max_iter=iters, every=iters)

    def pcg_eager():
        eager.solve(system.pc.project_residual(bX), max_iter=iters)

    window = {}
    for label, fn in (("graphs", pcg), ("eager", pcg_eager)):
        fn()
        walls = host_windows(fn)
        wall_ms = statistics.median(walls)
        prof = device_times(fn, 1)
        if not prof:
            fail(f"torch.profiler recorded no device time ({label})")
        dev_ms = sum(r[1] for r in prof)
        by = {K.name: sum(r[1] for r in prof if f"{K.name}_kernel" in r[0])
              for K in tt.PACKED_KERNELS}
        by["other"] = dev_ms - sum(by.values())
        window[label] = (wall_ms / iters, dev_ms / iters)
        log(f"profile ({label}): {iters} PCG iterations, "
            f"{wall_ms / iters:.4f} ms per iteration (host clock, "
            f"unprofiled, median of {len(walls)} windows; "
            f"{fmt_spread(spread([w / iters for w in walls]))}); device "
            f"{dev_ms / iters:.4f} ms per iteration, busy "
            f"{dev_ms / wall_ms:.1%}; device ms per iteration by kernel "
            f"{ {k: round(v / iters, 4) for k, v in by.items()} }")
        for name, ms, count in prof[:8]:
            log(f"  {ms / iters:.4f} ms/it  {count / iters:.1f} "
                f"launches/it  {name[:90]}")
        if by["fused_yc"] <= 0:
            fail(f"torch.profiler recorded no fused_yc in the {label} "
                 f"PCG window")
    (hg, dg), (he, de) = window["graphs"], window["eager"]
    log(f"PCG window: with CUDA graphs host {hg:.4f} ms per iteration, "
        f"device {dg:.4f} (host/device {hg / dg:.3f}); eager host "
        f"{he:.4f}, device {de:.4f} (host/device {he / de:.3f})")
    del eager
    # cg's fused step against the unfused body, f32 and f64, in turns
    turns_pcg = {"float32": fused_turns(system, bX, iters)}
    op64 = tt.PackedPartialOperator(plan, op.Jinv.double(), op.W.double(),
                                    op.dN, *op.lam_mu)
    system64 = tt.PackedSystem(op64, fixed_nodes=fixed,
                               precondition="jacobi")
    turns_pcg["float64"] = fused_turns(system64, bX.double(), iters)
    del system64, op64
    cg_rows = cg_update_rows(dev, m.n_blocks * 384, args.reps, launches,
                             turns_pcg)
    kernel_ms = {}
    for K in tt.PACKED_KERNELS[2:]:        # K1, K2: in turns below
        rows_k = device_times(sweep(K.name), args.reps)
        kernel_ms[K.name] = sum(r[1] for r in rows_k
                                if f"{K.name}_kernel" in r[0]) / args.reps
        if not kernel_ms[K.name] > 0:
            fail(f"torch.profiler recorded no device time for {K.name}")
        share = times[K.name][2] / kernel_ms[K.name]
        log(f"device time {K.name}: {kernel_ms[K.name]:.4f} ms per sweep "
            f"(torch.profiler, {args.reps} sweeps); the bound is {share:.1%}"
            f" of it")

    # K1's sweep against K4 expand + K3 compress_gather (its gathers and
    # its sum as separate kernels) on the same tables, profiler windows in
    # turns; K1's "ms" is the median of its windows
    turns = windows_in_turns({
        "fused_yc": (sweep("fused_yc"), "fused_yc_kernel"),
        "expand": (lambda: op.expand_stage(X), "tpufem::expand_kernel<"),
        "compress_gather": (sweep("compress_gather"),
                            "compress_gather_kernel")}, args.reps)
    k1 = spread(turns["fused_yc"])
    k43 = spread([a + b for a, b in zip(turns["expand"],
                                        turns["compress_gather"])])
    kernel_ms["fused_yc"] = k1[1]
    Wp = max(c.shape[1] for c in plan.cinc)
    log(f"K1 against K4 + K3, {len(turns['fused_yc'])} torch.profiler "
        f"windows of {args.reps} sweeps each, in turns: fused_yc "
        f"{fmt_spread(k1)} ms per sweep; expand + compress_gather "
        f"{fmt_spread(k43)} (expand {fmt_spread(spread(turns['expand']))}, "
        f"compress_gather {fmt_spread(spread(turns['compress_gather']))}); "
        f"median ratio {k1[1] / k43[1]:.3f}; bound {times['fused_yc'][2]:.4f}"
        f" ms ({times['fused_yc'][2] / k1[1]:.1%} of the median); on this "
        f"plan (Wp {Wp}, Rp {m.lanes}, E_c {m.elems_per_cluster}): "
        f"{k1_residency(plan, 10, 4)}; every instantiation's registers: "
        f"{k1_registers()}")

    # library yardsticks: one index_add_ over index tables built once;
    # K2's sweep in turns with its own (device times, six windows)
    lib = library_tables(plan)
    Bc, Nb = m.n_clusters, m.n_blocks
    turns = windows_in_turns({
        "library": (lambda: Yr.new_zeros(Nb * 384 + 1).index_add_(
            0, lib["combine"], Yr.reshape(-1)), None),
        "kernel": (sweep("combine"), "combine_kernel")}, args.reps)
    k2, k2lib = spread(turns["kernel"]), spread(turns["library"])
    kernel_ms["combine"] = k2[1]
    log(f"K2 in turns with index_add_, {len(turns['kernel'])} torch.profiler "
        f"windows of {args.reps} sweeps each: combine {fmt_spread(k2)} ms per "
        f"sweep ({per_apply['combine']} launch per apply), "
        f"index_add_ {fmt_spread(k2lib)} ms; bound {times['combine'][2]:.4f}"
        f" ms ({times['combine'][2] / k2[1]:.1%} of the median); kernel "
        f"windows in order {[round(x, 4) for x in turns['kernel']]}")
    library_ms = {
        "fused_yc": None,
        "combine": k2lib[1],
        "compress_gather": time_ms(lambda: Fe.new_zeros(
            Bc * 384 + 1).index_add_(0, lib["compress"], Fe.reshape(-1)),
            args.reps)}
    got = Yr.new_zeros(Nb * 384 + 1).index_add_(0, lib["combine"],
                                                Yr.reshape(-1))
    lib_rel = {"combine": max_rel(got[:-1].reshape(Nb, 384),
                                  op.combine_stage(Yr))}
    got = Fe.new_zeros(Bc * 384 + 1).index_add_(0, lib["compress"],
                                                Fe.reshape(-1))
    lib_rel["compress_gather"] = max_rel(got[:-1].reshape(Bc, 384),
                                         op.compress_stage(Fe))
    del lib, got
    log(f"library yardsticks (index_add_, CUDA events): combine "
        f"{library_ms['combine']:.4f} ms (max rel to the kernel "
        f"{lib_rel['combine']:.1e}), compress_gather "
        f"{library_ms['compress_gather']:.4f} ms (max rel "
        f"{lib_rel['compress_gather']:.1e})")

    rows = []
    for K in tt.PACKED_KERNELS:
        sweep_ms, plain_ms, b_ms, b_by = times[K.name]
        rows.append(dict(
            name=K.name, route="cuda",
            source=f"tpufem_torch/csrc/{K.source}", replaces=K.replaces,
            launches=launches[K.name], max_abs_err=parity[K.name][0],
            ms=kernel_ms[K.name], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms[K.name], sweep_ms=sweep_ms,
            launches_per_apply=per_apply[K.name],
            f64_max_rel_err=parity[K.name][1]))
        if K.name == "fused_yc":
            rows[-1].update(ms_min=k1[0], ms_max=k1[2],
                            expand_plus_compress_ms=list(k43),
                            blocks_per_sm=k1_blocks(plan, 10, 4))
        if K.name == "combine":
            rows[-1].update(ms_min=k2[0], ms_max=k2[2], library_min=k2lib[0],
                            library_max=k2lib[2])
    ctx = dict(coords=coords, conn=conn, plan=plan, op=op)
    return rows + cg_rows, tip, ctx


def fused_turns(system, bX, iters: int):
    """cg's fused graphed loop (the system's own block: kernels cg_pap,
    cg_update_r, cg_update_p) against the unfused body (the same M^-1 as
    a callable, also graphed), `iters` iterations from a cold start a
    window, tol 0; torch.profiler windows in turns (fused, unfused,
    unfused, fused).  Returns {label: [(host ms an iteration (median of
    five unprofiled windows), device ms an iteration, {kernel: device ms
    an iteration, "other": the rest})]}."""
    import tpufem_torch as tt
    from tpufem_torch.solvers.cg import CGBlock
    bX = system.pc.project_residual(bX / torch.linalg.norm(bX))
    minv = system.M_inv
    fused = system._block(0.0, None)
    unfused = CGBlock(system.op, bX, constraints=system.pc,
                      M_inv=lambda r: r * minv, tol=0.0)
    if fused.fused is None or unfused.fused is not None:
        fail("the fused step engages where it should not, or not where it "
             "should")
    fns = {"fused": lambda: fused.solve(bX, max_iter=iters),
           "unfused": lambda: unfused.solve(bX, max_iter=iters)}
    names = [K.name for K in tt.PACKED_KERNELS + tt.SOLVER_KERNELS]
    out = {k: [] for k in fns}
    dt = str(bX.dtype)[6:]
    for label in ("fused", "unfused", "unfused", "fused"):
        fn = fns[label]
        fn()
        wall = statistics.median(host_windows(fn)) / iters
        prof = device_times(fn, 1)
        if not prof:
            fail(f"torch.profiler recorded no device time ({label})")
        dev_ms = sum(r[1] for r in prof) / iters
        by = {k: sum(r[1] for r in prof if f"{k}_kernel" in r[0]) / iters
              for k in names}
        by = {k: round(v, 4) for k, v in by.items() if v > 0}
        by["other"] = round(dev_ms - sum(by.values()), 4)
        out[label].append((wall, dev_ms, by))
        log(f"PCG {dt} {label}: {iters} iterations, host {wall:.4f} ms an "
            f"iteration, device {dev_ms:.4f} ms an iteration (busy "
            f"{dev_ms / wall:.1%}); by kernel {by}")
    f, u = (statistics.mean(x[1] for x in out[k]) for k in ("fused",
                                                           "unfused"))
    log(f"PCG {dt}: fused {f:.4f} against unfused {u:.4f} device ms an "
        f"iteration (mean of two windows each, in turns): {f / u:.3f}")
    if not f < u:
        log(f"PCG {dt}: the fused step is NOT faster than the body")
    del fused, unfused
    return out


def cg_update_rows(dev, n: int, reps: int, launches, turns_pcg):
    """Kernels cg_pap, cg_update_r and cg_update_p at the main path's size
    (n values, f32 and f64): bitwise against their plain versions over
    three iterations of seeded state (one a step with negative curvature,
    one a stopped step), then each kernel's device ms a launch
    (torch.profiler, `reps` launches, status and flags reset before each),
    its plain version's ms (CUDA events) and its bound (the bytes it must
    move at 3.35 TB/s).  Returns the three rows (f32; f64 beside)."""
    import tpufem_torch as tt
    from tpufem_torch.solvers import cg_fused as cf
    fns = {"cg_pap": (cf.cg_pap, cf.cg_pap_plain),
           "cg_update_r": (cf.cg_update_r, cf.cg_update_r_plain),
           "cg_update_p": (cf.cg_update_p, cf.cg_update_p_plain)}
    passes = {"cg_pap": 2, "cg_update_r": 8, "cg_update_p": 5}
    res = {k: {} for k in fns}
    for dt in (torch.float32, torch.float64):
        g = torch.Generator(device=dev).manual_seed(0)

        def rand():
            return torch.rand(n, generator=g, dtype=dt, device=dev)

        base = dict(u=rand() - 0.5, r=rand() - 0.5, p=rand() - 0.5,
                    w=1.0 + rand(), minv=rand(), m=(rand() > 0.05).to(dt))
        sc = dict(dtype=dt, device=dev)

        def state():
            o = {k: v.clone() for k, v in base.items()}
            o.update(part=torch.zeros(2 * cf.grid(n, dt), **sc),
                     ctl=torch.zeros(8, dtype=torch.int32, device=dev),
                     status=torch.zeros((), dtype=torch.int32, device=dev),
                     rz=torch.tensor(1.0, **sc), hlast=torch.tensor(1.0, **sc),
                     hblock=torch.zeros(32, **sc),
                     i=torch.zeros((), dtype=torch.int32, device=dev),
                     scal=torch.zeros(4, **sc))
            o["Ap"] = o["p"] * o["w"]
            return o

        def call(o, name, plain=False):
            fn = fns[name][int(plain)]
            if name == "cg_pap":
                fn(o["p"], o["Ap"], o["part"], o["ctl"], o["status"],
                   o["rz"], o["scal"], 1e-30)
            elif name == "cg_update_r":
                fn(o["u"], o["r"], o["p"], o["Ap"], o["minv"], o["m"],
                   o["m"], o["part"], o["ctl"], o["status"], o["rz"],
                   o["hlast"], o["hblock"], 0, o["i"], o["scal"], 1e-30, 0.0,
                   True)
            else:
                fn(o["r"], o["p"], o["minv"], o["m"], o["ctl"], o["scal"])

        got, want = state(), state()
        for step in range(3):
            for o in (got, want):
                if step == 1:
                    o["w"].neg_()          # negative curvature: NOT_SPD
                o["Ap"] = o["p"] * o["w"]
            for name in fns:
                call(got, name)
                call(want, name, plain=True)
                torch.cuda.synchronize()
                for k in got:
                    if k != "part" and not torch.equal(got[k], want[k]):
                        fail(f"{name} {dt} step {step}: {k} differs from "
                             f"the plain version")
        if int(got["status"]) != 3 or int(got["i"]) != 2:
            fail(f"cg_update kernels {dt}: status {int(got['status'])} "
                 f"after {int(got['i'])} iterations, expected NOT_SPD after 2")
        log(f"parity cg_update {str(dt)[6:]}: cg_pap, cg_update_r, "
            f"cg_update_p bitwise equal to their plain versions over three "
            f"iterations of {n} values (a running step, a NOT_SPD step, a "
            f"stopped step)")
        o = state()
        for name in fns:
            def run(name=name):
                o["status"].zero_()
                o["ctl"][:2].fill_(1)
                call(o, name)
            rows_k = device_times(run, reps)
            ms = sum(r[1] for r in rows_k if f"{name}_kernel" in r[0]) / reps
            if not ms > 0:
                fail(f"torch.profiler recorded no device time for {name}")

            def run_plain(name=name):
                o["status"].zero_()
                o["ctl"][:2].fill_(1)
                call(o, name, plain=True)
            plain_ms = time_ms(run_plain, 3, warmup=1)
            nbytes = passes[name] * n * base["u"].element_size()
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            res[name][str(dt)[6:]] = (ms, plain_ms, b_ms, nbytes)
            log(f"time {name} {str(dt)[6:]}: {ms:.4f} ms a launch "
                f"(torch.profiler, {reps} launches); bound {b_ms:.4f} ms "
                f"({passes[name]} passes, {nbytes} bytes: {b_ms / ms:.1%}); "
                f"plain {plain_ms:.3f} ms")
        del got, want, o, base
    rows = []
    for K in tt.SOLVER_KERNELS:
        (ms, plain_ms, b_ms, _), (ms64, plain64, b64, _) = (
            res[K.name]["float32"], res[K.name]["float64"])
        rows.append(dict(
            name=K.name, route="cuda", source=f"tpufem_torch/csrc/{K.source}",
            replaces=K.replaces, launches=launches[K.name], max_abs_err=0.0,
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by="bytes",
            library_ms=None, f64_ms=ms64, f64_plain_ms=plain64,
            f64_bound_ms=b64))
    rows[0]["pcg_turns"] = turns_pcg
    return rows


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


def host_windows(fn, windows: int = 5):
    """Host-clock ms of each of `windows` runs of fn, each ending in a
    synchronize (the host clock of one window varies between windows of
    one call, so it is given as a spread)."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def windows_in_turns(fns, reps: int, rounds: int = 3):
    """{label: [device ms per call in each window]} of fns {label: (fn,
    key)}: 2 * rounds torch.profiler windows of `reps` calls each, taken
    in turns, the labels in order and then reversed (for two: a, b, b, a),
    so that each comparison lies inside one call, after one unprofiled
    call of each.  key None counts every kernel of the window (a library
    call may launch more than one)."""
    labels = list(fns)
    out = {lab: [] for lab in labels}
    for lab in labels:
        fns[lab][0]()
    for _ in range(rounds):
        for lab in labels + labels[::-1]:
            fn, key = fns[lab]
            out[lab].append(kernel_device_ms(fn, reps, key) if key
                            else total_device_ms(fn, reps))
    return out


def spread(values):
    """(min, median, max)."""
    return min(values), statistics.median(values), max(values)


def fmt_spread(t) -> str:
    return f"min {t[0]:.4f}, median {t[1]:.4f}, max {t[2]:.4f}"


def stiffness_windows(ct, conn_t):
    """K6's c3d10 call on coordinates ct and connectivity conn_t: device
    ms per call in five torch.profiler windows of four calls, after one
    unprofiled call (phase 8d and --phases turns)."""
    from tpufem_torch.ops import stiffness_kernels as sk

    k6 = lambda: sk.stiffness_fused(ct, conn_t, "c3d10", E, NU)  # noqa: E731
    k6()
    w = [kernel_device_ms(k6, 4, "stiffness_kernel") for _ in range(5)]
    log(f"  stiffness_fused {str(ct.dtype)[6:]} on {conn_t.shape[0]} "
        f"elements, device ms per call, five torch.profiler windows of 4 "
        f"calls: {fmt_spread(spread(w))}")
    return w


def planar_turns(op, fe3, reps: int):
    """K5b's sweep over op's buckets on planar fe3 in turns with K3's on
    the same tables (K3 reads the lane-major transpose of the same values,
    and must give the same sums bitwise): {name: six windows' device ms
    per sweep} (phase 9d and --phases turns)."""
    from tpufem_torch.ops import probe_fused as pf
    from tpufem_torch.ops.packed import planar_to_lanes

    lanes = planar_to_lanes(fe3, op.plan.meta.lanes)
    if not torch.equal(pf.compress_planar_stage(op, fe3),
                       op.compress_stage(lanes)):
        fail("compress_planar differs from compress_gather on the "
             "transposed input")
    tw = windows_in_turns({
        "compress_gather": (lambda: op.compress_stage(lanes),
                            "tpufem::compress_gather_kernel<"),
        "compress_planar": (lambda: pf.compress_planar_stage(op, fe3),
                            "tpufem::compress_planar_kernel<")}, reps)
    log(f"  compress_planar in turns with compress_gather on the same "
        f"tables ({len(op.plan.meta.c_groups)} buckets), "
        f"{len(tw['compress_planar'])} torch.profiler windows of {reps} "
        f"sweeps each: compress_planar "
        f"{fmt_spread(spread(tw['compress_planar']))} ms, compress_gather "
        f"{fmt_spread(spread(tw['compress_gather']))} ms per sweep")
    return tw


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def static_phase(args, dev, tip_packed):
    """The assembled-stiffness static solve (phase 8 of the module
    docstring).  Returns its {"kernels"} rows."""
    import tpufem_torch as tt
    from tpufem_torch.solvers.cg import CGBlock
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
    eb = {}
    for et, (gen, dims) in [("c3d10", (None, None))] + list(K6_SMALL.items()):
        if gen is None:
            c, cn = coords, conn[:4096]
        else:
            c, cn = getattr(tt.meshgen, gen)(*dims)
            c = c.copy()
            c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
        q, k, _ = tt.element_table(et).dN.shape
        for dt in (f32, f64):
            ct = torch.as_tensor(c, dtype=dt, device=dev)
            eb[et, dt] = sk.elems_per_block(k, q, dt)
            # the whole mesh (not for c3d10: done above), then M = 1 and
            # M one past a multiple of the elements per block
            for m_ in ([] if gen is None else [cn.shape[0]]) + [
                    1, 3 * eb[et, dt] + 1]:
                got = sk.stiffness_fused(ct, cn[:m_], et, E, NU)
                want = sk.stiffness_fused_plain(ct, cn[:m_], et, E, NU)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"stiffness_fused {et} {dt} M={m_} differs from "
                         f"its plain version: max |d| "
                         f"{float((got - want).abs().max()):.3e}")
            launches = sk.STIFFNESS_FUSED.launches
            empty = sk.stiffness_fused(ct, cn[:0], et, E, NU)
            if (tuple(empty.shape) != (0, 3 * k, 3 * k)
                    or sk.STIFFNESS_FUSED.launches != launches):
                fail(f"stiffness_fused {et} {dt} at M = 0: shape "
                     f"{tuple(empty.shape)}, launches "
                     f"{sk.STIFFNESS_FUSED.launches - launches}")
        log(f"parity stiffness_fused {et} (k={k}, q={q}): bitwise equal in "
            f"f32 and f64"
            + ("" if gen is None else f" on {cn.shape[0]} elements")
            + f", at M = 1 and at M one past three blocks (elements per "
            f"block f32 {eb[et, f32]}, f64 {eb[et, f64]}); M = 0 launches "
            f"nothing")
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
    # 6 values per node (a shell's), on a smaller plan
    c6, n6 = tt.meshgen.box_tet10(20, 20, 20)
    p6 = tt.ClusterPlan.build(n6, c6.shape[0], 6, device=dev)
    B6, L6 = p6.n_clusters, p6.l_max
    lc6 = p6.lconn.reshape(B6, -1)
    for dt in (f64, f32):
        Uc = torch.as_tensor(rng.standard_normal((B6, L6, 6)), dtype=dt,
                             device=dev)
        Fe = torch.as_tensor(rng.standard_normal((B6, lc6.shape[1], 6)),
                             dtype=dt, device=dev)
        for name, got, want in (
                ("cluster_expand", ck.cluster_expand(lc6, Uc),
                 ck.cluster_expand_plain(lc6, Uc)),
                ("cluster_compress", ck.cluster_compress(lc6, Fe, L6),
                 ck.cluster_compress_plain(lc6, Fe, L6))):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} {dt} with 6 values per node differs from its "
                     f"plain version: max |d| "
                     f"{float((got - want).abs().max()):.3e}")
    log(f"parity cluster_expand, cluster_compress with 6 values per node: "
        f"bitwise equal in f32 and f64 on {B6} clusters (box_tet10(20))")
    del c6, n6, p6, lc6

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

    # 8d. times (torch.profiler device time, K7a/K7b and their library
    # yardsticks in turns; plain versions by CUDA events), both dtypes
    reps = max(args.reps // 4, 3)
    lcl = lc.long().unsqueeze(-1).expand(-1, -1, 3)
    ops_ms = {}
    for dt in (f64, f32):
        item = 4 if dt == f32 else 8
        ct = torch.as_tensor(coords, dtype=dt, device=dev)
        Uc, Fe = ins[dt]
        k6 = lambda: sk.stiffness_fused(ct, conn_t, "c3d10", E, NU)  # noqa: E731
        w6 = stiffness_windows(ct, conn_t)
        ms6 = statistics.median(w6)
        ev6 = event_times(k6, 10, warmup=1)
        log(f"  stiffness_fused {str(dt)[6:]} per call by CUDA events, 10 "
            f"calls: min {min(ev6):.4f}, median "
            f"{statistics.median(ev6):.4f}, max {max(ev6):.4f} ms")
        # K7a and K7b in turns with their library calls, >= 5 profiler
        # windows each: "ms" and "library_ms" are the medians
        ta = windows_in_turns({
            "library": (lambda: torch.gather(Uc, 1, lcl), None),
            "kernel": (lambda: ck.cluster_expand(lc, Uc),
                       "cluster_expand_kernel")}, reps)
        tb = windows_in_turns({
            "library": (lambda: Fe.new_zeros((B, L, 3)).scatter_add_(
                1, lcl, Fe), None),
            "kernel": (lambda: ck.cluster_compress(lc, Fe, L),
                       "cluster_compress_kernel")}, reps)
        res["stiffness_fused"][dt].update(
            ms=ms6, ms_min=min(w6), ms_max=max(w6), library_ms=None,
            bound=bound_ms_dt(
                M * 10 * 4 + N * 3 * item + M * 900 * item,
                M * stiffness_flops(tt.element_table("c3d10").dN), dt))
        for name, tw, lib_name, plain, plain_reps, plain_warmup in (
                ("cluster_expand", ta, "torch.gather",
                 lambda: ck.cluster_expand_plain(lc, Uc), 3, 1),
                ("cluster_compress", tb, "scatter_add_",
                 lambda: ck.cluster_compress_plain(lc, Fe, L), 1, 0)):
            kern, libt = spread(tw["kernel"]), spread(tw["library"])
            pairs = list(zip(tw["library"], tw["kernel"]))
            res[name][dt].update(
                ms=kern[1], ms_min=kern[0], ms_max=kern[2],
                library_ms=libt[1], library_min=libt[0],
                library_max=libt[2],
                plain_ms=time_ms(plain, plain_reps, warmup=plain_warmup))
            log(f"  {name} {str(dt)[6:]} in turns with {lib_name}, "
                f"{len(tw['kernel'])} torch.profiler windows of {reps} calls "
                f"each: kernel {fmt_spread(kern)} ms, library "
                f"{fmt_spread(libt)} ms; windows (library, kernel) in order "
                f"{[(round(a, 4), round(b, 4)) for a, b in pairs]}")
        res["cluster_expand"][dt].update(
            bound=bound_ms_dt(B * R * 4 + B * L * 3 * item
                              + B * R * 3 * item, 0, dt))
        res["cluster_compress"][dt].update(
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
        if dt == f32:
            log(f"  ptxas stiffness_fused:{ptxas_digest(sk.STIFFNESS_FUSED)}")
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
        K.launches = K.replayed = 0
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
    args.static_solve = (tip, iters)              # phase 13c's yardstick
    tip_d = (abs(tip - tip_packed) / abs(tip_packed)
             if tip_packed is not None else float("nan"))
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
        f"{tip_packed}, rel diff {tip_d:.2e}); launches {launches} (of "
        f"them by CUDA graph replays "
        f"{ {K.name: K.replayed for K in tt.STATIC_KERNELS} })")
    if status != 1:
        fail(f"static solve status {status} (1 = CONVERGED)")
    if not true_rel <= 1e-6:
        fail(f"static solve true relative residual {true_rel:.3e} > 1e-6")
    if not (np.isfinite(tip) and tip < 0):
        fail(f"static solve tip uz mean {tip} is not finite and negative")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched on the static path")
    for K in (tt.CLUSTER_EXPAND, tt.CLUSTER_COMPRESS):
        if K.replayed <= 0:
            fail(f"kernel {K.name} was not launched by a CUDA graph replay "
                 f"on the static path")
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
    # one CGBlock for every window, so that its graphs are captured once
    blk = CGBlock(model, b6, constraints=cons, M_inv=Minv, tol=0.0)

    def pcg():
        blk.solve(b6 * live, max_iter=iters_w)

    pcg()
    walls = host_windows(pcg)
    wall_ms = statistics.median(walls)
    prof = device_times(pcg, 1)
    dev_ms = sum(r[1] for r in prof)
    log(f"profile (static): {iters_w} PCG iterations, "
        f"{wall_ms / iters_w:.4f} ms per iteration (host clock, "
        f"unprofiled, median of {len(walls)} windows; "
        f"{fmt_spread(spread([w / iters_w for w in walls]))}); device "
        f"{dev_ms / iters_w:.4f} ms per iteration, busy "
        f"{dev_ms / wall_ms:.1%}")
    for name, ms, count in prof[:10]:
        log(f"  {ms / iters_w:.4f} ms/it  {count / iters_w:.1f} launches/it  "
            f"{name[:90]}")
    for K in tt.STATIC_KERNELS:
        K.launches = 0
    model(b6)
    per_apply = {K.name: K.launches for K in tt.STATIC_KERNELS}
    del model, blk

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
        for key in ("ms_min", "ms_max", "library_min", "library_max"):
            if key in r64:
                rows[-1][key] = r64[key]
                rows[-1]["f32"][key] = r32[key]
    log(f"static applies (device ms per apply; bound = streaming K): "
        f"{ {str(dt)[6:]: [round(x, 4) for x in v] for dt, v in ops_ms.items()} }")
    return rows


# fused_yc's other instantiations, each on a small curved mesh
K1_SMALL = {"c3d4": ("box_tet", (20, 20, 20)),
            "c3d8": ("box_hex", (24, 24, 24))}


def staged_bounds(plan, itemsize: int):
    """(bytes, flops) of one sweep of K4, K5a and K5b on these tables, as
    bounds() counts them (X read once by the gathers)."""
    m = plan.meta
    k, E_c, Rp = m.nodes_per_elem, m.elems_per_cluster, m.lanes
    kE = k * E_c
    ex = exp = cp = 0
    for gi, (s, n, wk) in enumerate(m.c_groups):
        if wk == 0 or n == 0:
            continue
        words = plan.cinc[gi].shape[1] * 128 * 4
        ex += n * (wk * 4 + 2 * 128 * 4 + Rp * 4 + 3 * Rp * itemsize)
        exp += n * (wk * 4 + 2 * 128 * 4 + kE * 4 + 3 * kE * itemsize)
        cp += n * (3 * kE * itemsize + words + 384 * itemsize)
    xb = m.n_blocks * 384 * itemsize
    slots = sum(int(((c >> (8 * b)) & 0xFF).ne(0).sum().item())
                for c in plan.cinc for b in range(4))
    return {"expand": (ex + xb, 0), "expand_planar": (exp + xb, 0),
            "compress_planar": (cp, 3 * slots)}


def staged_phase(args, dev, ctx, tip_fused):
    """The staged packed pipeline and the block-Jacobi refined solve
    (phase 9 of the module docstring).  Returns its {"kernels"} rows."""
    import tpufem_torch as tt
    from tpufem_torch.ops import fused_kernels as fk
    from tpufem_torch.ops import packed_kernels as pk
    from tpufem_torch.ops import probe_fused as pf
    from tpufem_torch.ops.packed import lanes_to_planar, planar_to_lanes

    f32, f64 = torch.float32, torch.float64
    n = args.n
    if ctx is None:
        coords, conn = tt.meshgen.box_tet10(n, n, n)
        plan = tt.PackedPlan.build(coords, conn, coords.shape[0], device=dev)
        fused = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                               plan=plan, device=dev)
    else:
        coords, conn, plan, fused = (ctx[k] for k in ("coords", "conn",
                                                      "plan", "op"))
    N, M = coords.shape[0], conn.shape[0]
    m = plan.meta
    k, E_c, B = m.nodes_per_elem, m.elems_per_cluster, m.n_clusters
    t0 = time.perf_counter()
    staged = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                            plan=plan, fuse="", dtype=f32,
                                            device=dev)
    torch.cuda.synchronize()
    log(f"staged: box_tet10({n}) {M} elements; f32 staged operator "
        f"(fuse='') on the packed plan, geometry {time.perf_counter() - t0:.2f}"
        f" s; B={B} Rp={m.lanes} k*E_c={k * E_c}")
    STAGED = {K.name: K for K in tt.STAGED_KERNELS}
    rng = np.random.default_rng(args.seed + 2)
    X = torch.as_tensor(rng.standard_normal((m.n_blocks, 384)), dtype=f32,
                        device=dev)
    fe3 = torch.as_tensor(rng.standard_normal((3, k, B, E_c)), dtype=f32,
                          device=dev)
    ops = {f32: staged, f64: tt.PackedPartialOperator(
        plan, staged.Jinv.double(), staged.W.double(), staged.dN,
        *staged.lam_mu, fuse="")}

    def sweep(name, dt=f32, plain=False):
        """One sweep of kernel `name` (or its plain version) over all
        buckets, on the seeded input in dtype dt."""
        o = ops[dt]
        if name == "expand":
            x, kern = X.to(dt), pk.expand_plain if plain else pk.expand
            return lambda: o.expand_stage(x, kern)
        if name == "expand_planar":
            x = X.to(dt)
            kern = pk.expand_planar_plain if plain else pk.expand_planar
            return lambda: pf.expand_planar_stage(o, x, kern)
        f = fe3.to(dt)
        kern = pk.compress_planar_plain if plain else pk.compress_planar
        return lambda: pf.compress_planar_stage(o, f, kern)

    # 9a. parity: K4, K5a, K5b on every bucket; K4 on an E_c = 24 plan;
    # K1's c3d4 and c3d8 instantiations
    parity = {}
    for name in STAGED:
        got, want = sweep(name)(), sweep(name, plain=True)()
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"{name} f32 differs from its plain version: max |d| "
                 f"{err32:.3e}")
        got, want = sweep(name, f64)(), sweep(name, f64, plain=True)()
        rel64 = max_rel(got, want)
        if not rel64 <= 1e-13:
            fail(f"{name} f64 relative error {rel64:.3e} > 1e-13")
        parity[name] = (err32, rel64)
        log(f"parity {name}: f32 bitwise equal on {len(m.c_groups)} buckets "
            f"(max |d| {err32:.1e}), f64 max rel {rel64:.1e}")
    # K5b: bitwise in f64 too, and bitwise equal to K3 on the lane-major
    # transpose of its input, every bucket, both types
    for dt in (f32, f64):
        got = sweep("compress_planar", dt)()
        if not torch.equal(got, sweep("compress_planar", dt, plain=True)()):
            fail(f"compress_planar {dt} differs from its plain version")
        k3 = ops[dt].compress_stage(planar_to_lanes(fe3.to(dt), m.lanes))
        torch.cuda.synchronize()
        if not torch.equal(got, k3):
            fail(f"compress_planar {dt} differs from compress_gather on the "
                 f"transposed input: max |d| "
                 f"{float((got - k3).abs().max()):.3e}")
    log(f"parity compress_planar: bitwise equal to its plain version and to "
        f"compress_gather on the transposed input, f32 and f64, on every "
        f"bucket (widths {[list(w) for w in m.cv_widths]})")
    del got, want, k3, ops[f64]
    c24, n24 = tt.meshgen.box_tet10(10, 10, 10)
    op24 = tt.PackedPartialOperator.build(c24, n24, "c3d10", E, NU,
                                          n_nodes=c24.shape[0],
                                          elems_per_cluster=24, device=dev)
    m24 = op24.plan.meta
    for dt in (f32, f64):
        x24 = torch.as_tensor(rng.standard_normal((m24.n_blocks, 384)),
                              dtype=dt, device=dev)
        if not torch.equal(op24.expand_stage(x24),
                           op24.expand_stage(x24, pk.expand_plain)):
            fail(f"expand {dt} differs from its plain version at E_c = 24")
    log(f"parity expand at E_c = 24 (box_tet10(10), fuse "
        f"{op24.fuse!r}, Rp={m24.lanes}, cv_widths {list(m24.cv_widths)}): "
        f"bitwise equal in f32 and f64")
    del op24
    for et, (gen, dims) in K1_SMALL.items():
        c, cn = getattr(tt.meshgen, gen)(*dims)
        c = c.copy()
        c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
        for dt in (f32, f64):
            o = tt.PackedPartialOperator.build(c, cn, et, E, NU,
                                               n_nodes=c.shape[0], dtype=dt,
                                               device=dev)
            x = torch.as_tensor(rng.standard_normal((o.plan.meta.n_blocks,
                                                     384)), dtype=dt,
                                device=dev)
            got = o.fused_stage(x)
            want = o.fused_stage(x, kernel=fk.fused_yc_plain)
            if not torch.equal(got, want):
                fail(f"fused_yc {et} {dt} differs from its plain version: "
                     f"max |d| {float((got - want).abs().max()):.3e}")
        q = o.dN.shape[0]
        log(f"parity fused_yc {et} (k={cn.shape[1]}, q={q}, qJ="
            f"{o.Jinv.shape[1] // 9}): bitwise equal in f32 and f64 on "
            f"{cn.shape[0]} elements")
    del o, x, got, want
    # K1's c3d4 and c3d8 sweeps at the main path's element count (curved
    # box_tet(n) and box_hex(m), 6 n^3 and m^3 elements), f32: device ms
    # and the bound, as phase 4 counts them for c3d10
    k1_other = {}
    m_hex = round((6 * n ** 3) ** (1 / 3))
    for et, gen, dims in (("c3d4", "box_tet", (n, n, n)),
                          ("c3d8", "box_hex", (m_hex,) * 3)):
        c, cn = getattr(tt.meshgen, gen)(*dims)
        c = c.copy()
        c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
        o = tt.PackedPartialOperator.build(c, cn, et, E, NU,
                                           n_nodes=c.shape[0], dtype=f32,
                                           device=dev)
        x = torch.as_tensor(rng.standard_normal((o.plan.meta.n_blocks, 384)),
                            dtype=f32, device=dev)
        ms = kernel_device_ms(lambda: o.fused_stage(x), args.reps,
                              "fused_yc_kernel")
        nbytes, flops = bounds(o, 4, cn.shape[0])["fused_yc"]
        b_ms, b_by = bound_ms(nbytes, flops)
        k1_other[et] = dict(elements=int(cn.shape[0]), ms=ms, bound_ms=b_ms,
                            bound_by=b_by)
        log(f"time fused_yc {et}: {gen}{dims} {cn.shape[0]} elements, B="
            f"{o.plan.meta.n_clusters}, qJ={o.Jinv.shape[1] // 9}: "
            f"{ms:.4f} ms device per f32 sweep (torch.profiler); bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes} bytes, {flops} flops; "
            f"{b_ms / ms:.1%} of it); "
            f"{k1_residency(o.plan, cn.shape[1], o.dN.shape[0])}")
    del o, x

    # 9b. operator cross-checks on the whole mesh; the planar pipeline's
    # launches are counted here (its path)
    uX = plan.pack_flat(torch.as_tensor(rng.standard_normal(3 * N),
                                        device=dev), f32)
    F_st = staged(uX)
    rel_apply = max_rel(F_st, fused(uX))
    rel_diag = max_rel(staged.diagonal(), fused.diagonal())
    rel_block = max(max_rel(a, b) for a, b in zip(staged.block_diagonal(),
                                                  fused.block_diagonal()))
    for K in tt.KERNELS:
        K.launches = 0
    F_pl = pf.fused_apply(staged, uX, "planar")
    torch.cuda.synchronize()
    planar_launches = {K.name: K.launches for K in tt.KERNELS}
    log(f"cross-check f32: staged vs fused apply max rel {rel_apply:.2e}, "
        f"diagonal {rel_diag:.2e}, block diagonal {rel_block:.2e}; planar "
        f"vs staged apply bitwise {torch.equal(F_pl, F_st)}; launches of "
        f"one planar apply {planar_launches}")
    for what, rel in (("apply", rel_apply), ("diagonal", rel_diag),
                      ("block diagonal", rel_block)):
        if not rel <= 1e-6:
            fail(f"staged vs fused {what}: max rel {rel:.3e} > 1e-6")
    if not torch.equal(F_pl, F_st):
        fail(f"planar pipeline differs from the staged one: max rel "
             f"{max_rel(F_pl, F_st):.3e}")
    for name in ("expand_planar", "compress_planar"):
        if planar_launches[name] <= 0:
            fail(f"kernel {name} was not launched on the planar pipeline")
    del F_st, F_pl

    # 9c. main path: block-Jacobi refined solve on the staged operator,
    # every count 0 just before, read just after
    fixed = tt.meshgen.boundary_nodes(coords, 2, 0.0)
    top = tt.meshgen.boundary_nodes(coords, 2, 1.0)
    b = np.zeros((N, 3), np.float32)
    b[top, 2] = -1e3
    for K in tt.KERNELS:
        K.launches = K.replayed = 0
    t0 = time.perf_counter()
    system = tt.PackedSystem(staged, fixed_nodes=fixed, precondition="block")
    torch.cuda.synchronize()
    t_block = time.perf_counter() - t0
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
    launches = {K.name: K.launches for K in tt.KERNELS}
    tip = float(u.reshape(N, 3)[torch.as_tensor(top, device=dev).long(),
                                2].mean())
    tip_d = (abs(tip - tip_fused) / abs(tip_fused) if tip_fused is not None
             else float("nan"))
    log(f"main path (staged, block Jacobi): setup {t_setup:.2f} s (block "
        f"Jacobi {t_block:.2f} s), solve {t_solve:.2f} s, cycles "
        f"{info.cycles}, inner iterations {info.inner_iterations} "
        f"({t_solve / max(info.inner_iterations, 1) * 1e3:.3f} ms each, "
        f"derived), outer history (rel) "
        f"{[float(h / info.outer_history[0]) for h in info.outer_history]}, "
        f"f64 true rel residual {info.rel_residual:.3e}, tip uz mean "
        f"{tip:.6e} (fused Jacobi solve {tip_fused}, rel diff {tip_d:.2e}); "
        f"launches {launches} (of them by CUDA graph replays "
        f"{ {K.name: K.replayed for K in tt.KERNELS if K.replayed} })")
    if not info.rel_residual <= 1e-6:
        fail(f"staged solve: f64 true relative residual "
             f"{info.rel_residual:.3e} > 1e-6")
    if not (np.isfinite(tip) and tip < 0):
        fail(f"staged solve: tip uz mean {tip} is not finite and negative")
    if tip_fused is not None and not tip_d <= 1e-4:
        fail(f"staged solve: tip uz mean {tip:.6e} differs from the fused "
             f"solve's {tip_fused:.6e} by {tip_d:.2e} > 1e-4")
    for name in ("expand", "compress_gather", "combine"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the staged path")
    for K in (tt.EXPAND, tt.COMPRESS_GATHER, tt.COMBINE):
        if K.replayed <= 0:
            fail(f"kernel {K.name} was not launched by a CUDA graph replay "
                 f"on the staged path")
    del u

    # 9d. times: one apply of each pipeline; the element math's share;
    # a profiled window of PCG iterations; each new kernel's sweep
    reps = max(args.reps // 2, 5)
    Jc, Wc = staged.cluster_geometry()
    pipes = {"staged": lambda: staged(uX),
             "planar": lambda: pf.fused_apply(staged, uX, "planar"),
             "fused": lambda: pf.fused_apply(staged, uX, "dense", (Jc, Wc))}
    ue3 = lanes_to_planar(staged.expand_stage(uX), k, E_c)
    pipe_ms = {}
    for name, fn in list(pipes.items()) + [
            ("element math", lambda: staged.element_forces(ue3))]:
        pipe_ms[name] = (total_device_ms(fn, reps), time_ms(fn, reps))
    share = pipe_ms["element math"][0] / pipe_ms["staged"][0]
    log(f"applies (device ms by torch.profiler, host-clock ms by CUDA "
        f"events, per apply): "
        + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in
                    pipe_ms.items())
        + f"; pa_apply_planar takes {share:.1%} of the staged apply's device "
        f"time and {pipe_ms['element math'][1] / pipe_ms['staged'][1]:.1%} "
        f"of its host-clock time")
    del ue3, Jc, Wc
    iters = 20
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
    dev_ms = sum(r[1] for r in prof)
    log(f"profile (staged, block Jacobi): {iters} PCG iterations, "
        f"{wall_ms / iters:.4f} ms per iteration (host clock, unprofiled); "
        f"device {dev_ms / iters:.4f} ms per iteration, busy "
        f"{dev_ms / wall_ms:.1%}")
    for name, ms, count in prof[:10]:
        log(f"  {ms / iters:.4f} ms/it  {count / iters:.1f} launches/it  "
            f"{name[:90]}")

    lib = library_tables(plan)
    Xp = torch.cat([X, X.new_zeros((1, 384))])
    library = {"expand": lambda: torch.take(Xp, lib["expand"]),
               "expand_planar": lambda: torch.take(Xp, lib["expand_planar"]),
               "compress_planar": lambda: fe3.new_zeros(
                   B * 384 + 1).index_add_(0, lib["compress_planar"],
                                           fe3.reshape(-1))}
    lib_err = {
        "expand": float((library["expand"]().reshape(B, 3, m.lanes)
                         - sweep("expand")()).abs().max()),
        "expand_planar": float((library["expand_planar"]().reshape(
            3, k, B, E_c) - sweep("expand_planar")()).abs().max()),
        "compress_planar": max_rel(library["compress_planar"]()[:-1]
                                   .reshape(B, 384),
                                   sweep("compress_planar")())}
    nb = staged_bounds(plan, 4)
    k5b_turns = planar_turns(staged, fe3, args.reps)
    log(f"  ptxas compress_planar:{ptxas_digest(STAGED['compress_planar'])}")
    rows = []
    for name, K in STAGED.items():
        if name == "compress_planar":
            ms = statistics.median(k5b_turns[name])
        else:
            ms = kernel_device_ms(sweep(name), args.reps,
                                  f"tpufem::{name}_kernel<")
        plain_ms = time_ms(sweep(name, plain=True), 3, warmup=1)
        lib_ms = time_ms(library[name], args.reps)
        b_ms, b_by = bound_ms(*nb[name])
        main = name == "expand"
        rows.append(dict(
            name=name, route="cuda", source=f"tpufem_torch/csrc/{K.source}",
            replaces=K.replaces,
            launches=launches[name] if main else planar_launches[name],
            path=("the block-Jacobi refined solve on the staged operator"
                  if main else "one planar apply (probe_fused.fused_apply)"),
            max_abs_err=parity[name][0], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            f64_max_rel_err=parity[name][1]))
        if name == "compress_planar":
            rows[-1].update(ms_min=min(k5b_turns[name]),
                            ms_max=max(k5b_turns[name]))
        log(f"time {name}: {ms:.4f} ms device per sweep (torch.profiler); "
            f"bound {b_ms:.4f} ms by {b_by} ({nb[name][0]} bytes, "
            f"{b_ms / ms:.1%} of it); plain {plain_ms:.3f} ms; library "
            f"{lib_ms:.4f} ms (difference to the kernel {lib_err[name]:.1e})")
    staged_launches = {name: launches[name] for name in ("compress_gather",
                                                         "combine")}
    return rows, staged_launches, k1_other


# phase 10's full size: box_tet10(55)'s packed plan has B = 39,360
# clusters; one f32 [B, 3, 384] field is 22,140 [64, 32] tiles (181 MB)
PROBE_B = 39360
PROBE_TILES = PROBE_B * 3 * 384 // (64 * 32)
# the row probe's defaults (ops/probe_rowdma.py)
ROWDMA_SRC, ROWDMA_READS = 198208, 1 << 20


def probes_phase(args, dev):
    """The three probes and their five kernels (phase 10 of the module
    docstring).  Returns their {"kernels"} rows."""
    import tpufem_torch as tt
    from tpufem_torch.ops import probe_kernels as pk
    from tpufem_torch.ops import probe_planar_io, probe_reshape, probe_rowdma

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)

    def must_equal(name, got, want, what=""):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{name}{what} differs from its plain version: max |d| "
                 f"{float((got - want).abs().max()):.3e}")

    # 10a. parity at full size, bitwise (so max_abs_err is 0): every
    # relayout variant on one [B, 3, 384] field, the row kernel at the
    # probe's defaults, the planar write and read at the probe's B and at
    # PROBE_B
    T = PROBE_TILES
    x = torch.randn((T, 64, 32), generator=gen, device=dev)
    y = x.reshape(T, 16, 128)
    for v in pk.FWD_VARIANTS:
        got = pk.relayout_fwd(x, v)
        must_equal("relayout_fwd", got, pk.relayout_fwd_plain(x, v),
                   f" variant {v}")
        must_equal("relayout_fwd", got, y, f" variant {v} (the reshape)")
    for v in pk.INV_VARIANTS:
        got = pk.relayout_inv(y, v)
        must_equal("relayout_inv", got, pk.relayout_inv_plain(y, v),
                   f" variant {v}")
        must_equal("relayout_inv", got, x, f" variant {v} (the round trip)")
    log(f"parity relayout_fwd variants {pk.FWD_VARIANTS}, relayout_inv "
        f"variants {pk.INV_VARIANTS}: bitwise equal to the plain versions "
        f"and to the reshape on {T} tiles ({x.numel() * 4 / 1e6:.1f} MB)")
    del got

    src = torch.randn((ROWDMA_SRC, pk.ROW), generator=gen, device=dev)
    idx = torch.randint(0, ROWDMA_SRC, (ROWDMA_READS,), generator=gen,
                        device=dev, dtype=torch.int32)
    rows = pk.row_accumulate(src, idx)
    must_equal("row_accumulate", rows, pk.row_accumulate_plain(src, idx))
    bag_ix = idx.view(-1, pk.READS).long()
    bag = torch.nn.functional.embedding_bag(bag_ix, src, mode="sum")
    bag_rel = max_rel(bag, rows[:, 0])
    if not bag_rel <= 1e-6:
        fail(f"row_accumulate against embedding_bag: max rel {bag_rel:.3e}")
    log(f"parity row_accumulate: bitwise equal on {ROWDMA_READS} reads of "
        f"{ROWDMA_SRC} rows; embedding_bag max rel {bag_rel:.1e}")

    planar_in = {}
    for B, k, E_c in ((2688, 10, 32), (PROBE_B, 10, 32), (PROBE_B, 10, 16)):
        Rp = pk.planar_lanes(k, E_c)
        v = torch.randn((B, 3, Rp), generator=gen, device=dev)
        p = pk.planar_write(v, k, E_c)
        must_equal("planar_write", p, pk.planar_write_plain(v, k, E_c),
                   f" (B {B}, k {k}, E_c {E_c})")
        back = pk.planar_read(p)
        must_equal("planar_read", back, pk.planar_read_plain(p),
                   f" (B {B}, k {k}, E_c {E_c})")
        masked = v.clone()
        masked[:, :, k * E_c:] = 0.0
        must_equal("planar round trip", back, masked,
                   f" (B {B}, k {k}, E_c {E_c})")
        if (B, E_c) == (PROBE_B, 32):
            planar_in = dict(v=v, p=p, k=k, E_c=E_c, Rp=Rp)
        log(f"parity planar_write, planar_read B={B} k={k} E_c={E_c} "
            f"Rp={Rp}: bitwise equal; round trip exact, lanes >= {k * E_c} "
            f"zero")
    del back, masked

    # 10b. main path: the three probes at their defaults, every count 0
    # just before, read just after
    for K in tt.KERNELS:
        K.launches = 0
    t0 = time.perf_counter()
    reshape = probe_reshape.main(device=dev)
    rowdma = probe_rowdma.main(device=dev)
    planar = probe_planar_io.main(device=dev)
    torch.cuda.synchronize()
    launches = {K.name: K.launches for K in tt.PROBE_KERNELS}
    log(f"main path (probes): {time.perf_counter() - t0:.2f} s; launches "
        f"{launches}")
    if not all(reshape.values()):
        fail(f"relayout candidates wrong: {reshape}")
    if planar["write_err"] != 0.0 or planar["read_err"] != 0.0:
        fail(f"planar errors {planar['write_err']}, {planar['read_err']}")
    for name, c in launches.items():
        if c <= 0:
            fail(f"kernel {name} was not launched by the probes")

    # 10c. device ms per launch (torch.profiler) at the 10a sizes, plain ms
    # and one library call for the same function (CUDA events), bounds;
    # each timed call finds the L2 cold: a read of 256 MB runs before it
    # (untimed, and not a kernel the profiler's key selects)
    reps = args.reps
    l2_flush = torch.zeros(64 << 20, device=dev)

    def flush():
        l2_flush.sum()

    def kernel_ms(fn, key):
        return kernel_device_ms(lambda: (flush(), fn()), reps, key)

    def events_ms(fn, n=reps, warmup=2):
        return time_ms(fn, n, warmup, before=flush)

    relayout_bytes = 2 * x.numel() * 4
    timing = {}
    for name, fn, plain, arg, lib, variants in (
            ("relayout_fwd", pk.relayout_fwd, pk.relayout_fwd_plain, x,
             lambda: x.reshape(T, 16, 128).clone(), pk.FWD_VARIANTS),
            ("relayout_inv", pk.relayout_inv, pk.relayout_inv_plain, y,
             lambda: y.reshape(T, 64, 32).clone(), pk.INV_VARIANTS)):
        per = {}
        for v in variants:
            per[v] = dict(
                ms=kernel_ms(lambda: fn(arg, v), f"{name}_kernel<{v}>"),
                plain_ms=events_ms(lambda: plain(arg, v)))
        timing[name] = dict(
            ms=max(r["ms"] for r in per.values()),
            plain_ms=max(r["plain_ms"] for r in per.values()),
            library_ms=events_ms(lib), bound=bound_ms(relayout_bytes, 0),
            variants={str(v): r for v, r in per.items()})
    n_unique = int(torch.unique(idx).numel())
    l2_bytes = int(getattr(torch.cuda.get_device_properties(dev),
                           "L2_cache_size", 50 * 2 ** 20))
    n_out = ROWDMA_READS // pk.READS
    row_fixed = ROWDMA_READS * 4 + n_out * pk.ROW * 4     # indices, output
    timing["row_accumulate"] = dict(
        ms=kernel_ms(lambda: pk.row_accumulate(src, idx),
                     "row_accumulate_kernel"),
        plain_ms=events_ms(lambda: pk.row_accumulate_plain(src, idx), 3, 1),
        library_ms=events_ms(lambda: torch.nn.functional.embedding_bag(
            bag_ix, src, mode="sum")),
        # each distinct row read once (the card's least), and every
        # indexed row from device memory (src exceeds the L2)
        bound=bound_ms(n_unique * pk.ROW * 4 + row_fixed, n_out * pk.READS
                       * pk.ROW),
        row_stream_bound_ms=bound_ms(ROWDMA_READS * pk.ROW * 4 + row_fixed,
                                     0)[0],
        distinct_rows=n_unique)
    # an estimate (a model, not a bound, and not in the kernels line): the
    # output's rows are summed in r order, so a row is not shared among
    # outputs, and the share of src that the L2 holds is not read from memory
    p5_estimate_ms = bound_ms(ROWDMA_READS * pk.ROW * 4 * max(
        0.0, 1.0 - l2_bytes / (ROWDMA_SRC * pk.ROW * 4)) + row_fixed, 0)[0]
    v, p, k, E_c, Rp = (planar_in[key] for key in ("v", "p", "k", "E_c",
                                                    "Rp"))
    kE = k * E_c
    out = torch.zeros_like(v)
    lanes = out[:, :, :kE].view(PROBE_B, 3, k, E_c)
    timing["planar_write"] = dict(
        ms=kernel_ms(lambda: pk.planar_write(v, k, E_c),
                     "planar_write_kernel"),
        plain_ms=events_ms(lambda: pk.planar_write_plain(v, k, E_c)),
        library_ms=events_ms(lambda: v[:, :, :kE].reshape(
            PROBE_B, 3, k, E_c).permute(1, 2, 0, 3).contiguous()),
        bound=bound_ms(2 * PROBE_B * 3 * kE * 4, 0))
    timing["planar_read"] = dict(
        ms=kernel_ms(lambda: pk.planar_read(p), "planar_read_kernel"),
        plain_ms=events_ms(lambda: pk.planar_read_plain(p)),
        library_ms=events_ms(lambda: lanes.copy_(p.permute(2, 0, 1, 3))),
        bound=bound_ms(PROBE_B * 3 * (kE + Rp) * 4, 0))
    must_equal("planar_read library call", out, pk.planar_read(p))
    # the probe's round trip at PROBE_B: device ms per iteration
    trip = total_device_ms(
        lambda: pk.planar_read(pk.planar_write(v, k, E_c)) * 0.5 + v * 0.5,
        reps)
    log(f"planar round trip at B={PROBE_B}: {trip:.4f} ms device per "
        f"iteration (two kernels and the update; torch.profiler); the probe "
        f"at B=2688: {planar['ms']} ms host clock for 5 and 45 iterations")
    log(f"row probe: gather {rowdma['gather_ms']:.4f} ms, row kernel "
        f"{rowdma['kernel_ms']:.4f} ms per {ROWDMA_READS} reads (host "
        f"clock); {n_unique} distinct rows")

    rows_out = []
    for K in tt.PROBE_KERNELS:
        t = timing[K.name]
        b_ms, b_by = t.pop("bound")
        rows_out.append(dict(
            name=K.name, route="cuda", source=f"tpufem_torch/csrc/{K.source}",
            replaces=K.replaces, launches=launches[K.name],
            path="the three probes' mains at their defaults",
            max_abs_err=0.0, ms=t.pop("ms"),
            plain_ms=t.pop("plain_ms"), bound_ms=b_ms, bound_by=b_by,
            library_ms=t.pop("library_ms"), **t))
        r = rows_out[-1]
        log(f"time {K.name}: {r['ms']:.4f} ms device per launch "
            f"(torch.profiler); bound {b_ms:.4f} ms by {b_by} "
            f"({b_ms / r['ms']:.1%} of it); plain {r['plain_ms']:.4f} ms; "
            f"library {r['library_ms']:.4f} ms"
            + (f"; variants {r['variants']}" if "variants" in r else "")
            + (f"; every indexed row from memory "
               f"{r['row_stream_bound_ms']:.4f} ms; estimate: every indexed "
               f"row from memory less the share of src that the L2 "
               f"({l2_bytes} B) holds, {p5_estimate_ms:.4f} ms "
               f"({p5_estimate_ms / r['ms']:.1%} of the measured time)"
               if "row_stream_bound_ms" in r else ""))
    return rows_out



def turns_phase(args, dev):
    """8d's K6 timing and 9d's K5b/K3 turns alone, on box_tet10(n): run
    once per tree in turns (parent, change, change, parent) from a copy of
    this script beside each tree's tpufem_torch.  Prints {"turns": ...}."""
    import tpufem_torch as tt

    f32 = torch.float32
    n = args.n
    coords, conn = tt.meshgen.box_tet10(n, n, n)
    N, M = coords.shape[0], conn.shape[0]
    conn_t = torch.as_tensor(conn, device=dev)
    out = {"tree": os.path.dirname(os.path.dirname(tt.__file__)),
           "elements": int(M), "stiffness_fused": {}}
    for dt in (torch.float64, f32):
        ct = torch.as_tensor(coords, dtype=dt, device=dev)
        out["stiffness_fused"][str(dt)[6:]] = spread(
            stiffness_windows(ct, conn_t))
        del ct
        torch.cuda.empty_cache()
    plan = tt.PackedPlan.build(coords, conn, N, device=dev)
    op = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                        plan=plan, fuse="", dtype=f32,
                                        device=dev)
    m = plan.meta
    rng = np.random.default_rng(args.seed + 2)
    fe3 = torch.as_tensor(rng.standard_normal(
        (3, m.nodes_per_elem, m.n_clusters, m.elems_per_cluster)),
        dtype=f32, device=dev)
    out.update({name: spread(w) for name, w in
                planar_turns(op, fe3, args.reps).items()})
    log(json.dumps({"turns": out}))
    return []


# tpufem's record of the converged refined solve (PERFORMANCE.md:11-15):
# cycles, inner iterations, f64 true relative residual; no time of it is
# used here
TPUFEM_RECORD = {55: (3, 2454, 3.7e-7), 95: (3, 3130, 5.2e-7),
                 119: (3, 4137, 3.1e-7)}


def scale_phase(args, dev):
    """The converged refined solve at tpufem's sizes (phase 11 of the
    module docstring): tpufem_torch.scripts.solve_scale's flow from a
    fresh build, without its cache.  Returns the launches of K1-K3."""
    import tpufem_torch as tt
    from tpufem_torch.ops import fused_kernels as fk, packed_kernels as pk
    from tpufem_torch.scripts import solve_scale

    n = args.scale_n
    for K in tt.KERNELS:
        K.launches = K.replayed = 0
    # scalar Jacobi: tpufem's record at these sizes is scalar Jacobi's
    # (PERF.md; solve_scale's own argument runs block Jacobi)
    out, system, u = solve_scale.run(n, "jacobi", 1e-6, cache=False,
                                     device=dev, log=log)
    launches = {K.name: K.launches for K in tt.PACKED_KERNELS}
    replayed = {K.name: K.replayed for K in tt.PACKED_KERNELS}
    rec = TPUFEM_RECORD.get(n)
    log(f"scale: box_tet10({n}) {out['elements']} elements, {out['nodes']} "
        f"nodes, precondition {out['precondition']}, every {out['every']}; "
        f"setup {out['setup_seconds']:.2f} s "
        f"({ {k: round(v, 3) for k, v in out['setup_stages'].items()} }); "
        f"solve {out['solve_seconds']:.2f} s, cycles {out['cycles']}, inner "
        f"iterations {out['iterations']} "
        f"({out['solve_seconds'] / max(out['iterations'], 1) * 1e3:.3f} ms "
        f"each, derived), outer history (rel) {out['outer_history_rel']}, "
        f"f64 true rel residual {out['rel_residual']:.3e}; tpufem's record "
        f"(cycles, inner iterations, residual): {rec}; peak device memory "
        f"{out['max_memory_allocated'] / 1e9:.2f} GB; tip uz mean "
        f"{out['tip_uz_mean']:.6e}, min {out['tip_uz_min']:.6e}; launches "
        f"{launches} (of them by CUDA graph replays {replayed})")
    if not out["rel_residual"] <= 1e-6:
        fail(f"scale: f64 true relative residual {out['rel_residual']:.3e} "
             f"> 1e-6")
    if out["cycles"] != 3:
        fail(f"scale: {out['cycles']} refinement cycles, not 3")
    tip = out["tip_uz_mean"]
    if not (np.isfinite(tip) and tip < 0):
        fail(f"scale: tip uz mean {tip} is not finite and negative")
    for name, c in launches.items():
        if c <= 0:
            fail(f"scale: kernel {name} was not launched")
    for name in ("fused_yc", "combine"):
        if replayed[name] <= 0:
            fail(f"scale: kernel {name} was not launched by a CUDA graph "
                 f"replay")

    # K1-K3 at this plan's sizes, on its real tables, against their plain
    # versions (after the counts were read): the operator applied once to
    # the solution, K1 then K2 each on the same input as its plain
    # version; and the Jacobi diagonal with K3 against it with K3's plain
    # version (K2 in both).  Bitwise, as phase 4 holds them at --n.
    op = system.op
    uX = op.plan.pack(u.reshape(-1, 3).float())
    Yc = op.fused_stage(uX)
    checks = (
        ("fused_yc", Yc, op.fused_stage(uX, kernel=fk.fused_yc_plain)),
        ("combine", op.combine_stage(Yc),
         op.combine_stage(Yc, kernel=pk.combine_plain)),
        ("compress_gather", op.diagonal(),
         op.diagonal(compress=pk.compress_gather_plain)))
    for name, got, want in checks:
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            fail(f"scale: {name} differs from its plain version at "
                 f"box_tet10({n}): max |d| {err:.3e} (max |ref| "
                 f"{float(want.abs().max()):.3e})")
        log(f"scale parity {name}: bitwise equal to its plain version on "
            f"{tuple(got.shape)} (max |ref| {float(want.abs().max()):.3e})")
    return launches


# phase 12's material: tpufem's tests/test_solvers.py MAT (solids and
# shells); the packed family runs the box of the record (E, NU above)
FAMILY_MAT = {"E": 200.0, "nu": 0.3, "membrane": (200.0, 0.3, 0.05),
              "bending": (200.0, 0.3, 0.05)}
MODAL_OUTER, MODAL_INNER = 12, 800
# phase 13a's interface tolerance, relative to ||g||: bench_hybrid.py's
# absolute 1e-4 is 1.33e-9 of config 4's ||g|| (75,218), below what the
# float32 interface CG reaches (its recurrence turns at 2.1e-9, and a
# chunk's restart from the true residual there diverges: PERF.md)
HYBRID_TOL_REL = 1e-7


def family_phase(args, dev):
    """The rest of the solver family, the mixed solid + shell driver and
    the pure-shell plates (phase 12 of the module docstring).  Returns the
    launches of K1, K2, K3 and K6 summed over its main-path windows, and
    those of them by graph replays."""
    import tpufem_torch as tt
    from tpufem_torch.ops import fused_kernels as fk, packed_kernels as pk
    from tpufem_torch.solvers.bicgstab import BiCGStabBlock
    from tpufem_torch.ops import stiffness_kernels as sk
    from tpufem_torch.solvers.cg import CONVERGED, NAN_INF, NOT_SPD
    from tpufem_torch.solvers.gmres import GMRESCycle

    f64 = torch.float64
    mg = tt.meshgen
    watched = (tt.FUSED_YC, tt.COMBINE, tt.COMPRESS_GATHER,
               tt.STIFFNESS_FUSED)
    totals = {K.name: [0, 0] for K in watched}

    def zero():
        torch.cuda.synchronize()
        for K in tt.KERNELS:
            K.launches = K.replayed = 0
        torch.cuda.reset_peak_memory_stats(dev)

    def read(label, need):
        """Launches since zero() (and by graph replays); fails when a
        kernel of `need` has none."""
        torch.cuda.synchronize()
        out = {K.name: (K.launches, K.replayed) for K in watched}
        for name, (n, r) in out.items():
            totals[name][0] += n
            totals[name][1] += r
        for name in need:
            if out[name][0] <= 0:
                fail(f"family {label}: kernel {name} was not launched")
        text = ", ".join(
            f"{k} {n}" + (f" ({100.0 * r / n:.1f}% by graph replays)"
                          if n else "") for k, (n, r) in out.items())
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        return f"launches {text}; peak device memory {peak:.2f} GB"

    def check(label, info, rep, true, last):
        """rep, true, last: the reported, the recomputed f64 and the
        history's last residual, each relative to the norm of which the
        solve's bar is 1e-6.  Each of the last two lies within 1e-6 of
        rep relative to the larger; a converged solve's recomputed
        residual lies under the bar."""
        status = int(info.status)
        if status in (NOT_SPD, NAN_INF):
            fail(f"family {label}: status {status}")
        gaps = [abs(rep - x) / max(rep, x) for x in (true, last)]
        log(f"family {label}: reported residual {rep:.9e}, f64 recomputed "
            f"{true:.9e}, history's last {last:.9e}; relative gaps "
            f"{gaps[0]:.3e}, {gaps[1]:.3e}")
        for name, gap in zip(("f64 recomputed", "history's last entry"),
                             gaps):
            if not gap <= 1e-6:
                fail(f"family {label}: reported residual and the {name} "
                     f"differ by {gap:.3e} relative, more than 1e-6")
        if status == CONVERGED and not true <= 1e-6 * (1.0 + 1e-6):
            fail(f"family {label}: converged, but the f64 recomputed "
                 f"residual {true:.9e} is above the bar 1e-6")

    # -- 12a. the packed family at box_tet10(n), f64 --------------------
    n = args.n
    t0 = time.perf_counter()
    coords, conn = mg.box_tet10(n, n, n)
    N, M = coords.shape[0], conn.shape[0]
    fixed = mg.boundary_nodes(coords, 2, 0.0)
    top = mg.boundary_nodes(coords, 2, 1.0)
    b = np.zeros((N, 3))
    b[top, 2] = -1e3
    t_mesh = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = tt.PackedPlan.build(coords, conn, N, device=dev)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                        plan=plan, dtype=f64, device=dev)
    torch.cuda.synchronize()
    t_geom = time.perf_counter() - t0
    zero()
    t0 = time.perf_counter()
    system = tt.PackedSystem(op, fixed_nodes=fixed, precondition="jacobi")
    torch.cuda.synchronize()
    t_sys = time.perf_counter() - t0
    sys_launches = read("Jacobi system", ["compress_gather", "combine"])
    t0 = time.perf_counter()
    op64 = tt.F64Operator(coords, conn, "c3d10", E, NU, geometry_dtype=f64,
                          device=dev)
    torch.cuda.synchronize()
    t_op64 = time.perf_counter() - t0
    log(f"family setup: box_tet10({n}) {M} elements, {N} nodes, f64 packed "
        f"operator; mesh {t_mesh:.2f} s, plan {t_plan:.2f} s, geometry "
        f"{t_geom:.2f} s, Jacobi system {t_sys:.2f} s ({sys_launches}), "
        f"F64Operator {t_op64:.2f} s")
    m3 = torch.ones((N, 3), dtype=f64, device=dev)
    m3[torch.as_tensor(fixed, device=dev).long()] = 0.0
    b_t = torch.as_tensor(b, dtype=f64, device=dev)
    bnorm = float(torch.linalg.norm(b_t * m3))

    def resid3(u3):
        """P (b - K u) by the independent f64 operator, [N, 3]."""
        return (b_t - op64(u3.reshape(-1)).reshape(N, 3)) * m3

    # the kernels' histories against their plain versions' on the same
    # tables (before the counted windows: comparison launches do not count)
    def plain_op(X):
        return op.combine_stage(op.fused_stage(X, kernel=fk.fused_yc_plain),
                                kernel=pk.combine_plain)

    bX = system.pc.project_residual(system._rhs(b, None)[0])
    t0 = time.perf_counter()
    u_k, i_k = system.solve_bicgstab(b, tol=1e-6, max_iter=64)
    blk = BiCGStabBlock(plain_op, system.mask, constraints=system.pc,
                        tol=1e-6)
    blk.graphed = False
    uX_p, i_p = blk.solve(bX, max_iter=64)
    torch.cuda.synchronize()
    same = (torch.equal(i_k.history, i_p.history)
            and torch.equal(u_k, plan.unpack(uX_p))
            and int(i_k.iterations) == int(i_p.iterations) == 64)
    if not same:
        fail("family: BiCGStab's first 64 iterations through K1/K2 differ "
             "from the same with their plain versions")
    log(f"family parity BiCGStab: the first 64 iterations through the "
        f"kernels (CUDA graphs) bitwise equal to the plain versions' "
        f"(eager): history {i_k.history[64].item():.6e} at 64, "
        f"{time.perf_counter() - t0:.2f} s")
    del blk, uX_p, u_k
    t0 = time.perf_counter()
    d_p = op.diagonal(compress=pk.compress_gather_plain,
                      combine=pk.combine_plain)
    jac_p = torch.where(torch.abs(d_p) > 0,
                        1.0 / torch.where(d_p == 0, 1.0, d_p),
                        0.0) * system.mask
    if not torch.equal(jac_p, system.jacobi):
        fail("family: the Jacobi diagonal through K3/K2 differs from the "
             "plain versions'")
    Mb = float(torch.linalg.norm(system.jacobi * bX))
    gtol = 1e-6 * Mb
    u_k, i_k = system.solve_gmres(b, tol=gtol, max_iter=50, restart=50)
    cyc = GMRESCycle(plain_op, system.mask, constraints=system.pc,
                     M_inv=jac_p, tol=gtol, restart=50)
    cyc.graphed = False
    uX_p, i_p = cyc.solve(bX, max_iter=50)
    torch.cuda.synchronize()
    same = (torch.equal(i_k.history, i_p.history)
            and torch.equal(u_k, plan.unpack(uX_p))
            and torch.equal(i_k.residual_norm, i_p.residual_norm))
    if not same:
        fail("family: GMRES's first cycle through K1/K2 differs from the "
             "same with their plain versions")
    log(f"family parity GMRES: the first cycle (50 steps, left Jacobi) "
        f"through the kernels (one CUDA graph) bitwise equal to the plain "
        f"versions' (eager), Jacobi diagonal through K3 bitwise equal too; "
        f"residual {float(i_k.residual_norm) / Mb:.6e} of ||M^-1 b||, "
        f"{time.perf_counter() - t0:.2f} s")
    del cyc, uX_p, u_k, jac_p, d_p
    torch.cuda.empty_cache()

    # BiCGStab to 1e-6 (relative to ||r0|| = ||P b||)
    zero()
    t0 = time.perf_counter()
    u, info = system.solve_bicgstab(b, tol=1e-6, max_iter=4000)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    text = read("BiCGStab", ["fused_yc", "combine"])
    it = int(info.iterations)
    rep = float(info.residual_norm) / bnorm
    true = float(torch.linalg.norm(resid3(u))) / bnorm
    last = float(info.history[it]) / bnorm
    log(f"family BiCGStab: status {int(info.status)}, iterations {it}, "
        f"residual {rep:.6e} of ||P b|| (f64 F64Operator {true:.6e}, "
        f"history's last {last:.6e}), solve {t_solve:.2f} s "
        f"({t_solve / max(it, 1) * 1e3:.3f} ms per iteration, derived); "
        f"{text}")
    check("BiCGStab", info, rep, true, last)

    # GMRES(50), left Jacobi, to 1e-6 ||M^-1 b||
    zero()
    t0 = time.perf_counter()
    u, info = system.solve_gmres(b, tol=gtol, max_iter=3000, restart=50)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    text = read("GMRES", ["fused_yc", "combine"])
    used = int(info.iterations)
    r3 = resid3(u)
    rep = float(info.residual_norm) / Mb
    true = float(torch.linalg.norm(system.jacobi * plan.pack(r3))) / Mb
    last = float(info.history[used - 1]) / Mb if used else rep
    log(f"family GMRES: status {int(info.status)}, iterations {used} "
        f"({-(-used // 50)} cycles), residual {rep:.6e} of ||M^-1 b|| (f64 "
        f"F64Operator {true:.6e}, the last cycle's estimate {last:.6e}; "
        f"unpreconditioned {float(torch.linalg.norm(r3)) / bnorm:.6e} of "
        f"||P b||), solve {t_solve:.2f} s ({t_solve / max(used, 1) * 1e3:.3f}"
        f" ms per iteration, derived); {text}")
    check("GMRES", info, rep, true, last)
    del u, r3
    torch.cuda.empty_cache()

    # modal: 5 modes, lumped mass, rho = 7800
    t0 = time.perf_counter()
    ct = torch.as_tensor(coords, dtype=f64, device=dev)
    conn_t = torch.as_tensor(conn, device=dev)
    splan = tt.ScatterPlan.build(conn, N, 3, device=dev)
    mass = splan.scatter(tt.solid.lumped_mass(ct, conn_t, "c3d10",
                                              7800.0)).reshape(N, 3)
    del splan, ct, conn_t
    torch.cuda.synchronize()
    t_mass = time.perf_counter() - t0
    zero()
    t0 = time.perf_counter()
    # 12 subspace iterations of inner PCG runs of at most 800
    # (tpufem_torch.scripts.modal_sweep, PERF.md §6): the inner limit sets
    # the floor of modes 1-3 (400 leaves the nearly double pair at
    # 1.4e-3; 800 at 1.7e-4 from the 6th iteration on), the outer count
    # that of modes 4-5 (about 2.5x a step: 6.5e-4 at 10, 1.4e-4 at 12)
    lam, modes, minfo = system.modal(mass, num_eigs=5, max_iter=MODAL_OUTER,
                                     inner_tol=1e-8,
                                     inner_max_iter=MODAL_INNER)
    torch.cuda.synchronize()
    t_modal = time.perf_counter() - t0
    text = read("modal", ["fused_yc", "combine"])
    lam_l = [float(x) for x in lam]
    res = []
    for j in range(5):
        phi = modes[..., j].contiguous()
        Mphi = mass * phi
        r = (op64(phi.reshape(-1)).reshape(N, 3) - lam_l[j] * Mphi) * m3
        res.append(float(torch.linalg.norm(r))
                   / (lam_l[j] * float(torch.linalg.norm(Mphi * m3))))
    on_fixed = bool(modes[torch.as_tensor(fixed, device=dev).long()].any())
    hist = minfo.eigenvalue_history
    log(f"family modal: 5 modes, {MODAL_OUTER} subspace iterations of 7 "
        f"columns, inner Jacobi PCG (tol 1e-8, at most {MODAL_INNER} "
        f"iterations), lumped mass "
        f"(rho 7800) {t_mass:.2f} s, modal {t_modal:.2f} s; eigenvalues "
        f"{[f'{x:.9e}' for x in lam_l]}; f64 eigen-residuals "
        f"||K phi - lam M phi|| / (lam ||M phi||) "
        f"{[f'{x:.3e}' for x in res]}; non-zero on a fixed node: "
        f"{on_fixed}; {text}")
    for i, row in enumerate(hist):
        log(f"  Ritz values, iteration {i + 1}: "
            f"{[f'{x:.9e}' for x in row]}")
    if on_fixed:
        fail("family modal: a mode is non-zero on a fixed node")
    if not (np.all(np.isfinite(lam_l)) and max(res) <= 1e-3):
        fail(f"family modal: eigen-residuals {res} above 1e-3")
    del system, op, op64, plan, modes, mass, lam
    torch.cuda.empty_cache()

    # -- 12b. BASELINE config 3 at n = --mixed-n --------------------------
    m = args.mixed_n
    t0 = time.perf_counter()
    coords, tets_all = mg.box_tet(m, m, m)
    _, wedges_all = mg.box_wedge(m, m, m)
    tets = tets_all[coords[tets_all].mean(axis=1)[:, 2] < 0.5]
    wedges = wedges_all[coords[wedges_all].mean(axis=1)[:, 2] > 0.5]
    top = mg.boundary_nodes(coords, 2, 1.0)
    grid = top[np.lexsort((coords[top, 1], coords[top, 0]))].reshape(
        m + 1, m + 1)
    quads = np.stack([grid[:-1, :-1], grid[1:, :-1], grid[1:, 1:],
                      grid[:-1, 1:]], axis=-1).reshape(-1, 4).astype(np.int32)
    del tets_all, wedges_all
    N = coords.shape[0]
    force = np.zeros((N, 6))
    force[top, 0] = 0.01
    force[top, 2] = -0.02
    fixed = mg.boundary_nodes(coords, 2, 0.0)
    blocks = dict(c3d4=tets, c3d6=wedges, s4=quads)
    fnorm = float(np.linalg.norm(force))
    t_mesh = time.perf_counter() - t0
    log(f"family mixed: BASELINE config 3 at n = {m}: {tets.shape[0]} c3d4, "
        f"{wedges.shape[0]} c3d6, {quads.shape[0]} s4, {N} nodes, [N, 6] "
        f"state, f64, Jacobi, tol 1e-6 ||b||; mesh {t_mesh:.2f} s")
    sols = {}
    for operator, need in (("packed", ["fused_yc", "combine",
                                        "compress_gather",
                                        "stiffness_fused"]),
                           ("assembled", ["stiffness_fused"])):
        zero()
        timings = {}
        u6, info = tt.static_structure_solver(
            coords, force, fixed, material=FAMILY_MAT, operator=operator,
            precondition=True, tol=1e-6 * fnorm, max_iter=20000, dtype=f64,
            device=dev, timings=timings, **blocks)
        torch.cuda.synchronize()
        text = read(f"mixed {operator}", need)
        sols[operator] = (u6, info, timings, text)
        torch.cuda.empty_cache()
    model = tt.build_static_model(coords, blocks, FAMILY_MAT, dtype=f64,
                                  device=dev)
    d6 = model.diagonal6()
    P = (d6.abs() > 0).to(f64)
    P[torch.as_tensor(fixed, device=dev).long()] = 0.0
    f_t = torch.as_tensor(force, device=dev)
    for operator, (u6, info, timings, text) in sols.items():
        it = int(info.iterations)
        rep = float(info.residual_norm) / fnorm
        true = float(torch.linalg.norm((f_t - model(u6)) * P)) / fnorm
        last = float(info.history[it]) / fnorm
        setup = {k: round(v, 3) for k, v in timings.items() if k != "solve"}
        log(f"family mixed {operator}: status {int(info.status)}, "
            f"iterations {it}, residual {rep:.6e} of ||b|| (f64 assembled "
            f"model {true:.6e}, history's last {last:.6e}); setup {setup} s,"
            f" solve {timings['solve']:.2f} s "
            f"({timings['solve'] / max(it, 1) * 1e3:.3f} ms per iteration, "
            f"derived); {text}")
        check(f"mixed {operator}", info, rep, true, last)
    up, ua = sols["packed"][0], sols["assembled"][0]
    excess = float(((up - ua).abs()
                    - (2e-5 * ua.abs() + 1e-7 * ua.abs().max())).max())
    rel = float((up - ua).abs().max() / ua.abs().max())
    tip_ux = float(ua[torch.as_tensor(top).long(), 0].mean())
    log(f"family mixed: packed against assembled max |d| / max |u| "
        f"{rel:.3e}; tip ux mean {tip_ux:.6e}; largest excess over rtol "
        f"2e-5, atol 1e-7 max|u|: {excess:.3e}")
    if not excess <= 0.0:
        fail("family mixed: the packed and assembled solutions differ by "
             "more than rtol 2e-5, atol 1e-7 max|u|")

    # K1-K3 and K6 at this model's sizes against their plain versions
    # (after the counts were read), bitwise: the packed system's c3d4
    # primary on its own plan applied to the packed solution (K1, then
    # K2 on the same input) and its Jacobi diagonal (K3 and K2); K6 for
    # the tets and wedges as the assembled model and the packed system's
    # wedge block hold them
    msys = tt.PackedMixedSystem(coords, blocks, FAMILY_MAT,
                                fixed_nodes=fixed, dtype=f64, device=dev)
    prim = msys.op.primary
    uX = prim.plan.pack(up[:, :3].contiguous())
    Yc = prim.fused_stage(uX)
    ct = torch.as_tensor(coords, dtype=f64, device=dev)
    plain_k = {et: sk.stiffness_fused_plain(
        ct, torch.as_tensor(c, device=dev), et, FAMILY_MAT["E"],
        FAMILY_MAT["nu"]) for et, c in (("c3d4", tets), ("c3d6", wedges))}
    checks = (
        ("fused_yc c3d4", Yc,
         prim.fused_stage(uX, kernel=fk.fused_yc_plain)),
        ("combine", prim.combine_stage(Yc),
         prim.combine_stage(Yc, kernel=pk.combine_plain)),
        ("compress_gather", prim.diagonal(),
         prim.diagonal(compress=pk.compress_gather_plain,
                       combine=pk.combine_plain)),
        ("stiffness_fused c3d4 (assembled)", model.solid_ops[0].K,
         plain_k["c3d4"]),
        ("stiffness_fused c3d6 (assembled)", model.solid_ops[1].K,
         plain_k["c3d6"]),
        ("stiffness_fused c3d6 (packed)", msys.op.solids[0].K,
         plain_k["c3d6"]))
    for name, got, want in checks:
        torch.cuda.synchronize()
        if not (got.shape == want.shape and torch.equal(got, want)):
            fail(f"family mixed: {name} differs from its plain version on "
                 f"{tuple(want.shape)}: max |d| "
                 f"{float((got - want).abs().max()):.3e}")
        log(f"family mixed parity {name}: bitwise equal to its plain "
            f"version on {tuple(got.shape)} (max |ref| "
            f"{float(want.abs().max()):.3e})")
    del model, sols, up, ua, d6, P, f_t, msys, prim, uX, Yc, ct, plain_k
    del checks
    torch.cuda.empty_cache()

    # -- 12c. pure-shell plates -------------------------------------------
    p = args.plate_n
    for etype, gen in (("s4", mg.grid_quad), ("s3", mg.grid_tri)):
        coords, conn = gen(p, p)
        N = coords.shape[0]
        tip = mg.boundary_nodes(coords, 0, 1.0)
        fixed = mg.boundary_nodes(coords, 0, 0.0)
        # the transverse force, an end moment and an in-plane pull: the
        # Kirchhoff element has no stiffness on w (nor theta_z), so the
        # transverse force alone is masked out and leaves u = 0
        force = np.zeros((N, 6))
        force[tip, 2] = -1e-3
        force[tip, 4] = 1e-4
        force[tip, 0] = 1e-3
        fnorm = float(np.linalg.norm(force))
        zero()
        timings = {}
        u6, info = tt.static_structure_solver(
            coords, force, fixed, material=FAMILY_MAT, precondition=True,
            tol=1e-6 * fnorm, max_iter=20000, dtype=f64, device=dev,
            timings=timings, **{etype: conn})
        torch.cuda.synchronize()
        text = read(f"plate {etype}", [])
        model = tt.build_static_model(coords, {etype: conn}, FAMILY_MAT,
                                      dtype=f64, device=dev)
        d6 = model.diagonal6()
        live = d6.abs() > 0
        P = live.to(f64)
        P[torch.as_tensor(fixed, device=dev).long()] = 0.0
        f_t = torch.as_tensor(force, device=dev)
        it = int(info.iterations)
        rep = float(info.residual_norm) / fnorm
        true = float(torch.linalg.norm((f_t - model(u6)) * P)) / fnorm
        last = float(info.history[it]) / fnorm
        dead = bool(u6[~live].any())
        setup = {k: round(v, 3) for k, v in timings.items() if k != "solve"}
        log(f"family plate {etype}: grid {p} x {p}, {conn.shape[0]} "
            f"elements, {N} nodes; status {int(info.status)}, iterations "
            f"{it}, residual {rep:.6e} of ||b|| (f64 {true:.6e}, history's "
            f"last {last:.6e}); load on DOFs with stiffness "
            f"{float(torch.linalg.norm(f_t * live)) / fnorm:.6f} of ||b||; "
            f"DOFs without stiffness: w {int((~live[:, 2]).sum())}, theta_z "
            f"{int((~live[:, 5]).sum())}, non-zero there: {dead}; tip ux "
            f"{float(u6[torch.as_tensor(tip).long(), 0].mean()):.6e}, "
            f"theta_y {float(u6[torch.as_tensor(tip).long(), 4].mean()):.6e}"
            f"; setup {setup} s, solve {timings['solve']:.2f} s; {text}")
        check(f"plate {etype}", info, rep, true, last)
        if dead:
            fail(f"family plate {etype}: a DOF without stiffness (w or "
                 f"theta_z) is non-zero")
        del model, u6, d6
        torch.cuda.empty_cache()
    return ({k: v[0] for k, v in totals.items()},
            {k: v[1] for k, v in totals.items()})


# tpufem's counts for BASELINE config 4 (box_tet(55), 512 RCB parts: its
# host rule, hybrid.py:371-392, PERFORMANCE.md's table) and its hybrid
# record (scripts/bench_hybrid.py 26 32: 32 balanced region-grown parts,
# Jacobi; PERFORMANCE.md "Hybrid Schur substructuring at config-4 scale")
CONFIG4 = {"n": 55, "parts": 512, "nI_max": 289, "nG_max": 542,
           "interface": 94883}
HYBRID_RECORD = {"interface": 7.9e3, "iterations": 410,
                 "displacement": 2e-5}
# phase 8's clustered static solve at box_tet10(55): its recorded count
STATIC_ITERATIONS = 1562


def tpufem_interface(conn, labels, fixed, n_nodes: int, n_parts: int):
    """tpufem's host rule, part by part (hybrid.py:371-392): the nodes of
    more than one part and the fixed nodes are the interface.  Returns
    (interface nodes, nI_max, nG_max)."""
    cnt = np.zeros(n_nodes, np.int64)
    parts = []
    for p in range(n_parts):
        nodes = np.unique(conn[labels == p])
        cnt[nodes] += 1
        parts.append(nodes)
    iface = cnt > 1
    iface[fixed] = True
    return (int(iface.sum()), max(int((~iface[u]).sum()) for u in parts),
            max(int(iface[u].sum()) for u in parts))


def hybrid_phase(args, dev):
    """Schur substructuring and the remaining operators (phase 13 of the
    module docstring).  Returns the launches of K1-K3, K6, K7a and K7b
    summed over its main-path windows, and those of them by graph
    replays."""
    import tpufem_torch as tt
    from tpufem_torch.ops import cluster_kernels as ck
    from tpufem_torch.ops import stiffness_kernels as sk
    from tpufem_torch.scripts import bench_hybrid
    from tpufem_torch.solvers.cg import CONVERGED, NAN_INF, NOT_SPD

    f32, f64 = torch.float32, torch.float64
    mg = tt.meshgen
    watched = (tt.FUSED_YC, tt.COMBINE, tt.COMPRESS_GATHER,
               tt.STIFFNESS_FUSED, tt.CLUSTER_EXPAND, tt.CLUSTER_COMPRESS)
    totals = {K.name: [0, 0] for K in watched}

    def zero():
        torch.cuda.synchronize()
        for K in tt.KERNELS:
            K.launches = K.replayed = 0
        torch.cuda.reset_peak_memory_stats(dev)

    def read(label, need):
        torch.cuda.synchronize()
        out = {K.name: (K.launches, K.replayed) for K in watched}
        for name, (n, r) in out.items():
            totals[name][0] += n
            totals[name][1] += r
        for name in need:
            if out[name][0] <= 0:
                fail(f"hybrid {label}: kernel {name} was not launched")
        return ", ".join(f"{k} {n}" + (f" ({r} by graph replays)" if n
                                        else "")
                         for k, (n, r) in out.items())

    def solve_checks(label, out, gate=True):
        """Each solve's status, count, time and history (fails on NOT_SPD
        or NAN_INF when `gate`); True when the histories are bitwise
        equal."""
        for k, r in enumerate(out["solves"]):
            h = r["history"]
            j = int(np.argmin(h))
            log(f"hybrid {label} solve {k}: status {r['status']}, "
                f"interface-CG iterations {r['iterations']}, "
                f"{r['seconds']:.3f} s, recurrence ||r|| "
                f"{r['residual_norm']:.3e}, history's last "
                f"{r['history_last_rel']:.3e} of ||g|| {h[0]:.3e} (least "
                f"{h[j] / h[0]:.3e} at iteration {j}; tol {out['tol']:.4g} "
                f"absolute" + (f" = {out['tol_rel']:g} ||g||)"
                               if out["tol_rel"] else ")"))
            if gate and r["status"] in (NOT_SPD, NAN_INF):
                fail(f"hybrid {label}: solve {k} status {r['status']}")
        h = [r["history"] for r in out["solves"]]
        same = all(np.array_equal(h[0], x) for x in h[1:])
        log(f"hybrid {label}: the {len(h)} interface histories bitwise "
            f"equal: {same} ({h[0].size} entries each)")
        return same

    # 13a. BASELINE config 4 at full size, every count 0 first
    n, P = args.hybrid_n, args.hybrid_parts
    zero()
    t0 = time.perf_counter()
    out, system, u, u_ref = bench_hybrid.run(
        n, P, "rcb", "bdd", slim=True, interior_inverse=True,
        matrix_free_gg=True, tol_rel=HYBRID_TOL_REL, max_iter=800,
        ref="refined", ref_tol_rel=1e-6, solves=2, device=dev, log=log)
    launches = read("13a", ("stiffness_fused", "fused_yc", "combine",
                            "compress_gather"))
    t_all = time.perf_counter() - t0
    coords, conn = mg.box_tet(n, n, n)
    N = coords.shape[0]
    fixed = mg.boundary_nodes(coords, 2, 0.0)
    host = tpufem_interface(conn, out["labels"], fixed, N, P)
    got = (out["n_interface"], out["nI_max"], out["nG_max"])
    rb = out["resident_bytes"]
    log(f"hybrid 13a: box_tet({n}) {out['elements']} c3d4 elements, "
        f"{out['nodes']} nodes, {P} RCB parts of "
        f"{out['part_sizes'][0]}-{out['part_sizes'][1]} elements; "
        f"interface nodes {got[0]}, nI_max {got[1]}, nG_max {got[2]} "
        f"(tpufem's host rule on the same labels: {host}; PERFORMANCE.md "
        f"at 512 parts: 289, 542, 92.7k); mesh {out['mesh_seconds']:.2f} s, "
        f"partition {out['partition_seconds']:.2f} s, build "
        f"{out['build_seconds']:.2f} s by stage "
        f"{ {k: round(v, 3) for k, v in out['build_stages'].items()} }; "
        f"resident Kinv {rb.get('Kinv', 0) / 1e9:.3f} GB, Sinv "
        f"{rb.get('Sinv', 0) / 1e9:.3f} GB, K_IG {rb['K_IG'] / 1e9:.3f} GB "
        f"(PERFORMANCE.md: 1.5, 5.4, 2.9), all blocks "
        f"{sum(rb.values()) / 1e9:.3f} GB; peak device memory through the "
        f"solves {out['max_memory_allocated'] / 1e9:.2f} GB; schur_matvec "
        f"{out['schur_matvec_ms']:.3f} ms, chunk {out['every']}")
    if got != host:
        fail(f"hybrid 13a: interface, nI_max, nG_max {got} differ from "
             f"tpufem's host rule {host}")
    if (n, P) == (CONFIG4["n"], CONFIG4["parts"]) and got != (
            CONFIG4["interface"], CONFIG4["nI_max"], CONFIG4["nG_max"]):
        fail(f"hybrid 13a: {got} is not config 4's (94883, 289, 542)")
    same = solve_checks("13a", out)
    ref = out["reference"]
    # the whole system's f64 true residual through the f64 operator
    op64 = tt.PartialAssemblyOperator.build(coords, conn, "c3d4", E, NU,
                                            n_nodes=N, dtype=f64, device=dev)
    mask = torch.ones((N, 3), dtype=f64, device=dev)
    mask[torch.as_tensor(fixed, device=dev).long()] = 0.0
    b = torch.zeros((N, 3), dtype=f64, device=dev)
    b[torch.as_tensor(mg.boundary_nodes(coords, 2, 1.0), device=dev).long(),
      0] = 1e3
    b = b * mask
    true_rel = float(torch.linalg.norm((b - op64(u.double())) * mask)
                     / torch.linalg.norm(b))
    d_ref = ref["rel_displacement_diff"]
    log(f"hybrid 13a: vs the refined packed c3d4 solve ({ref['cycles']} "
        f"cycles, {ref['iterations']} inner iterations, f64 true rel "
        f"residual {ref['rel_residual']:.3e}, {ref['seconds']:.2f} s): the "
        f"float32 hybrid solve's max rel displacement difference "
        f"{d_ref:.3e} (gate 1e-4; tpufem's 105k record 2e-5), its f64 "
        f"true rel residual {true_rel:.3e}; launches {launches}; phase 13a "
        f"{t_all:.1f} s")
    if not same:
        fail("hybrid 13a: the two interface histories differ")
    for k, r in enumerate(out["solves"]):
        if r["status"] != CONVERGED:
            fail(f"hybrid 13a: solve {k} status {r['status']}, not "
                 f"CONVERGED to {HYBRID_TOL_REL:g} ||g||")
    if not ref["rel_residual"] <= 1e-6:
        fail(f"hybrid 13a: the reference's f64 residual "
             f"{ref['rel_residual']:.3e} > 1e-6")
    if not d_ref <= 1e-4:
        fail(f"hybrid 13a: the float32 hybrid solve's displacement "
             f"{d_ref:.3e} from the refined packed solve, above 1e-4")
    # K6 on config 4's c3d4 mesh in float64, the build's type, bitwise its
    # plain version
    ct = torch.as_tensor(coords, device=dev).to(f64)
    cn = torch.as_tensor(conn, device=dev)
    k_got = sk.stiffness_fused(ct, cn, "c3d4", E, NU)
    k_want = sk.stiffness_fused_plain(ct, cn, "c3d4", E, NU)
    if not torch.equal(k_got, k_want):
        fail(f"hybrid 13a: stiffness_fused differs from its plain version "
             f"on {tuple(k_got.shape)}: max |d| "
             f"{float((k_got - k_want).abs().max()):.3e}")
    log(f"hybrid 13a parity stiffness_fused: bitwise equal to its plain "
        f"version on {tuple(k_got.shape)} float64")
    del system, u, u_ref, op64, k_got, k_want, mask, b
    torch.cuda.empty_cache()

    # 13b. tpufem's record row: box_tet(26), 32 balanced region-grown
    # parts, Jacobi (the dense K_GG and the factor's triangular solves)
    zero()
    out, system, u, u_ref = bench_hybrid.run(
        26, 32, "grow", "jacobi", slim=False, interior_inverse=False,
        matrix_free_gg=False, tol=1e-4, max_iter=800, ref="packed",
        ref_tol_rel=1e-5, solves=2, device=dev, log=log)
    launches = read("13b", ("stiffness_fused",))
    solve_checks("13b", out, gate=False)
    r = out["solves"][-1]
    # the same system to a tolerance relative to ||g|| (the f32 Jacobi
    # interface CG may turn away before tpufem's absolute 1e-4)
    gnorm = float(r["history"][0])
    bt = torch.zeros_like(u)
    b_np = np.zeros(tuple(u.shape), np.float32)
    cb, _ = mg.box_tet(26, 26, 26)
    b_np[mg.boundary_nodes(cb, 2, 1.0), 0] = 1e3
    b_np[mg.boundary_nodes(cb, 2, 0.0)] = 0.0
    bt.copy_(torch.as_tensor(b_np))
    t0 = time.perf_counter()
    u_rel, info = system.solve_chunked(bt, tol=1e-6 * gnorm, max_iter=800,
                                       every=out["every"])
    torch.cuda.synchronize()
    t_rel = time.perf_counter() - t0
    d_rel = float((u_rel.double() - u_ref.double()).abs().max()
                  / u_ref.double().abs().max())
    log(f"hybrid 13b (tpufem's record row): {out['elements']} elements, "
        f"interface nodes {out['n_interface']} (tpufem "
        f"{HYBRID_RECORD['interface']:g}), interface-CG iterations "
        f"{r['iterations']} status {r['status']} at tol 1e-4 (tpufem "
        f"{HYBRID_RECORD['iterations']}), warm solve {r['seconds']:.3f} s, "
        f"displacement vs the packed f32 reference "
        f"{out['reference']['rel_displacement_diff']:.3e} (tpufem "
        f"{HYBRID_RECORD['displacement']:g}); to 1e-6 ||g||: status "
        f"{int(info.status)}, {int(info.iterations)} iterations, "
        f"{t_rel:.3f} s, displacement {d_rel:.3e}; build "
        f"{out['build_seconds']:.2f} s; launches {launches}")
    del system, u, u_ref, u_rel
    torch.cuda.empty_cache()

    # 13c. the remaining operators at box_tet10(--n)
    coords, conn = mg.box_tet10(args.n, args.n, args.n)
    N, M = coords.shape[0], conn.shape[0]
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    cpo = tt.ClusteredPartialOperator.build(coords, conn, "c3d10", E, NU,
                                            n_nodes=N, dtype=f32, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    p = cpo.plan
    B, L = p.n_clusters, p.l_max
    u32 = torch.as_tensor(rng.standard_normal((N, 3)), dtype=f32,
                          device=dev)
    lc = p.lconn.reshape(B, -1)
    Uc = u32[p.l2g.long()]
    Fe = torch.as_tensor(rng.standard_normal((B, lc.shape[1], 3)),
                         dtype=f32, device=dev)
    for name, got, want in (
            ("cluster_expand", ck.cluster_expand(lc, Uc),
             ck.cluster_expand_plain(lc, Uc)),
            ("cluster_compress", ck.cluster_compress(lc, Fe, L),
             ck.cluster_compress_plain(lc, Fe, L))):
        if not torch.equal(got, want):
            fail(f"hybrid 13c: {name} differs from its plain version on "
                 f"the ClusteredPartialOperator's tables")
        log(f"hybrid 13c parity {name}: bitwise equal to its plain version "
            f"on {tuple(got.shape)} float32 ({B} clusters)")
    zero()
    for _ in range(args.reps):
        F_c = cpo(u32)
    launches = read("13c", ("cluster_expand", "cluster_compress"))
    ms_c = time_ms(lambda: cpo(u32), args.reps)
    pa = tt.PartialAssemblyOperator.build(coords, conn, "c3d10", E, NU,
                                          n_nodes=N, dtype=f32, device=dev)
    po = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                        n_nodes=N, dtype=f32, device=dev)
    F_p = pa(u32)
    F_k = po.plan.unpack(po(po.plan.pack(u32)))
    scale = float(F_p.abs().max())
    d_p = float((F_c - F_p).abs().max()) / scale
    d_k = float((F_c - F_k).abs().max()) / scale
    d_d = float((cpo.diagonal() - pa.diagonal()).abs().max()
                / pa.diagonal().abs().max())
    ms_p = time_ms(lambda: pa(u32), args.reps)
    log(f"hybrid 13c: ClusteredPartialOperator at box_tet10({args.n}) "
        f"({M} elements, {B} clusters of {p.elems_per_cluster}, affine "
        f"{cpo.Jinv.shape[1] == 1}; built in {t_build:.2f} s): "
        f"{ms_c:.4f} ms per f32 apply (PartialAssemblyOperator "
        f"{ms_p:.4f} ms), launches over {args.reps} applies {launches}; "
        f"max |F| difference relative to max |F|: {d_p:.3e} against "
        f"PartialAssemblyOperator, {d_k:.3e} against PackedPartialOperator, "
        f"diagonal {d_d:.3e} (tolerance 1e-5 each)")
    for what, d in (("PartialAssemblyOperator", d_p),
                    ("PackedPartialOperator", d_k), ("the diagonal", d_d)):
        if not d <= 1e-5:
            fail(f"hybrid 13c: ClusteredPartialOperator differs from {what} "
                 f"by {d:.3e} relative")
    del cpo, pa, po, F_c, F_p, F_k, Fe, Uc
    torch.cuda.empty_cache()
    # static_structure_solver(operator="partial") in f64, phase 8's load
    fixed = mg.boundary_nodes(coords, 2, 0.0)
    top = mg.boundary_nodes(coords, 2, 1.0)
    force = np.zeros((N, 6))
    force[top, 2] = -1e3
    bnorm = float(np.linalg.norm(force))
    timings = {}
    u6, info = tt.static_structure_solver(
        coords, force, fixed, material={"E": E, "nu": NU}, c3d10=conn,
        operator="partial", precondition=True, dtype=f64,
        tol=1e-6 * bnorm, max_iter=10000, device=dev, timings=timings)
    torch.cuda.synchronize()
    tip = float(u6[torch.as_tensor(top, device=dev).long(), 2].mean())
    ref_tip, ref_it = getattr(args, "static_solve", (None, None))
    tip_d = abs(tip - ref_tip) / abs(ref_tip) if ref_tip else float("nan")
    iters = int(info.iterations)
    log(f"hybrid 13c: static_structure_solver(operator='partial') f64: "
        f"status {int(info.status)}, iterations {iters} (phase 8's clustered "
        f"solve {ref_it}; its record {STATIC_ITERATIONS}), solve "
        f"{timings['solve']:.2f} s "
        f"({timings['solve'] / max(iters, 1) * 1e3:.3f} ms per iteration, "
        f"derived), setup "
        f"{ {k: round(v, 3) for k, v in timings.items()} }; tip uz mean "
        f"{tip:.6e}, phase 8's {ref_tip} (rel diff {tip_d:.2e}, gate 1e-4"
        f"{'' if ref_tip else '; phase 8 did not run'})")
    if int(info.status) != 1:
        fail(f"hybrid 13c: partial static solve status {int(info.status)}")
    if ref_tip and not tip_d <= 1e-4:
        fail(f"hybrid 13c: partial static tip differs from phase 8's by "
             f"{tip_d:.3e}")
    del u6
    # BSR assembly against the clustered operator on the same K (f64, a
    # smaller mesh: box_tet10(--bsr-n))
    cb, eb = mg.box_tet10(args.bsr_n, args.bsr_n, args.bsr_n)
    Nb = cb.shape[0]
    Kb = tt.solid.stiffness(torch.as_tensor(cb, device=dev),
                            torch.as_tensor(eb, device=dev), "c3d10", E, NU)
    st = tt.build_bsr_structure(eb, Nb, device=dev)
    A = tt.assemble_bsr(Kb, eb.shape[1], st)
    cop = tt.ClusteredOperator.build(Kb, eb, Nb, 3, device=dev)
    ub = torch.as_tensor(rng.standard_normal((Nb, 3)), device=dev)
    yb, yc = tt.bsr_matvec(A, ub), cop(ub)
    d_mv = float((yb - yc).abs().max() / yc.abs().max())
    d_dg = float((A.diagonal() - cop.diagonal()).abs().max()
                 / cop.diagonal().abs().max())
    ms_b = time_ms(lambda: tt.bsr_matvec(A, ub), args.reps)
    log(f"hybrid 13c: BSR at box_tet10({args.bsr_n}) ({eb.shape[0]} "
        f"elements, {st.nnzb} blocks): bsr_matvec against "
        f"ClusteredOperator {d_mv:.3e}, diagonal {d_dg:.3e} relative "
        f"(tolerance 1e-12 each); {ms_b:.4f} ms per f64 bsr_matvec")
    for what, d in (("bsr_matvec", d_mv), ("the BSR diagonal", d_dg)):
        if not d <= 1e-12:
            fail(f"hybrid 13c: {what} differs from the clustered operator "
                 f"by {d:.3e}")
    return ({k: v[0] for k, v in totals.items()},
            {k: v[1] for k, v in totals.items()})


# phase 14's mesh: box_tet10(n, n, 2 n) over 1 x 1 x 2, the synthesized
# SimJEB bundle's (tpufem's synthesize_simjeb_bundle with etype="c3d10")
WORKLOAD_N = 44
WORKLOAD_KERNELS = ("fused_yc_kernel", "combine_kernel",
                    "compress_gather_kernel")
WORKLOAD_MAX_ITER = 20000          # phase 14's f64 solves
# phase 14b: checkpointed_cg's tolerance (relative to ||b||; the restarts
# recompute the true residual, which f64 takes below this) and chunk length
CKPT_TOL, CKPT_EVERY = 1e-11, 2000


def vtu_point_data(path: str):
    """{name: [N, c] float64} of a write_vtu file's appended point data."""
    import re
    with open(path, "rb") as f:
        data = f.read()
    mark = data.find(b"<AppendedData")
    payload = data[data.find(b"_", data.find(b">", mark)) + 1:]
    out = {}
    for name, nc, off in re.findall(
            rb'Name="([^"]+)" NumberOfComponents="(\d+)" format="appended"'
            rb' offset="(\d+)"', data[:mark]):
        off = int(off)
        nbytes = int(np.frombuffer(payload, "<u8", 1, off)[0])
        out[name.decode()] = np.frombuffer(payload, "<f8", nbytes // 8,
                                           off + 8).reshape(-1, int(nc))
    return out


def pd_max_rel(path_a: str, path_b: str):
    """{field: max |a - b| / max |b|} of two result files' point data."""
    a, b = vtu_point_data(path_a), vtu_point_data(path_b)
    return {k: float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max())
            for k in b}


def workload_phase(args, dev):
    """The reference's end-to-end SimJEB workload and the host tools
    (phase 14 of the module docstring).  Returns ({kernel: launches in run
    A's workload, by torch.profiler's device records (K1-K3) or by the
    wrapper's count (K6, static_cantilever)}, {kernel: wrapper count over
    run B})."""
    import importlib.util
    import shutil
    import tempfile

    import tpufem_torch as tt
    from tpufem_torch.examples import (packed_solve, simjeb_workload,
                                       static_cantilever)
    from tpufem_torch.ops import fused_kernels as fk
    from tpufem_torch.ops import packed_kernels as pk
    from tpufem_torch.solvers.cg import (CONVERGED, MAX_ITER, NAN_INF,
                                         NOT_SPD, cg)
    from tpufem_torch.utils import checkpoint, profiling
    from tpufem_torch.workloads import simjeb

    f32, f64 = torch.float32, torch.float64
    watched = (tt.FUSED_YC, tt.COMBINE, tt.COMPRESS_GATHER)
    Es, nus = simjeb.SIMJEB_E, simjeb.SIMJEB_NU

    def zero():
        torch.cuda.synchronize()
        for K in tt.KERNELS:
            K.launches = K.replayed = 0

    def read(label):
        torch.cuda.synchronize()
        out = {K.name: K.launches for K in watched}
        for K in watched:
            if K.launches <= 0:
                fail(f"workload {label}: kernel {K.name} was not launched")
        return out, ", ".join(f"{K.name} {K.launches} ({K.replayed} by "
                              f"graph replays)" for K in watched)

    specs = {m: importlib.util.find_spec(m) is not None
             for m in ("h5py", "yaml", "plotly")}
    log(f"workload: find_spec {specs}")
    have_h5 = specs["h5py"]
    if not have_h5:
        log("workload: h5py is not installed on this machine, so the h5 "
            "file layer (sample_0.h5's write and read) is not exercised "
            "here: the sample's datasets stay in memory and the same "
            "pipeline runs from them (workloads.simjeb._run_mesh_file, "
            "which run_simjeb_workload calls after reading the h5 file); "
            "the CPU tests hold the h5 layer")
    n = args.workload_n
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workload_")
    prev = torch.get_default_dtype()
    try:
        # 14a. the bundle, synthesized on the card in float64
        syn = {}
        tt.enable_x64()
        try:
            t0 = time.perf_counter()
            if have_h5:
                p = tt.synthesize_simjeb_bundle(tmp, n=n, E=Es, nu=nus,
                                                device=dev, etype="c3d10",
                                                timings=syn)
                mesh_path, h5_path = p["mesh"], p["h5"]
                s_status, s_iters = p["status"], p["iterations"]
                sample = None
            else:
                mesh_path, sample, info = simjeb._bundle_arrays(
                    tmp, n, Es, nus, dev, "c3d10",
                    profiling.StageClock(dev, syn))
                s_status, s_iters = int(info.status), int(info.iterations)
            t_syn = time.perf_counter() - t0
        finally:
            torch.set_default_dtype(prev)
        log(f"workload 14a: bundle box_tet10({n}, {n}, {2 * n}) synthesized "
            f"on the card in float64 in {t_syn:.2f} s (stages "
            f"{ {k: round(v, 3) for k, v in syn.items()} }); synthesis PCG "
            f"status {s_status}, iterations {s_iters}"
            + (" (stopped at tpufem's 4000-iteration cap)"
               if s_status == MAX_ITER and s_iters >= 4000 else ""))
        if s_status in (NOT_SPD, NAN_INF):
            fail(f"workload 14a: synthesis PCG status {s_status}")

        def run(label, dtype, **kw):
            tm = {}
            kw.setdefault("out_path", None)
            if dtype == f64:
                tt.enable_x64()
            try:
                t0 = time.perf_counter()
                if sample is None:
                    m = tt.run_simjeb_workload(mesh_path, h5_path, E=Es,
                                               nu=nus, device=dev,
                                               timings=tm, **kw)
                else:
                    m = simjeb._run_mesh_file(
                        mesh_path, sample, etype=None, dev=dev,
                        stages=profiling.StageClock(dev, tm), E=Es, nu=nus,
                        verbose=True, **kw)
                secs = time.perf_counter() - t0
            finally:
                torch.set_default_dtype(prev)
            log(f"workload {label}: {secs:.2f} s; stages "
                f"{ {k: round(v, 3) for k, v in tm.items()} }; metrics {m}")
            if m["status"] in (NOT_SPD, NAN_INF):
                fail(f"workload {label}: PCG status {m['status']}")
            return m

        # run B: f64, cold start, to 1e-8 ||F||
        res_b = os.path.join(tmp, "result_b.vtu")
        zero()
        mB = run("run B (f64, cold start, tol 1e-8)", f64, warm_start=False,
                 tol=1e-8, max_iter=WORKLOAD_MAX_ITER, out_path=res_b)
        countsB, txt = read("run B")
        log(f"workload run B launches: {txt}")
        coords, blocks = tt.vtk_io.read_vtu(mesh_path)
        conn = blocks["c3d10"]
        N, M = coords.shape[0], conn.shape[0]

        def gates(label, m, res_path, checks):
            checks += [
                ("equilibrium < 1.0", m["equilibrium"] < 1.0),
                ("equilibrium_mean < 0.35", m["equilibrium_mean"] < 0.35),
                ("vm_max finite and positive",
                 bool(np.isfinite(m["vm_max"]) and m["vm_max"] > 0))]
            rc, rb = tt.vtk_io.read_vtu(res_path)
            checks.append(("the result .vtu reads back with the mesh's "
                           "points and connectivity",
                           np.array_equal(rc, coords)
                           and np.array_equal(rb["c3d10"], conn)))
            for what, ok in checks:
                if not ok:
                    fail(f"workload {label}: not {what} ({m})")
            log(f"workload {label}: {M} c3d10 elements, {N} nodes, {3 * N} "
                f"DOF; gates {[w for w, _ in checks]} met")

        gates("run B", mB, res_b, [
            ("status CONVERGED", mB["status"] == CONVERGED),
            ("residual_solve < 1e-3 residual_zero",
             mB["residual_solve"] < 1e-3 * mB["residual_zero"]),
            ("residual_solve <= 1.5 residual_truth + 1e-6 residual_zero",
             mB["residual_solve"] <= 1.5 * mB["residual_truth"]
             + 1e-6 * mB["residual_zero"])])

        # run A: the notebook's flow (f32, warm start), profiled
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        res_a = os.path.join(tmp, "result_a.vtu")
        zero()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            mA = run("run A (f32, warm start, tol 1e-6, 2000; profiled)",
                     f32, warm_start=True, tol=1e-6, max_iter=2000,
                     out_path=res_a)
            torch.cuda.synchronize()
        countsA, txt = read("run A")
        prof_launches = {name: sum(e.count for e in prof.key_averages()
                                   if e.device_type == DeviceType.CUDA
                                   and name in e.key)
                         for name in WORKLOAD_KERNELS}
        del prof
        log(f"workload run A launches: wrappers {txt}; torch.profiler's "
            f"device records {prof_launches}")
        for name, c in prof_launches.items():
            if c <= 0:
                fail(f"workload run A: torch.profiler recorded no {name}")
        # tpufem's bars (tests/test_workload.py) are f64 bars: its f32
        # workload misses them too (c3d10 box_tet10(3, 3, 6), on the CPU:
        # residual_solve 3.06 residual_truth), since residual_truth is one
        # f32 evaluation at the f64 truth and the f32 PCG's own residual
        # lies above that floor.  Run A reports them beside the f32
        # solution's distance from run B's.
        dA = pd_max_rel(res_a, res_b)
        log(f"workload run A (f32): residual_solve / residual_truth "
            f"{mA['residual_solve'] / mA['residual_truth']:.3f} (tpufem's "
            f"f64 bar 1.5), residual_solve / residual_zero "
            f"{mA['residual_solve'] / mA['residual_zero']:.3e} (its f64 bar "
            f"1e-3); against run B's f64 solution: displacement "
            f"{dA['displacement']:.3e}, nodal von Mises "
            f"{dA['von_mises']:.3e} (relative, max-norm)")
        gates("run A", mA, res_a, [
            ("status CONVERGED or MAX_ITER",
             mA["status"] in (CONVERGED, MAX_ITER)),
            ("finite residual sums", bool(np.isfinite(
                [mA["residual_solve"], mA["residual_truth"]]).all()))])

        # the kernels on the phase's plan against their plain versions
        t0 = time.perf_counter()
        plan = tt.PackedPlan.build(coords, conn, N, device=dev)
        ops = {dt: tt.PackedPartialOperator.build(
            coords, conn, "c3d10", Es, nus, plan=plan, dtype=dt, device=dev)
            for dt in (f32, f64)}
        torch.cuda.synchronize()
        log(f"workload kernels: plan and both operators {time.perf_counter() - t0:.2f} s")
        rng = np.random.default_rng(args.seed)
        X = torch.as_tensor(rng.standard_normal((plan.meta.n_blocks, 384)),
                            device=dev)
        for dt, op in ops.items():
            Xd = X.to(dt)
            got = op(Xd)
            want = op.combine_stage(op.fused_stage(Xd, kernel=fk.fused_yc_plain),
                                    kernel=pk.combine_plain)
            dg = op.diagonal()
            dw = op.diagonal(compress=pk.compress_gather_plain,
                             combine=pk.combine_plain)
            torch.cuda.synchronize()
            ra = float((got - want).abs().max() / want.abs().max())
            rd = float((dg - dw).abs().max() / dw.abs().max())
            log(f"workload kernels {str(dt)[6:]}: one apply (K1, K2) max rel "
                f"{ra:.1e}, the Jacobi diagonal (K3, K2) {rd:.1e} against "
                f"the plain versions")
            if dt == f32 and not (torch.equal(got, want)
                                  and torch.equal(dg, dw)):
                fail(f"workload kernels f32: apply {ra:.3e}, diagonal "
                     f"{rd:.3e}, not bitwise equal to the plain versions")
            if not (ra <= 1e-13 and rd <= 1e-13):
                fail(f"workload kernels f64: apply {ra:.3e}, diagonal "
                     f"{rd:.3e} above 1e-13")
        del got, want, dg, dw

        # 14b. checkpointed_cg on the f64 packed system
        op64 = ops[f64]
        rbe2 = tt.meshgen.boundary_nodes(coords, 2, 0.0)
        F = np.zeros((N, 3))
        F[tt.meshgen.boundary_nodes(coords, 2, 2.0), 2] = -1e4
        system = tt.PackedSystem(op64, fixed_nodes=rbe2)
        bX = system.pc.project_residual(plan.pack(torch.as_tensor(F, device=dev)))
        kw = dict(constraints=system.pc, M_inv=system.M_inv,
                  tol=CKPT_TOL * float(torch.linalg.norm(bX)))
        t0 = time.perf_counter()
        u_ref, i_ref = cg(op64, bX, max_iter=WORKLOAD_MAX_ITER, **kw)
        torch.cuda.synchronize()
        t3 = time.perf_counter() - t0
        # the first call stops at 1000 iterations, or at half the one-shot
        # count where the solve takes fewer than 2000 (small meshes)
        stop = min(1000, int(i_ref.iterations) // 2)
        path = os.path.join(tmp, "cg_state")
        t0 = time.perf_counter()
        u1, i1, d1 = checkpoint.checkpointed_cg(
            op64, bX, path, every=CKPT_EVERY, total_iter=stop, **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter() - t0
        saved = checkpoint.load_state(path)
        t0 = time.perf_counter()
        u2, i2, d2 = checkpoint.checkpointed_cg(
            op64, bX, path, every=CKPT_EVERY,
            total_iter=WORKLOAD_MAX_ITER, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter() - t0
        rel = float((u2 - u_ref).abs().max() / u_ref.abs().max())
        log(f"workload 14b checkpointed_cg (f64, tol {CKPT_TOL:g} "
            f"||b||, chunks of {CKPT_EVERY}): first call {d1} "
            f"iterations, status {int(i1.status)}, {t1:.2f} s, saved "
            f"iterations {int(saved['iterations'])}; resumed call to "
            f"{d2} iterations, status {int(i2.status)}, {t2:.2f} s; "
            f"one-shot cg {int(i_ref.iterations)} iterations, status "
            f"{int(i_ref.status)}, {t3:.2f} s; resumed against one-shot "
            f"max rel {rel:.3e} (gate 1e-8)")
        if not (int(i_ref.status) == CONVERGED and stop > 0 and d1 == stop
                and int(i1.status) == MAX_ITER
                and int(saved["iterations"]) == stop):
            fail(f"workload 14b: the one-shot cg did not converge, or the "
                 f"first checkpointed call did not stop at {stop} "
                 f"iterations")
        if not (int(i2.status) == CONVERGED and d2 > d1):
            fail("workload 14b: the resumed cg did not converge")
        if not rel <= 1e-8:
            fail(f"workload 14b: resumed solve {rel:.3e} from the one-shot")
        del u1, u2, u_ref, system, bX, op64

        # profiling.timed and trace on one f32 packed apply
        op32 = ops[f32]
        X32 = X.to(f32)
        t_host = profiling.timed(lambda: op32(X32), reps=20) * 1e3
        # a profiler window now and then misses some of a kernel's
        # launches (as in kernel_device_ms): the median of three windows,
        # and up to three traces of five applies each
        t_dev = statistics.median(total_device_ms(lambda: op32(X32), 20)
                                  for _ in range(3))
        for attempt in range(3):
            with profiling.trace(os.path.join(tmp, "trace")) as tr:
                for _ in range(5):
                    op32(X32)
            with open(tr.trace_path) as f:
                names = [e.get("name", "")
                         for e in json.load(f)["traceEvents"]]
            hits = sum("fused_yc" in nm for nm in names)
            if hits:
                break
            log(f"  profiling.trace recorded no fused_yc (attempt "
                f"{attempt + 1}; {len(names)} events)")
        log(f"workload 14b: profiling.timed of one f32 apply {t_host:.4f} ms "
            f"(host, median of 20, result read back) against "
            f"{t_dev:.4f} ms of device time (torch.profiler, median of "
            f"three windows); profiling.trace of five applies wrote "
            f"{os.path.basename(tr.trace_path)}, {len(names)} events, "
            f"{hits} naming fused_yc")
        if hits <= 0:
            fail("workload 14b: the trace names no fused_yc event")
        del ops, op32, plan, X, X32
        torch.cuda.empty_cache()

        # the three examples at their default sizes
        ex_out = os.path.join(tmp, "cantilever.vtk")
        for name, fn in (("static_cantilever", lambda: static_cantilever.main(
                ["--out", ex_out])),
                         ("simjeb_workload", lambda: simjeb_workload.main([])),
                         ("packed_solve", lambda: packed_solve.main([]))):
            zero()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = {K.name: K.launches for K in tt.KERNELS if K.launches}
            log(f"workload example {name}: returned in {secs:.2f} s; "
                f"launches {counts}")
            if name == "static_cantilever":
                k6 = tt.STIFFNESS_FUSED.launches
                info, uz = out
                if k6 <= 0:
                    fail("workload example static_cantilever: no "
                         "stiffness_fused launch")
                if int(info.status) in (NOT_SPD, NAN_INF) or not uz < 0:
                    fail(f"workload example static_cantilever: status "
                         f"{int(info.status)}, tip {uz}")
            elif name == "simjeb_workload":
                if out[0]["status"] in (NOT_SPD, NAN_INF):
                    fail(f"workload example simjeb_workload: status "
                         f"{out[0]['status']}")
            else:
                for pre, (info, uz) in out.items():
                    if int(info.status) == NAN_INF or not np.isfinite(uz):
                        fail(f"workload example packed_solve {pre}: status "
                             f"{int(info.status)}, tip {uz}")
    finally:
        torch.set_default_dtype(prev)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(zip((K.name for K in watched),
                        (prof_launches[k] for k in WORKLOAD_KERNELS)))
    launches[tt.STIFFNESS_FUSED.name] = k6
    return launches, countsB


DIST_N = 95                        # phase 15a: box_tet10(95), 5.14M c3d10
DIST_PARTS = 4
DIST_WINDOW = 200                  # 15a's PCG window (iterations)


def dist_phase(args, dev):
    """The four distributed systems of tpufem_torch.parallel on a part mesh
    (phase 15 of the module docstring).  Returns the launches of K4, K3,
    K2 and K6 over the phase's distributed systems (their builds, applies
    and solves; the kernel comparisons and the single-card references are
    not counted), and those of them by graph replays."""
    import gc
    import shutil
    import tempfile

    import torch.distributed as tdist

    import tpufem_torch as tt
    from tpufem_torch.ops import packed_kernels as pk
    from tpufem_torch.parallel import dist as pdist
    from tpufem_torch.parallel.halo import build_halo_fem
    from tpufem_torch.parallel.halo_partial import build_halo_partial_fem
    from tpufem_torch.parallel.packed_dist import build_packed_halo_fem
    from tpufem_torch.parallel.partition import partition_elements
    from tpufem_torch.scripts import dist_cost_model
    from tpufem_torch.solvers.cg import CONVERGED

    f32, f64 = torch.float32, torch.float64
    mg = tt.meshgen
    watched = (tt.EXPAND, tt.COMPRESS_GATHER, tt.COMBINE, tt.STIFFNESS_FUSED)
    totals = {K.name: [0, 0] for K in watched}

    def zero():
        torch.cuda.synchronize()
        for K in tt.KERNELS:
            K.launches = K.replayed = 0

    def read(label):
        """Adds the launches since zero() to the phase's totals."""
        torch.cuda.synchronize()
        out = {K.name: (K.launches, K.replayed) for K in watched}
        for name, (n, r) in out.items():
            totals[name][0] += n
            totals[name][1] += r
        log(f"dist {label} launches: " + ", ".join(
            f"{k} {n} ({r} by graph replays)" for k, (n, r) in out.items()))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def rel(a, b) -> float:
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        return float((a - b).abs().max() / b.abs().max())

    def box(n):
        (coords, conn), t = timed(lambda: mg.box_tet10(n, n, n))
        N = coords.shape[0]
        fixed = mg.boundary_nodes(coords, 2, 0.0)
        b = np.zeros((N, 3))
        b[mg.boundary_nodes(coords, 2, float(coords[:, 2].max())), 2] = -1e3
        return coords, conn, fixed, b, t

    def stages(tm):
        return ", ".join(f"{k} {v:.2f} s" for k, v in tm.items())

    log(f"dist: device memory at the phase's start "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved")

    # -- 15a: the packed halo system at full width ---------------------------
    n, P = args.dist_n, args.dist_parts
    coords, conn, fixed, b, t_mesh = box(n)
    N, M = coords.shape[0], conn.shape[0]
    plan, t_plan = timed(lambda: tt.PackedPlan.build(
        coords, conn, N, window_buckets=0, device="cpu"))
    tm = {"mesh": t_mesh, "plan": t_plan}
    zero()
    fem, part = build_packed_halo_fem(
        coords, conn, "c3d10", E, NU, mesh=pdist.PartMesh(P, device=dev),
        fixed_nodes=fixed, dtype=f32, precondition="block", plan=plan,
        timings=tm)
    tm["system"] = tm.pop("preconditioner")
    read("15a system (block diagonal)")
    m = part.meta
    log(f"dist 15a: box_tet10({n}) {M} c3d10 elements, {N} nodes, f32, "
        f"PartMesh({P}) on the card, block Jacobi; setup {stages(tm)} "
        f"(system: the mask and the block diagonal)")
    x_rows = int(part.xmask.sum())
    c_rows = int(part.cmask.sum())
    log(f"dist 15a partition: Bp {m.Bp} clusters and Nbp {m.Nbp} blocks a "
        f"part; Gx {m.Gx}, Gc {m.Gc}; X rounds {m.x_rounds}; Yc rounds "
        f"{m.c_rounds}; interior_cut {m.interior_cut} of Bp {m.Bp} "
        f"({m.interior_cut / m.Bp:.3f}); ghost rows an apply: {x_rows} X + "
        f"{c_rows} Yc = {(x_rows + c_rows) * 1536 / 1e6:.3f} MB over all "
        f"parts, at most {(m.Gx + m.Gc) * 1536 / 1e6:.3f} MB into one part")

    # the single-card staged operator on the same window_buckets=0 plan:
    # with its own geometry, and with the partition's (the same values in
    # the plan's order; chunked_geometry's chunks split the two element
    # orders at other places)
    (op_own, t_op1) = timed(lambda: tt.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=plan, fuse="", dtype=f32,
        device=dev))
    Jg, Wg = part.plan_geometry(plan.meta.n_clusters)
    r_geo = max(rel(Jg, op_own.Jinv), rel(Wg, op_own.W))
    op1 = tt.PackedPartialOperator(op_own.plan, Jg, Wg, op_own.dN,
                                   *op_own.lam_mu, fuse="")
    log(f"dist 15a geometry: the partition's against the single-card "
        f"operator's own, max rel difference {r_geo:.3e} (bitwise "
        f"{torch.equal(Jg, op_own.Jinv) and torch.equal(Wg, op_own.W)})")
    rng = np.random.default_rng(args.seed)
    u = rng.standard_normal((N, 3)).astype(np.float32)
    X1 = op1.plan.pack(torch.as_tensor(u, device=dev))
    single_ms = statistics.median(
        timed(lambda: op1(X1))[1] for _ in range(7)) * 1e3
    rate = M * 900 / (single_ms * 1e-3)
    log(f"dist 15a single-card staged apply (PackedPartialOperator fuse='', "
        f"same plan; built in {t_op1:.2f} s): {single_ms:.3f} ms host "
        f"clock (median of 7), {rate / 1e9:.2f} Gnnz/s")
    row = dist_cost_model.cost_rows(plan, M, 10, (P,), rate=rate)[0]
    log(f"dist 15a cost model (scripts/dist_cost_model, this rate, "
        f"{dist_cost_model.LINK_BYTES_PER_S / 1e9:.0f} GB/s NVLink 4 "
        f"specification): {json.dumps(row)}")
    if (max(1, row["ghost_x_rows_max"]), max(1, row["ghost_yc_rows_max"])) \
            != (m.Gx, m.Gc):
        fail(f"dist 15a: the cost model's ghost rows "
             f"({row['ghost_x_rows_max']}, {row['ghost_yc_rows_max']}) are "
             f"not the partition's Gx, Gc ({m.Gx}, {m.Gc})")

    # K4, K3, K2 on part 0's remapped tables against their plain versions
    def rand(*shape):
        return torch.randn(shape, dtype=f32, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(7))

    Xe = rand(m.Nbp + m.Gx + 1, 384)
    Xe[-1] = 0.0
    a4 = (Xe, fem.win_nodes[0], fem.wslot[0], fem.jslot[0], fem.lconn[0])
    fe = rand(m.Bp, 3, m.lanes)
    Ye = rand(m.Bp + m.Gc + 1, 384)
    Ye[-1] = 0.0
    a2 = (Ye, fem.winc[0], fem.slotidx[0], fem.wk[0])
    same = {
        "expand": torch.equal(pk.expand(*a4, wk=m.win_n),
                              pk.expand_plain(*a4, wk=m.win_n)),
        "compress_gather": torch.equal(
            pk.compress_gather(fe, fem.cinc[0], m.v_widths),
            pk.compress_gather_plain(fe, fem.cinc[0], m.v_widths)),
        "combine": torch.equal(pk.combine(*a2), pk.combine_plain(*a2))}
    log(f"dist 15a kernels on part 0's remapped tables, bitwise their "
        f"plain versions: {same}")
    if not all(same.values()):
        fail(f"dist 15a: a kernel differs from its plain version on the "
             f"remapped tables: {same}")
    del Xe, fe, Ye, a4, a2

    # the part-mesh apply against the single-card staged apply
    zero()
    Xd = torch.as_tensor(part.pack_np(u), device=dev)
    F = torch.as_tensor(part.unpack_np(fem.spmv(Xd)))
    dist_ms = statistics.median(
        timed(lambda: fem.spmv(Xd))[1] for _ in range(7)) * 1e3
    read("15a applies")
    F1 = op1.plan.unpack(op1(X1)).cpu()
    r_apply = rel(F, F1)
    r_own = rel(F, op_own.plan.unpack(op_own(X1)).cpu())
    log(f"dist 15a apply: PartMesh({P}) against the single-card staged "
        f"apply on the same geometry: bitwise {torch.equal(F, F1)}, max "
        f"rel difference {r_apply:.3e} (gate 1e-6); against the operator's "
        f"own geometry {r_own:.3e}; {dist_ms:.3f} ms host clock an apply "
        f"(median of 7), single card {single_ms:.3f}")
    if not r_apply <= 1e-6:
        fail(f"dist 15a: the part-mesh apply differs from the single-card "
             f"one by {r_apply:.3e}")
    del F, F1, X1, Xd, op_own, Jg, Wg

    # the 200-iteration PCG windows (tol 1e-30), both as CUDA graphs
    bX = part.pack_np(b.astype(np.float32))
    zero()
    _, t_cap = timed(lambda: fem.warm(bX, tol=1e-30, max_iter=DIST_WINDOW))
    (uD, iD), t_d = timed(lambda: fem.pcg(bX, tol=1e-30,
                                          max_iter=DIST_WINDOW))
    read("15a PCG window")
    sys1 = tt.PackedSystem(op1, fixed_nodes=fixed, precondition="block")
    _, t_cap1 = timed(lambda: sys1.warm(tol=1e-30, max_iter=DIST_WINDOW))
    (u1, i1), t_1 = timed(lambda: sys1.solve(b, tol=1e-30,
                                             max_iter=DIST_WINDOW))
    hD = iD.history[:DIST_WINDOW + 1].cpu()
    h1 = i1.history[:DIST_WINDOW + 1].cpu()
    rh = (hD - h1).abs() / h1.abs()
    r20, r200 = float(rh[:21].max()), float(rh.max())
    log(f"dist 15a PCG window ({DIST_WINDOW} iterations, tol 1e-30, CUDA "
        f"graphs): PartMesh({P}) {t_d / DIST_WINDOW * 1e3:.3f} ms an "
        f"iteration (capture {t_cap:.2f} s), single-card staged "
        f"PackedSystem {t_1 / DIST_WINDOW * 1e3:.3f} ms (capture "
        f"{t_cap1:.2f} s); history max rel difference {r20:.3e} over the "
        f"first 20 (gate 1e-5), {r200:.3e} over the {DIST_WINDOW}; "
        f"||r|| {float(hD[0]):.4e} -> {float(hD[-1]):.4e} (single card "
        f"{float(h1[-1]):.4e})")
    if int(iD.iterations) != DIST_WINDOW or not r20 <= 1e-5:
        fail(f"dist 15a: the PCG window differs from the single card's "
             f"({int(iD.iterations)} iterations, {r20:.3e})")
    del fem, part, op1, sys1, plan, uD, u1, bX
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15b: the packed halo system converged, f64, at --n ------------------
    n2 = args.n
    coords, conn, fixed, b, t_mesh = box(n2)
    N, M = coords.shape[0], conn.shape[0]
    tol = 1e-6 * float(np.linalg.norm(b))
    plan, t_plan = timed(lambda: tt.PackedPlan.build(
        coords, conn, N, window_buckets=0, device="cpu"))
    tm = {"mesh": t_mesh, "plan": t_plan}
    zero()
    fem, part = build_packed_halo_fem(
        coords, conn, "c3d10", E, NU, mesh=pdist.PartMesh(4, device=dev),
        fixed_nodes=fixed, dtype=f64, precondition="jacobi", plan=plan,
        timings=tm)
    bX = part.pack_np(b)
    (uX, iB), t_b = timed(lambda: fem.pcg(bX, tol=tol, max_iter=20000))
    read("15b solve")
    uB = torch.as_tensor(part.unpack_np(uX))
    itB = int(iB.iterations)
    hist_b = iB.history[:101].cpu()
    del fem, uX
    gc.collect()
    torch.cuda.empty_cache()
    op64 = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                          n_nodes=N, dtype=f64, device=dev)
    sys64 = tt.PackedSystem(op64, fixed_nodes=fixed, precondition="jacobi")
    (u1, i1), t_1 = timed(lambda: sys64.solve(b, tol=tol, max_iter=20000))
    it1 = int(i1.iterations)
    u1 = u1.cpu()
    del sys64, op64
    gc.collect()
    torch.cuda.empty_cache()
    ref64 = tt.F64Operator(coords, conn, "c3d10", E, NU, geometry_dtype=f64,
                           device=dev)
    m3 = torch.ones((N, 3), dtype=f64, device=dev)
    m3[torch.as_tensor(fixed, device=dev).long()] = 0.0
    b_t = torch.as_tensor(b, device=dev) * m3
    r = (b_t - ref64(uB.to(dev).reshape(-1)).reshape(N, 3)) * m3
    true_rel = float(torch.linalg.norm(r) / torch.linalg.norm(b_t))
    del ref64, r
    r_u = rel(uB, u1)
    log(f"dist 15b: box_tet10({n2}) {M} c3d10, f64, PartMesh(4), scalar "
        f"Jacobi, tol 1e-6 ||b||; setup {stages(tm)}; status "
        f"{int(iB.status)}, {itB} iterations in {t_b:.2f} s "
        f"({t_b / max(itB, 1) * 1e3:.3f} ms each); single-card f64 "
        f"PackedSystem {int(i1.status)}, {it1} iterations in {t_1:.2f} s; "
        f"displacement {r_u:.3e} from it (gate 1e-8); F64Operator true rel "
        f"residual {true_rel:.3e} (gate 1e-6)")
    if not (int(iB.status) == int(i1.status) == CONVERGED
            and abs(itB - it1) <= 0.01 * it1 and r_u <= 1e-8
            and true_rel <= 1e-6):
        fail("dist 15b: the part-mesh solve misses a gate")

    gc.collect()
    torch.cuda.empty_cache()

    # -- 15c: DistFEM and HaloFEM, f64, 4 parts, K by K6 ---------------------
    labels, _ = partition_elements(conn, "c3d10", 4, args.seed)
    sols, hist_d = {}, None
    for name, build in (("DistFEM", pdist.build_distributed_fem),
                        ("HaloFEM", build_halo_fem)):
        zero()
        (fem, part), t_s = timed(lambda: build(
            coords, conn, "c3d10", E, NU, mesh=pdist.PartMesh(4, device=dev),
            fixed_nodes=fixed, labels=labels, dtype=f64))
        bn = part.to_new(torch.as_tensor(b, device=dev))
        (u_n, info), t_c = timed(lambda: fem.pcg(bn, tol=tol,
                                                 max_iter=20000))
        read(f"15c {name}")
        it = int(info.iterations)
        pm = part.meta
        if name == "DistFEM":
            moved = f"2 x {pm.n_parts * pm.block_rows} rows (all-gather)"
            hist_d = info.history[:101].cpu()
        else:
            valid = 2 * int(part.recv_mask.sum())
            moved = (f"2 x {len(pm.rounds)} rounds x {pm.halo_width} x "
                     f"{pm.n_parts} = {2 * len(pm.rounds) * pm.halo_width * pm.n_parts} "
                     f"rows padded, {valid} real (halo)")
        sols[name] = part.to_old(u_n).cpu()
        log(f"dist 15c {name}: build {t_s:.2f} s (K6 f64, the partition), "
            f"status {int(info.status)}, {it} iterations in {t_c:.2f} s "
            f"({t_c / max(it, 1) * 1e3:.3f} ms each); exchanged an apply: "
            f"{moved}; displacement {rel(sols[name], uB):.3e} from 15b's")
        if int(info.status) != CONVERGED or abs(it - itB) > 0.01 * itB:
            fail(f"dist 15c {name}: status {int(info.status)}, {it} "
                 f"iterations (15b: {itB})")
        del fem, part, u_n, bn
        gc.collect()
    torch.cuda.empty_cache()
    r_dh = rel(sols["HaloFEM"], sols["DistFEM"])
    log(f"dist 15c: HaloFEM's displacement {r_dh:.3e} from DistFEM's "
        f"(gate 1e-8)")
    if not r_dh <= 1e-8:
        fail(f"dist 15c: HaloFEM and DistFEM differ by {r_dh:.3e}")

    # -- 15d: HaloPartialFEM, f64, part_shape (2, 2) -------------------------
    from tpufem_torch.parallel.partition import hierarchical_partition
    hlabels, t_hp = timed(lambda: hierarchical_partition(
        conn, "c3d10", (2, 2), args.seed)[0])
    zero()
    (fem, part), t_s = timed(lambda: build_halo_partial_fem(
        coords, conn, "c3d10", E, NU,
        mesh=pdist.make_mesh_2d((2, 2), device=dev), part_shape=(2, 2),
        labels=hlabels, fixed_nodes=fixed, dtype=f64))
    pm = part.meta
    kinds, perm_ok = [], True
    for prs in pm.rounds:
        srcs, dsts = [s for s, _ in prs], [d for _, d in prs]
        perm_ok &= (len(set(srcs)) == len(srcs)
                    and len(set(dsts)) == len(dsts))
        kind = {s // 2 != d // 2 for s, d in prs}
        perm_ok &= len(kind) == 1
        kinds.append(kind.pop())
    dcn_first = kinds == sorted(kinds, reverse=True)
    geo_bytes = (pm.n_qj * 9 + pm.n_q) * 8
    alloc = torch.cuda.memory_allocated(dev) / 1e9
    reserved = torch.cuda.memory_reserved(dev) / 1e9
    log(f"dist 15d: device memory before the window {alloc:.2f} GB "
        f"allocated, {reserved:.2f} GB reserved")
    bn = part.to_new(torch.as_tensor(b, device=dev))
    (u_n, info), t_c = timed(lambda: fem.pcg(bn, tol=tol, max_iter=100))
    read("15d window")
    h = info.history[:101].cpu()

    def hdiff(ref, upto):
        return float(((h[:upto] - ref[:upto]).abs() / ref[:upto].abs())
                     .max())

    # DistFEM's operator is K6's element stiffness, 1.8e-14 from the
    # partial-assembly action over the first 20 iterations; CG grows that
    # ~1.28x an iteration after ~50 (2.5e-8 at 100 on the H100, PERF.md
    # §6): the 100 entries are held against 15b's partial-assembly system
    r_pk, r_d20, r_d100 = hdiff(hist_b, 101), hdiff(hist_d, 21), \
        hdiff(hist_d, 101)
    log(f"dist 15d HaloPartialFEM: hierarchical_partition {t_hp:.2f} s "
        f"(host), build {t_s:.2f} s; rounds {pm.rounds} (partial "
        f"permutations: {perm_ok}, cross-host first: {dcn_first}; "
        f"{pm.dcn_pairs} cross-host pairs, {pm.dcn_halo_rows} rows); "
        f"geometry {geo_bytes} B an element (gate 160); 100 iterations in "
        f"{t_c:.2f} s ({t_c * 10:.3f} ms each, the capture included); "
        f"history max rel difference {r_pk:.3e} from 15b's PackedHaloFEM "
        f"over 100 (gate 1e-8), from DistFEM's {r_d20:.3e} over the first "
        f"20 (gate 1e-12) and {r_d100:.3e} over 100")
    if not (perm_ok and dcn_first and geo_bytes <= 160 and r_pk <= 1e-8
            and r_d20 <= 1e-12 and int(info.iterations) == 100):
        fail("dist 15d: HaloPartialFEM misses a gate")
    del fem, part, u_n
    gc.collect()
    torch.cuda.empty_cache()

    # -- 15b, last: one NCCL rank, a GroupMesh window bitwise PartMesh(1)'s
    # (after every capture of the phase, PartMesh(1)'s window first).
    def window(mesh):
        fem, part = build_packed_halo_fem(
            coords, conn, "c3d10", E, NU, mesh=mesh, fixed_nodes=fixed,
            dtype=f64, precondition="jacobi", plan=plan)
        (uw, iw), t_w = timed(lambda: fem.pcg(part.pack_np(b), tol=0.0,
                                              max_iter=64))
        log(f"dist 15b window: {type(mesh).__name__} on one part, 64 "
            f"iterations in {t_w:.2f} s")
        return uw.cpu(), iw.history.cpu(), int(iw.iterations)

    zero()
    up, hp, ip = window(pdist.PartMesh(1, device=dev))
    tmp = tempfile.mkdtemp()
    try:
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        ug, hg, ig = window(pdist.GroupMesh(device=dev))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    read("15b windows")
    same = torch.equal(ug, up) and torch.equal(hg, hp) and ig == ip == 64
    log(f"dist 15b: the GroupMesh window (NCCL, one rank) bitwise "
        f"PartMesh(1)'s: {same}")
    if not same:
        fail("dist 15b: the NCCL GroupMesh window differs from "
             "PartMesh(1)'s")
    del plan
    gc.collect()
    torch.cuda.empty_cache()

    for name, (nl, nr) in totals.items():
        if nl <= 0:
            fail(f"dist: kernel {name} was not launched")
        if name != tt.STIFFNESS_FUSED.name and nr <= 0:
            fail(f"dist: kernel {name} was not launched by graph replays")
    return ({k: v[0] for k, v in totals.items()},
            {k: v[1] for k, v in totals.items()})


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=55,
                    help="box_tet10(n, n, n): 6 n^3 c3d10 elements")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--phases",
                    default="packed,static,staged,probes,scale,family,"
                    "hybrid,workload,dist",
                    help="comma-separated subset of packed, static, staged, "
                    "probes, scale, family, hybrid, workload, dist, turns")
    ap.add_argument("--scale-n", type=int, default=119,
                    help="phase 11's mesh: box_tet10(n, n, n)")
    ap.add_argument("--mixed-n", type=int, default=64,
                    help="phase 12's BASELINE config 3 at box n, n, n")
    ap.add_argument("--plate-n", type=int, default=128,
                    help="phase 12's s4 and s3 plates: grid n x n")
    ap.add_argument("--hybrid-n", type=int, default=CONFIG4["n"],
                    help="phase 13a's mesh: box_tet(n, n, n) c3d4")
    ap.add_argument("--hybrid-parts", type=int, default=CONFIG4["parts"],
                    help="phase 13a's RCB part count")
    ap.add_argument("--bsr-n", type=int, default=20,
                    help="phase 13c's BSR check: box_tet10(n, n, n)")
    ap.add_argument("--workload-n", type=int, default=WORKLOAD_N,
                    help="phase 14's bundle: box_tet10(n, n, 2 n)")
    ap.add_argument("--dist-n", type=int, default=DIST_N,
                    help="phase 15a's mesh: box_tet10(n, n, n)")
    ap.add_argument("--dist-parts", type=int, default=DIST_PARTS,
                    help="phase 15a's part count")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= {"packed", "static", "staged", "probes", "scale",
                      "family", "hybrid", "workload", "dist", "turns"}:
        ap.error(f"unknown phases {phases}")

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
    kernels = tt.KERNELS
    if phases == {"turns"}:
        kernels = (tt.STIFFNESS_FUSED, tt.COMPRESS_GATHER, tt.COMPRESS_PLANAR)
    built = cuda.build(kernels)
    log(f"build: {time.perf_counter() - t0:.2f} s for {built or 'none'} "
        f"(nvcc {' '.join(cuda.NVCC_FLAGS)})")
    log(f"tpufem_torch from {os.path.dirname(os.path.dirname(tt.__file__))}")
    for K in kernels:
        log(f"  ptxas {K.name}:{ptxas_digest(K)}")
    # the redesigned kernels' f32 instantiations, and every one of
    # fused_yc's, do not spill
    for K in set(kernels) & {tt.FUSED_YC, tt.COMBINE, tt.CLUSTER_EXPAND,
                             tt.CLUSTER_COMPRESS, tt.STIFFNESS_FUSED,
                             tt.COMPRESS_PLANAR}:
        for e in ptxas_entries(K) or []:
            if (("<float" in e["name"] or K is tt.FUSED_YC)
                    and e["spill_stores"] > 0):
                fail(f"{e['name']} spills {e['spill_stores']} bytes")

    rows, tip, ctx = [], None, None
    if "packed" in phases:
        t0 = time.perf_counter()
        rows, tip, ctx = packed_phase(args, dev)
        torch.cuda.empty_cache()
        log(f"phase packed: {time.perf_counter() - t0:.1f} s")
    if "static" in phases:
        t0 = time.perf_counter()
        rows += static_phase(args, dev, tip)
        torch.cuda.empty_cache()
        log(f"phase static: {time.perf_counter() - t0:.1f} s")
    if "staged" in phases:
        t0 = time.perf_counter()
        staged_rows, staged_launches, k1_other = staged_phase(args, dev, ctx,
                                                              tip)
        for r in rows:
            if r["name"] in staged_launches:
                r["staged_launches"] = staged_launches[r["name"]]
            if r["name"] == "fused_yc":
                r["other_solids"] = k1_other
        rows += staged_rows
        torch.cuda.empty_cache()
        log(f"phase staged: {time.perf_counter() - t0:.1f} s")
    if "probes" in phases:
        t0 = time.perf_counter()
        rows += probes_phase(args, dev)
        log(f"phase probes: {time.perf_counter() - t0:.1f} s")
    if "turns" in phases:
        t0 = time.perf_counter()
        rows += turns_phase(args, dev)
        log(f"phase turns: {time.perf_counter() - t0:.1f} s")
    if "scale" in phases:
        del ctx
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        scale_launches = scale_phase(args, dev)
        for r in rows:
            if r["name"] in scale_launches:
                r["scale_launches"] = scale_launches[r["name"]]
        log(f"phase scale: {time.perf_counter() - t0:.1f} s")
    if "family" in phases:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fam, fam_replayed = family_phase(args, dev)
        for r in rows:
            if r["name"] in fam:
                r["family_launches"] = fam[r["name"]]
                r["family_replayed"] = fam_replayed[r["name"]]
        log(f"phase family: {time.perf_counter() - t0:.1f} s")
    if "hybrid" in phases:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        hyb, hyb_replayed = hybrid_phase(args, dev)
        for r in rows:
            if r["name"] in hyb:
                r["hybrid_launches"] = hyb[r["name"]]
                r["hybrid_replayed"] = hyb_replayed[r["name"]]
        log(f"phase hybrid: {time.perf_counter() - t0:.1f} s")
    if "workload" in phases:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        wl, wl_b = workload_phase(args, dev)
        for r in rows:
            if r["name"] in wl:
                r["workload_launches"] = wl[r["name"]]
            if r["name"] in wl_b:
                r["workload_run_b_launches"] = wl_b[r["name"]]
        log(f"phase workload: {time.perf_counter() - t0:.1f} s")
    if "dist" in phases:
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dl, dr = dist_phase(args, dev)
        for r in rows:
            if r["name"] in dl:
                r["dist_launches"] = dl[r["name"]]
                r["dist_replayed"] = dr[r["name"]]
        log(f"phase dist: {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
