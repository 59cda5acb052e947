"""The program's spans and counters (tpufem_torch.utils.profiling): off by
default, nested under a recording, in torch's profiler trace on its clock,
and where the solve paths put them."""
import numpy as np
import pytest
import torch

import tpufem_torch as tt
from tpufem_torch.ops import cuda
from tpufem_torch.solvers import hybrid as th
from tpufem_torch.solvers.bicgstab import BiCGStabBlock
from tpufem_torch.solvers.cg import CHECK_EVERY, CGBlock
from tpufem_torch.solvers.gmres import GMRESCycle
from tpufem_torch.utils import meshgen, profiling


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(rec):
    return [s[0] for s in rec.spans]


def test_off_by_default_shares_one_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("x.a"), profiling.span("x.b")
    assert a is b
    with a:
        pass
    assert not profiling._STACK
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}


def test_spans_nest_with_parent_ids():
    with profiling.span("x.before"):
        with profiling.recording() as rec:
            with profiling.span("x.outer"):
                with profiling.span("x.one"):
                    with profiling.span("x.inner"):
                        pass
                with profiling.span("x.two"):
                    pass
            profiling.count("x.counted", 3)
            with pytest.raises(RuntimeError):
                with profiling.recording():
                    pass
    by = {s[0]: s for s in rec.spans}
    assert set(by) == {"tpufem_torch.x.outer", "tpufem_torch.x.one",
                       "tpufem_torch.x.inner", "tpufem_torch.x.two"}
    outer, one, inner, two = (by["tpufem_torch.x." + n]
                              for n in ("outer", "one", "inner", "two"))
    # x.before began while tracing was off: no span, no parent
    assert outer[2] is None
    assert one[2] == outer[1] and two[2] == outer[1]
    assert inner[2] == one[1]
    assert one[4] <= two[3] and two[4] <= outer[4]
    assert all(s[3] <= s[4] for s in rec.spans)
    assert rec.counts == {"x.counted": 3}
    assert not profiling._STACK


def test_counters_read_every_kernel_from_the_registry():
    k = cuda.REGISTRY[0]
    before = profiling.counters()
    assert {f"launches.{r.name}" for r in cuda.REGISTRY} <= set(before)
    k.launches += 2
    try:
        assert profiling.counters()[f"launches.{k.name}"] == \
            before[f"launches.{k.name}"] + 2
    finally:
        k.launches -= 2


def test_fused_yc_warps_per_sm(monkeypatch):
    """fused_yc.warps_per_sm: the least over the plan's launched cluster
    buckets of the blocks an SM, times the warps a block; recorded at a
    fused operator's build on the card only (the CPU runs no kernel)."""
    from tpufem_torch.ops import fused_kernels as fk
    coords, conn = meshgen.box_tet10(4, 4, 4)
    with profiling.recording() as rec:
        op = tt.PackedPartialOperator.build(coords, conn, "c3d10", 200e9,
                                            0.3, n_nodes=coords.shape[0],
                                            device="cpu")
    assert op.fuse == "dense"
    assert "fused_yc.warps_per_sm" not in rec.counts
    seen = []

    def occupancy(dtype, k, q, Wp, Rp, n_chunks, E_c):
        seen.append((dtype, k, q, Wp, Rp, n_chunks, E_c))
        return 9 - len(seen)             # the last bucket holds the fewest

    monkeypatch.setattr(fk, "occupancy", occupancy)
    p, m = op.plan, op.plan.meta
    launched = [g for g, (_, n, wk) in enumerate(m.c_groups) if wk and n]
    assert launched
    assert fk.warps_per_sm(torch.float64, 10, 4, p) == \
        fk.WARPS_PER_BLOCK * (9 - len(launched))
    assert seen == [(torch.float64, 10, 4, p.cinc[g].shape[1], m.lanes,
                     len(m.cv_widths[g]), m.elems_per_cluster)
                    for g in launched]


def test_spans_in_the_profilers_trace_on_its_clock():
    from torch.profiler import ProfilerActivity, profile
    # inside an outer annotation, as a profiled run holds the program's
    # spans: the first annotation of a process pays torch's one-time set-up
    # (1.2-7.3 ms), before or after its own time stamp by torch version
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.profiler.record_function("outer"):
        with profiling.recording() as rec:
            for i in range(3):
                with profiling.span(f"x.p{i}"):
                    torch.ones(8).sum()
    kin = {e.name(): e for e in prof.profiler.kineto_results.events()
           if e.name().startswith(profiling.PREFIX)}
    assert set(kin) == set(_names(rec)) and len(kin) == 3
    for name, _, _, t0, t1 in rec.spans:
        e = kin[name]
        assert e.is_user_annotation()
        assert abs(e.start_ns() - t0) < 1_000_000, (name, e.start_ns() - t0)
        assert abs(e.end_ns() - t1) < 1_000_000


def _laplacian(n=100):
    A = (2 * torch.eye(n, dtype=torch.float64)
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), 1)
         - torch.diag(torch.ones(n - 1, dtype=torch.float64), -1))
    return A, torch.linspace(1.0, 2.0, n, dtype=torch.float64)


# each solver's block and the iterations a block (or cycle) runs
BLOCKS = {
    "cg": (lambda A, b: CGBlock(A, b, tol=1e-8), CHECK_EVERY),
    "bicgstab": (lambda A, b: BiCGStabBlock(A, b, tol=1e-8), CHECK_EVERY),
    "gmres": (lambda A, b: GMRESCycle(A, b, tol=1e-8, restart=50), 50),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_cg_block_spans_and_host_reads(kind):
    """One status read a block or cycle (span <kind>.sync, counted in
    host_syncs) and one after the last; a launch span a block."""
    A, b = _laplacian()
    make, per = BLOCKS[kind]
    blk = make(lambda x: A @ x, b)
    with profiling.recording() as rec:
        _, info = blk.solve(b, max_iter=1000)
    it = int(info.iterations)
    assert int(info.status) == 1 and per < it < 1000
    assert it % per                          # converged inside a block
    blocks = -(-it // per)
    names = _names(rec)
    assert names.count(f"tpufem_torch.{kind}.launch") == blocks
    assert names.count(f"tpufem_torch.{kind}.sync") == blocks + 1
    counts = {"host_syncs": blocks + 1}
    if kind == "cg":
        counts["cg.blocks"] = blocks
    assert rec.counts == counts
    if kind != "cg":
        return
    by = {s[1]: s for s in rec.spans}
    solve = [s for s in rec.spans if s[0] == "tpufem_torch.cg.solve"]
    assert len(solve) == 1
    assert all(by[s[2]][0] == "tpufem_torch.cg.solve" for s in rec.spans
               if s is not solve[0])


@pytest.fixture(scope="module")
def packed_f64():
    """An f64 PackedSystem at box_tet10(2, 2, 2) and a unit-norm load."""
    coords, conn = meshgen.box_tet10(2, 2, 2)
    N = coords.shape[0]
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1.0
    op = tt.PackedPartialOperator.build(
        coords, conn, "c3d10", 200e9, 0.3, n_nodes=N, dtype=torch.float64,
        device="cpu")
    system = tt.PackedSystem(op, fixed_nodes=meshgen.boundary_nodes(
        coords, 2, 0.0), precondition="jacobi")
    return system, b / np.linalg.norm(b)


def _hybrid():
    coords, conn = meshgen.box_tet(3, 3, 3)
    b = np.zeros((coords.shape[0], 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1.0
    sys_ = th.build_hybrid(coords, conn, "c3d4", 200.0, 0.3, 2,
                           fixed_nodes=meshgen.boundary_nodes(coords, 2, 0.0),
                           device="cpu")
    return lambda: sys_.solve_chunked(b, tol=1e-8, max_iter=300, every=7)


@pytest.mark.parametrize("entry, per_chunk", [
    ("solve_chunked_packed", 2), ("solve_chunked", 3), ("hybrid", 3)])
def test_chunked_host_reads(packed_f64, entry, per_chunk):
    """Each chunk's host reads besides its blocks' (the cg.sync spans): the
    count and the status, and the history in PackedSystem's and
    HybridSystem's solve_chunked."""
    system, b = packed_f64
    run = {
        "solve_chunked_packed": lambda: system.solve_chunked_packed(
            system.op.plan.pack(torch.as_tensor(b)), tol=1e-8, every=7,
            max_iter=300),
        "solve_chunked": lambda: system.solve_chunked(
            b, tol=1e-8, every=7, max_iter=300),
        "hybrid": _hybrid() if entry == "hybrid" else None,
    }[entry]
    with profiling.recording() as rec:
        _, info = run()
    names = _names(rec)
    chunks = names.count("tpufem_torch.cg.solve")
    assert int(info.status) == 1
    assert chunks == -(-int(info.iterations) // 7) > 1
    assert rec.counts["host_syncs"] == (
        names.count("tpufem_torch.cg.sync") + per_chunk * chunks)


def test_refined_solve_spans():
    coords, conn = meshgen.box_tet10(3, 3, 3)
    N = coords.shape[0]
    b = np.zeros((N, 3), np.float32)
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    with profiling.recording() as rec:
        op = tt.PackedPartialOperator.build(
            coords, conn, "c3d10", 200e9, 0.3, n_nodes=N,
            dtype=torch.float32, device="cpu")
        system = tt.PackedSystem(op, fixed_nodes=meshgen.boundary_nodes(
            coords, 2, 0.0), precondition="jacobi")
        ref = tt.RefinedSystem(system, coords, conn, "c3d10", 200e9, 0.3)
        _, info = ref.solve(b, inner_tol=1e-3, inner_max_iter=8, every=8,
                            max_cycles=1)
    by = {s[1]: s for s in rec.spans}
    names = _names(rec)
    plan = [s for s in rec.spans if s[0] == "tpufem_torch.plan.build"]
    assert len(plan) == 1
    stages = [s[0] for s in rec.spans if s[2] == plan[0][1]]
    assert stages == ["tpufem_torch.plan." + n for n in (
        "order", "clusters", "numbering", "slots", "windows", "buckets",
        "tables", "to_device")]
    (solve,) = [s for s in rec.spans if s[0] == "tpufem_torch.refine.solve"]
    inner = [s for s in rec.spans if s[0] == "tpufem_torch.refine.inner"]
    assert info.cycles == 1 and len(inner) == 1
    assert inner[0][2] == solve[1]
    assert names.count("tpufem_torch.refine.residual") == 2
    assert by[[s for s in rec.spans if s[0] == "tpufem_torch.cg.solve"
               ][0][2]][0] == "tpufem_torch.refine.inner"
    # the norm of b, two residuals, one chunk's count and status, and the
    # chunk's block reads (8 iterations: one block, whose end is not read)
    assert rec.counts["host_syncs"] == 1 + 2 + 2 + 1
    assert rec.counts["cg.blocks"] == 1
