"""The block-structured PCG and the f64 refinement operator on the CPU.

cg runs its loop in blocks of CHECK_EVERY iterations (solvers.cg.CGBlock:
a CUDA graph per block length on the card, the same function eagerly
here).  On box_tet10(3) (the fixtures of test_torch_solve.py: f32 packed
operator, Jacobi, fixed base) and on a small dense SPD system in f64 with
constraints, it is bitwise equal to the per-iteration loop it replaced
(history, iterate, status, count and resume state), also when the solve
stops inside a block.  F64Operator's geometry and incidence, computed with
torch (the card's code, run here on CPU f64 tensors), equal the host numpy
version; its apply summed over node ranges equals the single gather; its
cache_path round trip is bitwise and a bad file is rebuilt.  The
solve_scale flow converges on box_tet10(2).
"""
import os

import numpy as np
import pytest
import torch

from tpufem_torch.elements.tables import element_table
from tpufem_torch.scripts import solve_scale
from tpufem_torch.solvers import cg as t_cg
from tpufem_torch.solvers import refine as t_refine
from tpufem_torch.utils import meshgen

from test_torch_solve import E, NU, port_system, problem  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop_cg(A, b, *, constraints=None, M_inv=None, x0=None, tol=1e-10,
             max_iter=1000, eps=1e-30, record_history=True, dot_dtype=None,
             resume_state=None, return_state=False):
    """The per-iteration loop that CGBlock replaced (the host reads the
    status every CHECK_EVERY iterations; the history is written by a
    Python index)."""
    dtype = b.dtype
    dev = b.device
    project = constraints.project_residual if constraints else (lambda x: x)
    set_state = constraints.apply_state if constraints else (lambda x: x)
    ddt = dot_dtype or dtype

    def vdot(a, c):
        return torch.sum(a.to(ddt) * c.to(ddt)).to(dtype)

    if M_inv is None:
        apply_M = (lambda x: x)
    elif callable(M_inv):
        apply_M = M_inv
    else:
        apply_M = lambda r: r * M_inv  # noqa: E731

    u = set_state(torch.zeros_like(b) if x0 is None else x0.to(dtype))
    r = project(b - A(u))
    z = apply_M(r)
    rz = vdot(r, z)
    if resume_state is None:
        p = z
    else:
        p_prev, rz_prev = resume_state
        rz_prev = torch.as_tensor(rz_prev, dtype=dtype, device=dev)
        p = torch.where(rz_prev > 0, project(p_prev.to(dtype)), z)
    hist = torch.full((max_iter + 1 if record_history else 1,), float("inf"),
                      dtype=dtype, device=dev)
    r0norm = torch.sqrt(vdot(r, r))
    if record_history:
        hist[0] = r0norm
    status = torch.where(r0norm < tol, t_cg.CONVERGED,
                         t_cg.RUNNING).to(torch.int32)
    i = torch.zeros((), dtype=torch.int32, device=dev)
    for it in range(max_iter):
        if it % t_cg.CHECK_EVERY == 0 and int(status) != t_cg.RUNNING:
            break
        running = status == t_cg.RUNNING
        Ap = A(p)
        pAp = vdot(p, Ap)
        bad_curv = (torch.abs(pAp) < eps) | (pAp < 0.0)
        alpha = rz / (pAp + eps)
        bad_alpha = torch.isnan(alpha) | torch.isinf(alpha)
        u1 = set_state(u + alpha * p)
        r1 = project(r - alpha * Ap)
        z1 = apply_M(r1)
        rz1 = vdot(r1, z1)
        rnorm = torch.sqrt(vdot(r1, r1))
        beta = rz1 / (rz + eps)
        bad_beta = torch.isnan(beta) | torch.isinf(beta)
        p1 = project(z1 + beta * p)
        new_status = torch.where(
            bad_curv, t_cg.NOT_SPD,
            torch.where(bad_alpha | bad_beta, t_cg.NAN_INF,
                        torch.where(rnorm < tol, t_cg.CONVERGED,
                                    t_cg.RUNNING))).to(torch.int32)
        take = (new_status != t_cg.NOT_SPD) & ~bad_alpha
        keep = running & take
        u = torch.where(keep, u1, u)
        r = torch.where(keep, r1, r)
        p = torch.where(keep, p1, p)
        rz = torch.where(keep, rz1, rz)
        if record_history:
            hist[it + 1] = torch.where(
                running, torch.where(take, rnorm, hist[it]), hist[it + 1])
        status = torch.where(running, new_status, status)
        i = i + running.to(torch.int32)
    status = torch.where(status == t_cg.RUNNING, t_cg.MAX_ITER,
                         status).to(torch.int32)
    rnorm = torch.sqrt(vdot(r, r))
    info = t_cg.SolveInfo(status, i, rnorm, hist)
    if return_state:
        return u, info, (p, rz)
    return u, info


def _assert_same(a, b):
    """Two cg results (u, info[, (p, rz)]) bitwise equal."""
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    if len(a) > 2:
        assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])


class _Cons:
    """Two pinned DOFs and one DOF tied to another, on a flat field."""

    def apply_state(self, u):
        u = u.clone()
        u[[0, 5]] = 0.0
        u[7] = u[3]
        return u

    def project_residual(self, r):
        r = r.clone()
        r[[0, 5, 7]] = 0.0
        return r


@pytest.mark.parametrize("case", ["max_iter", "stop_in_block", "resume"])
def test_packed_block_cg_bitwise_vs_loop(problem, port_system, case):
    """The packed Jacobi PCG through CGBlock against the loop: stopped by
    max_iter inside the second block (40 = 32 + 8), converged inside a
    block, and a chunk resumed from another's (p, rz)."""
    _, _, _, b = problem
    s = port_system
    bX = s.pc.project_residual(s.op.plan.pack(torch.as_tensor(b)))
    kw = dict(constraints=s.pc, M_inv=s.M_inv, return_state=True)
    if case == "max_iter":
        kw.update(tol=0.0, max_iter=40)
    elif case == "stop_in_block":
        kw.update(tol=3e-3, max_iter=200)
    else:
        _, _, (p, rz) = t_cg.cg(s.op, bX, tol=0.0, max_iter=20, **kw)
        kw.update(tol=0.0, max_iter=12, resume_state=(p, rz),
                  x0=torch.full_like(bX, 1e-9))
    want = _loop_cg(s.op, bX, **kw)
    got = t_cg.cg(s.op, bX, **kw)
    _assert_same(got, want)
    n = int(got[1].iterations)
    if case == "stop_in_block":
        assert int(got[1].status) == t_cg.CONVERGED
        assert n % t_cg.CHECK_EVERY != 0
    else:
        assert int(got[1].status) == t_cg.MAX_ITER
    assert torch.isinf(got[1].history[n + 1:]).all()
    # a CGBlock kept by the caller serves a second call the same way
    solve = {k: kw.pop(k) for k in ("x0", "max_iter", "resume_state",
                                    "return_state") if k in kw}
    blk = t_cg.CGBlock(s.op, bX, **kw)
    blk.solve(bX, **solve)
    _assert_same(blk.solve(bX, **solve), want)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("precond", ["array", "callable"])
@pytest.mark.parametrize("max_iter,tol", [(5, 1e-12), (32, 0.0), (45, 1e-9),
                                          (100, 1e-9)])
def test_dense_block_cg_bitwise_vs_loop(dt, precond, max_iter, tol):
    """A dense SPD system with constraints, the dot products in f64."""
    rng = np.random.default_rng(3)
    Q = rng.standard_normal((24, 24))
    A = torch.as_tensor(Q @ Q.T + 24 * np.eye(24), dtype=dt)
    b = torch.as_tensor(rng.standard_normal(24), dtype=dt)
    d = 1.0 / torch.diagonal(A)
    M = d if precond == "array" else (lambda r: r * d)
    kw = dict(constraints=_Cons(), M_inv=M, tol=tol, max_iter=max_iter,
              dot_dtype=torch.float64, return_state=True)
    _assert_same(t_cg.cg(lambda x: A @ x, b, **kw),
                 _loop_cg(lambda x: A @ x, b, **kw))


def test_warm_on_cpu_captures_nothing(problem, port_system):
    """On the CPU warm_chunked makes the block but no graph, and the blocks
    run eagerly."""
    s = port_system
    s.warm_chunked(problem[3], tol=1e-5, every=50)
    blk = s._blocks[(1e-5, "None")]
    assert not blk.graphed and not blk.graphs
    assert s.solve(problem[3], tol=1e-5, max_iter=40)[1].iterations > 0
    assert not blk.graphs


def _host_incidence(conn: np.ndarray, n_nodes: int) -> np.ndarray:
    """The incidence as the host built it: numpy's stable argsort."""
    flat = conn.reshape(-1).astype(np.int64)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_nodes)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(flat.size) - starts[flat[order]]
    inc = np.full((n_nodes, max(int(counts.max()), 1)), flat.size, np.int64)
    inc[flat[order], pos] = order
    return inc


@pytest.mark.parametrize("curved", [False, True])
def test_device_geometry_matches_host(curved):
    """device_geometry on CPU f64 tensors against _host_geometry: within
    1e-14 relative before rounding and 1 ulp after rounding to f32 (the
    same operations in the same order: equal here); the incidence equals
    the host's, as int32."""
    coords, conn = meshgen.box_tet10(3, 3, 4)
    if curved:
        coords = coords + 0.02 * np.sin(3.0 * coords[:, [1, 2, 0]])
    table = element_table("c3d10", "default")
    dN = np.asarray(table.dN, np.float64)
    w = np.asarray(table.weights, np.float64)
    Jh, Wh = t_refine._host_geometry(coords.astype(np.float64), conn, dN, w)
    Jd, Wd = t_refine.device_geometry(
        torch.as_tensor(coords, dtype=torch.float64),
        torch.as_tensor(conn).long(), torch.as_tensor(dN),
        torch.as_tensor(w))
    assert Jd.shape == Jh.shape and Jh.shape[1] == (4 if curved else 1)
    for d, h in ((Jd.numpy(), Jh), (Wd.numpy(), Wh)):
        assert np.abs(d - h).max() <= 1e-14 * np.abs(h).max()
        d32, h32 = d.astype(np.float32), h.astype(np.float32)
        ulp = np.abs(d32.view(np.int32).astype(np.int64)
                     - h32.view(np.int32).astype(np.int64)).max()
        assert ulp <= 1
    inc = t_refine.incidence(torch.as_tensor(conn), coords.shape[0])
    assert inc.dtype == torch.int32
    assert np.array_equal(inc.numpy(), _host_incidence(conn,
                                                       coords.shape[0]))


@pytest.fixture(scope="module")
def op64_parts():
    coords, conn = meshgen.box_tet10(3, 3, 3)
    coords = coords + 0.02 * np.sin(3.0 * coords[:, [1, 2, 0]])
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        3 * coords.shape[0]))
    return coords, conn, u


def test_f64_apply_node_ranges_bitwise(op64_parts):
    """The scatter summed over ranges of 37 nodes equals the single gather
    of the whole incidence."""
    coords, conn, u = op64_parts
    op = t_refine.F64Operator(coords, conn, "c3d10", E, NU, chunk_elems=50,
                              device="cpu")
    op.node_chunk = coords.shape[0]
    F = op(u)
    op.node_chunk = 37
    assert torch.equal(op(u), F)


def test_f64_operator_cache_round_trip(op64_parts, tmp_path):
    coords, conn, u = op64_parts
    path = str(tmp_path / "geom.npz")
    kw = dict(chunk_elems=50, device="cpu", cache_path=path)
    built = t_refine.F64Operator(coords, conn, "c3d10", E, NU, **kw)
    assert os.path.exists(path)
    stamp = os.path.getmtime(path)
    loaded = t_refine.F64Operator(coords, conn, "c3d10", E, NU, **kw)
    assert os.path.getmtime(path) == stamp            # read, not rewritten
    for (_, _, J0, W0), (_, _, J1, W1) in zip(built.chunks, loaded.chunks):
        assert J0.dtype == torch.float32
        assert torch.equal(J0, J1) and torch.equal(W0, W1)
    F = built(u)
    assert torch.equal(loaded(u), F)
    # a torn file, and a file of another chunk size, are rebuilt
    with open(path, "wb") as f:
        f.write(b"not an npz file")
    again = t_refine.F64Operator(coords, conn, "c3d10", E, NU, **kw)
    assert torch.equal(again(u), F)
    with np.load(path) as z:
        assert int(z["chunk_elems"]) == 50
    other = t_refine.F64Operator(coords, conn, "c3d10", E, NU,
                                 chunk_elems=70, device="cpu",
                                 cache_path=path)
    with np.load(path) as z:
        assert int(z["chunk_elems"]) == 70
    assert float((other(u) - F).abs().max()) <= 1e-12 * float(F.abs().max())


def test_solve_scale_flow_on_cpu(monkeypatch):
    """solve_scale's settings follow tpufem's defaults and environment
    variables, and its flow converges on box_tet10(2)."""
    for var in ("SOLVE_INNER_TOL", "SOLVE_EVERY", "SOLVE_INNER_MAX"):
        monkeypatch.delenv(var, raising=False)
    assert solve_scale.settings(95) == dict(inner_tol=5e-3, every=500,
                                            inner_max=1500)
    assert solve_scale.settings(119) == dict(inner_tol=5e-3, every=250,
                                             inner_max=2000)
    monkeypatch.setenv("SOLVE_EVERY", "40")
    out, system, u = solve_scale.run(2, "jacobi", 1e-6, cache=False,
                                     device="cpu", log=lambda msg: None)
    assert u.shape == (3 * system.op.plan.meta.n_nodes,)
    assert out["every"] == 40 and out["converged"]
    assert out["rel_residual"] <= 1e-6 and out["tip_uz_mean"] < 0
    assert set(out["setup_stages"]) == {"mesh", "plan", "operator_geometry",
                                        "system", "refinement_geometry",
                                        "warm"}
    assert out["elements"] == 48 and out["max_memory_allocated"] is None
