"""tpufem_torch's solvers against tpufem's on box_tet10(3) (f32 operator,
fixed base, load on the top face): PCG one-shot and chunked (every=50)
reach the same status in iteration counts within 3% of tpufem's, and the
refined solve reaches a 1e-10 f64 true residual that tpufem's own f64
operator confirms, agreeing with tpufem's refined displacement.

The PCG tolerance, 1e-5 on a unit-norm right-hand side, stays above the
f32 floor of this problem.  Near that floor (1e-6 here) a chunk that
restarts from the true residual while carrying the recurrence's search
direction takes an oversized step, and both packages' solve_chunked then
diverge to NAN_INF (tpufem at 695 iterations, the port at 689), while the
one-shot solve converges at 103."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import packed as j_packed
from tpufem.solvers import refine as j_refine
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.solvers import cg as t_cg

E, NU = 200e9, 0.3
TOL = 1e-5          # absolute PCG tolerance on a unit-norm right-hand side
EVERY = 50
SHORT = (30, 70)    # max_iter that EVERY does not divide


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    coords, conn = meshgen.box_tet10(3, 3, 3)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3), np.float32)
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    b /= np.linalg.norm(b)
    return coords, conn, fixed, b


@pytest.fixture(scope="module")
def tpufem_results(problem):
    """tpufem's chunked PCG and refined solve; both use one compiled
    chunk program (same tol and every)."""
    coords, conn, fixed, b = problem
    N = coords.shape[0]
    op = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords, jnp.float32), conn, "c3d10", E, NU, n_nodes=N,
        interpret=True, fuse="dense", dtype=jnp.float32)
    sys_ = j_packed.PackedSystem(op, fixed_nodes=fixed, precondition="jacobi")
    u, info = sys_.solve_chunked(b, tol=TOL, every=EVERY, max_iter=5000)
    short = {}
    for max_iter in SHORT:
        dones = []
        us, si = sys_.solve_chunked(b, tol=TOL, every=EVERY,
                                    max_iter=max_iter,
                                    progress=lambda d, r: dones.append(d))
        short[max_iter] = dict(
            status=int(si.status), iterations=int(si.iterations),
            n_hist=len(si.history), dones=dones, u=np.asarray(us))
    ref = j_refine.RefinedSystem(sys_, coords, conn, "c3d10", E, NU,
                                 geometry_dtype=jnp.float64)
    u_ref, rinfo = ref.solve(b, tol_rel=1e-10, inner_tol=TOL,
                             inner_max_iter=5000, every=EVERY)
    return dict(status=int(info.status), iterations=int(info.iterations),
                u=np.asarray(u), u_ref=np.asarray(u_ref), rinfo=rinfo,
                short=short,
                op64=ref.op64, mask=np.asarray(ref._mask))


@pytest.fixture(scope="module")
def port_system(problem):
    coords, conn, fixed, b = problem
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=coords.shape[0],
        dtype=torch.float32, device="cpu")
    return tpufem_torch.PackedSystem(op, fixed_nodes=fixed,
                                     precondition="jacobi")


def _iters_close(a, b):
    return abs(a - b) <= max(1, 0.03 * b)


def test_cg_matches_tpufem(problem, tpufem_results, port_system):
    _, _, _, b = problem
    u, info = port_system.solve(b, tol=TOL, max_iter=5000)
    assert int(info.status) == tpufem_results["status"] == t_cg.CONVERGED
    assert _iters_close(int(info.iterations), tpufem_results["iterations"])
    h = info.history.numpy()
    assert np.isfinite(h[:int(info.iterations) + 1]).all()
    assert np.isinf(h[int(info.iterations) + 1:]).all()
    uj = tpufem_results["u"]
    assert np.abs(u.numpy() - uj).max() <= 1e-4 * np.abs(uj).max()


def test_solve_chunked_matches_tpufem(problem, tpufem_results, port_system):
    _, _, _, b = problem
    seen = []
    u, info = port_system.solve_chunked(
        b, tol=TOL, every=EVERY, max_iter=5000,
        progress=lambda done, r: seen.append(done))
    assert int(info.status) == tpufem_results["status"] == t_cg.CONVERGED
    assert _iters_close(int(info.iterations), tpufem_results["iterations"])
    assert len(seen) > 1 and seen[-1] == int(info.iterations)
    assert info.history.shape == (int(info.iterations) + 1,)
    uj = tpufem_results["u"]
    assert np.abs(u.numpy() - uj).max() <= 1e-4 * np.abs(uj).max()


@pytest.mark.parametrize("max_iter", SHORT)
def test_solve_chunked_runs_whole_chunks(problem, tpufem_results,
                                         port_system, max_iter):
    """tpufem's packed chunk loop runs whole chunks of `every`, past max_iter
    when every does not divide it: max_iter 30 stops after one chunk of
    50 at MAX_ITER, max_iter 70 runs a second chunk to convergence at 92.
    The port runs the same chunks: the same status, count, chunk ends and
    history length.  The history's values part with the f32 operators
    (0.65% by the first chunk's end, 11% near convergence), so the answer
    is held as the module's other solves are."""
    _, _, _, b = problem
    dones = []
    u, info = port_system.solve_chunked(
        b, tol=TOL, every=EVERY, max_iter=max_iter,
        progress=lambda d, r: dones.append(d))
    ref = tpufem_results["short"][max_iter]
    assert int(info.status) == ref["status"]
    assert int(info.iterations) == ref["iterations"] > max_iter
    assert dones == ref["dones"]
    assert info.history.shape == (ref["n_hist"],) == (ref["iterations"] + 1,)
    assert np.isfinite(info.history).all()
    uj = ref["u"]
    assert np.abs(u.numpy() - uj).max() <= 1e-4 * np.abs(uj).max()


def test_cg_status_codes_and_frozen_state():
    """A non-SPD operator stops with NOT_SPD on the first step and keeps the
    previous iterate; the iterations the host runs before it reads the
    status again change nothing."""
    b = torch.ones(8, dtype=torch.float64)
    u, info = t_cg.cg(lambda x: -x, b, tol=1e-12, max_iter=40)
    assert int(info.status) == t_cg.NOT_SPD and int(info.iterations) == 1
    assert torch.equal(u, torch.zeros_like(b))
    # max_iter=8 ends before the host's first check after the start; with
    # max_iter=100 the solve converges within 8 iterations and the host
    # runs frozen iterations until its check at CHECK_EVERY
    assert t_cg.CHECK_EVERY > 8
    A = torch.diag(torch.arange(1.0, 9.0, dtype=torch.float64))
    calls = []

    def op(x):
        calls.append(1)
        return A @ x

    u, info = t_cg.cg(op, b, tol=1e-10, max_iter=100)
    assert len(calls) == 1 + t_cg.CHECK_EVERY      # frozen iterations ran
    u2, info2 = t_cg.cg(lambda x: A @ x, b, tol=1e-10, max_iter=8)
    assert int(info.status) == int(info2.status) == t_cg.CONVERGED
    assert int(info.iterations) == int(info2.iterations) <= 8
    n = int(info.iterations)
    assert torch.equal(u, u2)
    assert torch.equal(info.history[:9], info2.history)
    assert torch.isinf(info.history[n + 1:]).all()
    _, info = t_cg.cg(lambda x: A @ x, b, tol=0.0, max_iter=3)
    assert int(info.status) == t_cg.MAX_ITER and int(info.iterations) == 3


def test_refined_solve_matches_tpufem(problem, tpufem_results, port_system):
    coords, conn, _, b = problem
    ref = tpufem_torch.RefinedSystem(port_system, coords, conn, "c3d10", E,
                                     NU, chunk_elems=100,
                                     geometry_dtype=torch.float64)
    assert len(ref.op64.chunks) > 1
    u, info = ref.solve(b, tol_rel=1e-10, inner_tol=TOL, inner_max_iter=5000,
                        every=EVERY)
    assert info.converged and info.rel_residual <= 1e-10
    assert info.cycles >= 2
    rj = tpufem_results["rinfo"]
    assert rj.converged and abs(info.cycles - rj.cycles) <= 1
    # tpufem's own f64 operator confirms the port's true residual
    u64 = u.numpy()
    F = np.asarray(tpufem_results["op64"](jnp.asarray(u64)))
    r = np.where(tpufem_results["mask"], b.reshape(-1).astype(np.float64) - F,
                 0.0)
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b)
    uj = tpufem_results["u_ref"]
    assert np.linalg.norm(u64 - uj) <= 1e-6 * np.linalg.norm(uj)
    # and the two f64 operators agree on the same field
    F_t = ref.op64(torch.from_numpy(u64)).numpy()
    assert np.abs(F_t - F).max() <= 1e-12 * np.abs(F).max()
