"""tpufem_torch's solver family against tpufem's: the compensated dot,
cg(dot_dtype="compensated"), masked_cg, BiCGStab, GMRES (with and without
the Jacobi M_inv), Newton-Raphson and the two modal solvers.

Every solve runs on the same [N, 3] MatrixFreeOperator problem in both
packages: box_tet(2) c3d4 (E = 200, nu = 0.3; tpufem's element K, as
numpy, drives both operators), z = 0 fixed, a load on the top face.
Tolerances: comp_vdot bitwise equal to tpufem's (f32 and f64), within
1e-12 of an f64 np.dot in f64 and within one f32 ulp of the exact sum in
f32; f64 solves: the solution within 1e-10 relative (max-norm), the same
status and iteration count (BiCGStab: the same status, see its test);
f32 compensated CG within 1e-5 relative and the same status and count;
modal (box_tet(1, 1, 2), three modes and four guard vectors, five
subspace iterations; the [N, 3] solver and PackedSystem.modal against
one tpufem run): eigenvalues within 1e-6 relative of tpufem's and of
scipy.linalg.eigh on the dense constrained pencil, each mode's
M-normalised overlap with tpufem's >= 1 - 1e-6; naive_modal_solver:
tpufem's own check.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from tpufem.elements import solid as j_solid
from tpufem.ops.operator import MatrixFreeOperator as JOp
from tpufem.ops.scatter import ScatterPlan as JPlan
from tpufem.ops.scatter import element_dofs
from tpufem.solvers import bicgstab as j_bicgstab
from tpufem.solvers import cg as j_cg
from tpufem.solvers import gmres as j_gmres
from tpufem.solvers import modal as j_modal
from tpufem.solvers import newton as j_newton
from tpufem.solvers.constraints import Constraints as JCons
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.solvers import bicgstab as t_bicgstab
from tpufem_torch.solvers import cg as t_cg
from tpufem_torch.solvers import gmres as t_gmres
from tpufem_torch.solvers import modal as t_modal
from tpufem_torch.solvers import newton as t_newton

E, NU, RHO = 200.0, 0.3, 5.0


def _jit(fn, *args):
    """A tpufem call as one jitted program (its eager dispatch compiles
    each op on its own)."""
    return jax.jit(fn)(*args)


def _k_and_m(coords, conn):
    """tpufem's c3d4 element K and consistent mass, as numpy."""
    c4 = jnp.asarray(conn)
    return tuple(np.asarray(a) for a in _jit(
        lambda c: (j_solid.stiffness(c, c4, "c3d4", E, NU),
                   j_solid.mass(c, c4, "c3d4", RHO)), jnp.asarray(coords)))



@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives (the plain packed kernels are thousands of small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def prob():
    coords, conn = meshgen.box_tet(2, 2, 2)
    N = coords.shape[0]
    K, Mloc = _k_and_m(coords, conn)
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 0.02
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -0.01
    jop = JOp(K=jnp.asarray(K), plan=JPlan.build(conn, N, 3))
    top = tpufem_torch.MatrixFreeOperator(
        torch.tensor(K), tpufem_torch.ScatterPlan.build(conn, N, 3,
                                                        device="cpu"))
    return dict(coords=coords, conn=conn, N=N, K=K, Mloc=Mloc, fixed=fixed,
                b=b, jop=jop, top=top,
                jcons=JCons.fixed(N, fixed, 3),
                tcons=tpufem_torch.Constraints.fixed(N, fixed, 3))


def _same_solve(ut, it, uj, ij, tol=1e-10):
    assert int(it.status) == int(ij.status)
    assert int(it.iterations) == int(ij.iterations)
    assert _rel(ut, uj) <= tol


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_comp_vdot(dt):
    rng = np.random.default_rng(3)
    for n in (1, 7, 1001):
        a = rng.standard_normal(n).astype(dt)
        c = rng.standard_normal(n).astype(dt)
        got = tpufem_torch.comp_vdot(torch.tensor(a), torch.tensor(c))
        assert got.dtype == torch.from_numpy(a).dtype and got.dim() == 0
        assert float(got) == float(_jit(j_cg.comp_vdot, jnp.asarray(a),
                                        jnp.asarray(c)))
        if dt == np.float64:
            ref = np.dot(a, c)
            assert abs(float(got) - ref) <= 1e-12 * abs(ref)
        else:
            exact = math.fsum((a.astype(np.float64)
                               * c.astype(np.float64)).tolist())
            ulp = abs(np.spacing(np.float32(exact)))
            assert abs(float(got) - exact) <= ulp


def test_cg_compensated_matches_tpufem(prob):
    """f32 vectors with compensated dots, Jacobi PCG, 1e-5."""
    K32 = prob["K"].astype(np.float32)
    N, b = prob["N"], prob["b"].astype(np.float32)
    jop = JOp(K=jnp.asarray(K32), plan=JPlan.build(prob["conn"], N, 3))
    top = tpufem_torch.MatrixFreeOperator(torch.tensor(K32), prob["top"].plan)
    mj = jnp.asarray(1.0 / np.asarray(jop.diagonal()).reshape(N, 3))
    mt = 1.0 / top.diagonal().reshape(N, 3)
    jc = JCons.fixed(N, prob["fixed"], 3, dtype=np.float32)
    tc = tpufem_torch.Constraints.fixed(N, prob["fixed"], 3,
                                        dtype=np.float32)
    kw = dict(tol=1e-7 * float(np.linalg.norm(b)), max_iter=300,
              dot_dtype="compensated")
    uj, ij = _jit(lambda bb: j_cg.cg(jop, bb, constraints=jc, M_inv=mj,
                                     **kw), jnp.asarray(b))
    ut, it = tpufem_torch.cg(top, torch.tensor(b), constraints=tc, M_inv=mt,
                             **kw)
    assert ut.dtype == torch.float32 and int(it.status) == t_cg.CONVERGED
    _same_solve(ut, it, uj, ij, tol=1e-5)
    assert float(it.residual_norm) < kw["tol"] > float(ij.residual_norm)


def test_masked_cg_matches_tpufem(prob):
    N = prob["N"]
    mask = np.ones((N, 3))
    mask[prob["fixed"]] = 0.0
    kw = dict(tol=1e-12, max_iter=500)
    uj, ij = _jit(lambda b: j_cg.masked_cg(prob["jop"], b, jnp.asarray(mask),
                                           **kw), jnp.asarray(prob["b"]))
    ut, it = tpufem_torch.masked_cg(prob["top"], torch.tensor(prob["b"]),
                                    torch.tensor(mask), **kw)
    assert int(it.status) == t_cg.CONVERGED
    _same_solve(ut, it, uj, ij)
    assert not ut[prob["fixed"]].any()


def test_bicgstab_matches_tpufem(prob):
    """BiCGStab amplifies the roundoff by which the two packages' operators
    and dots differ (1e-13 relative here) by about 4x per iteration, so
    the histories agree to 1e-8 over the first 10 iterations and then
    part: at 1e-12 the count is not reproducible across packages (tpufem
    71, port 60 here; ROADMAP §3), the status and the solution (1e-10)
    are.  At tol 0.04, reached at iteration 12 while the histories still
    agree to 1e-8 (the neighbours 0.049 and 0.033 lie far from the bar),
    the counts are equal too."""
    kw = dict(tol=0.04, max_iter=2000)
    _, ij = _jit(lambda b: j_bicgstab.bicgstab(
        prob["jop"], b, constraints=prob["jcons"], **kw),
        jnp.asarray(prob["b"]))
    _, it = t_bicgstab.bicgstab(prob["top"], torch.tensor(prob["b"]),
                                constraints=prob["tcons"], **kw)
    assert int(it.status) == int(ij.status) == t_cg.CONVERGED
    assert int(it.iterations) == int(ij.iterations) == 12
    kw = dict(tol=1e-12, max_iter=2000)
    uj, ij = _jit(lambda b: j_bicgstab.bicgstab(
        prob["jop"], b, constraints=prob["jcons"], **kw),
        jnp.asarray(prob["b"]))
    ut, it = t_bicgstab.bicgstab(prob["top"], torch.tensor(prob["b"]),
                                 constraints=prob["tcons"], **kw)
    assert int(it.status) == int(ij.status) == t_cg.CONVERGED
    assert t_bicgstab.BREAKDOWN == t_cg.NOT_SPD
    assert _rel(ut, uj) <= 1e-10
    n = int(it.iterations)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    assert ht.shape == hj.shape and np.isinf(ht[n + 1:]).all()
    assert np.isfinite(ht[:n + 1]).all()
    assert _rel(ht[:11], hj[:11]) <= 1e-8
    assert float(it.residual_norm) == ht[n] < 1e-12 * ht[0]
    assert not ut[prob["fixed"]].any()


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
def test_gmres_matches_tpufem(prob, jacobi):
    N = prob["N"]
    kw = dict(tol=1e-11, max_iter=400, restart=40)
    mj = mt = None
    if jacobi:
        d = prob["top"].diagonal()
        mt = torch.where(d.abs() > 0, 1.0 / d, 0.0).reshape(N, 3)
        mj = jnp.asarray(mt.numpy())
    uj, ij = _jit(lambda b: j_gmres.gmres(
        prob["jop"], b, constraints=prob["jcons"], M_inv=mj, **kw),
        jnp.asarray(prob["b"]))
    ut, it = t_gmres.gmres(prob["top"], torch.tensor(prob["b"]),
                           constraints=prob["tcons"], M_inv=mt, **kw)
    assert int(it.status) == t_cg.CONVERGED
    _same_solve(ut, it, uj, ij)
    hj, ht = np.asarray(ij.history), it.history.numpy()
    n = int(it.iterations)
    assert ht.shape == hj.shape and np.isinf(ht[n:]).all()
    assert _rel(ht[:n], hj[:n]) <= 1e-8


def test_newton_matches_tpufem(prob):
    kw = dict(tol=1e-9, inner_tol=1e-12, inner_max_iter=2000)
    uj, ij = j_newton.newton_raphson(lambda u: prob["jop"],
                                     jnp.asarray(prob["b"]),
                                     constraints=prob["jcons"], **kw)
    ut, it = t_newton.newton_raphson(lambda u: prob["top"],
                                     torch.tensor(prob["b"]),
                                     constraints=prob["tcons"], **kw)
    assert it.converged and ij.converged
    assert it.iterations == ij.iterations
    assert _rel(ut, uj) <= 1e-10
    # the first residual agrees; the last ones are roundoff (< tol)
    assert abs(it.residual_norms[0] - ij.residual_norms[0]) <= \
        1e-12 * ij.residual_norms[0]
    assert it.residual_norms[-1] < 1e-9 > ij.residual_norms[-1]


@pytest.fixture(scope="module")
def modal_ref():
    """tpufem's modal_solver on box_tet(1, 1, 2) c3d4 (three modes, four
    guard vectors, five subspace iterations), run once for the [N, 3]
    and the packed port, and the dense constrained pencil's three lowest
    eigenvalues."""
    coords, conn = meshgen.box_tet(1, 1, 2)
    N = coords.shape[0]
    K, Mloc = _k_and_m(coords, conn)
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    jop = JOp(K=jnp.asarray(K), plan=JPlan.build(conn, N, 3))
    Md = j_modal.lumped_mass_diagonal(jnp.asarray(Mloc), jop.plan)
    kw = dict(num_eigs=3, max_iter=5, inner_tol=1e-12, inner_max_iter=2000,
              n_guard=4)
    lam, modes, _ = j_modal.modal_solver(jop, Md, (N, 3),
                                         constraints=JCons.fixed(N, fixed, 3),
                                         **kw)
    dofs = element_dofs(conn, 3)
    A = np.zeros((3 * N, 3 * N))
    for e in range(dofs.shape[0]):
        A[np.ix_(dofs[e], dofs[e])] += K[e]
    free = np.ones(3 * N, bool)
    free[(fixed[:, None] * 3 + np.arange(3)).reshape(-1)] = False
    Md = np.asarray(Md)
    w = scipy.linalg.eigh(A[np.ix_(free, free)], np.diag(Md[free]),
                          eigvals_only=True)[:3]
    return dict(coords=coords, conn=conn, N=N, K=K, Mloc=Mloc, fixed=fixed,
                jop=jop, Md=Md, kw=kw, lam=np.asarray(lam),
                modes=np.asarray(modes), w=w)


def _check_modes(lam, modes, ref):
    """Eigenvalues within 1e-6 of tpufem's and of the dense pencil's; each
    mode's M-normalised overlap with tpufem's >= 1 - 1e-6; zero on the
    fixed nodes.  modes [N * 3, k]."""
    lam = lam.numpy()
    assert np.abs(lam - ref["lam"]).max() <= 1e-6 * np.abs(ref["lam"]).max()
    assert np.abs(lam - ref["w"]).max() <= 1e-6 * ref["w"].max()
    mt, mj, Md = modes.numpy(), ref["modes"], ref["Md"]
    assert not mt.reshape(ref["N"], 3, -1)[ref["fixed"]].any()
    for i in range(3):
        a, c = mt[:, i], mj[:, i]
        ov = abs(a @ (Md * c)) / math.sqrt((a @ (Md * a)) * (c @ (Md * c)))
        assert ov >= 1 - 1e-6, (i, ov)


def test_modal_solver_matches_tpufem_and_scipy(modal_ref):
    N = modal_ref["N"]
    top = tpufem_torch.MatrixFreeOperator(
        torch.tensor(modal_ref["K"]), tpufem_torch.ScatterPlan.build(
            modal_ref["conn"], N, 3, device="cpu"))
    Md = t_modal.lumped_mass_diagonal(torch.tensor(modal_ref["Mloc"]),
                                      top.plan)
    assert _rel(Md, modal_ref["Md"]) <= 1e-14
    lam, modes, info = tpufem_torch.modal_solver(
        top, Md, (N, 3), constraints=tpufem_torch.Constraints.fixed(
            N, modal_ref["fixed"], 3), **modal_ref["kw"])
    assert info.iterations == 5 and info.eigenvalue_history.shape == (5, 3)
    _check_modes(lam, modes, modal_ref)


def test_packed_modal_matches_tpufem(modal_ref):
    """PackedSystem.modal (scalar-Jacobi inner PCG, the packed operator's
    plain kernels on the CPU) against the same references."""
    N = modal_ref["N"]
    op = tpufem_torch.PackedPartialOperator.build(
        modal_ref["coords"], modal_ref["conn"], "c3d4", E, NU, n_nodes=N,
        dtype=torch.float64, device="cpu")
    system = tpufem_torch.PackedSystem(op, fixed_nodes=modal_ref["fixed"])
    Mn = modal_ref["Md"].reshape(N, 3)
    lam, modes, info = system.modal(Mn, **modal_ref["kw"])
    assert modes.shape == (N, 3, 3) and info.iterations == 5
    _check_modes(lam, modes.reshape(N * 3, 3), modal_ref)
    Mp = system.mass_packed(Mn)
    assert Mp.shape == (op.plan.meta.n_blocks * 384,)
    assert bool((Mp > 0).all())
    assert torch.equal(op.plan.unpack(Mp.reshape(-1, 384)),
                       torch.tensor(Mn))


def test_subspace_steps_are_modal_solvers(modal_ref):
    """subspace_steps yields the start block, then modal_solver's Ritz
    pairs step by step: after five steps, bitwise its result and its
    history."""
    N, kw = modal_ref["N"], modal_ref["kw"]
    top = tpufem_torch.MatrixFreeOperator(
        torch.tensor(modal_ref["K"]), tpufem_torch.ScatterPlan.build(
            modal_ref["conn"], N, 3, device="cpu"))
    Md = torch.tensor(modal_ref["Md"])
    cons = tpufem_torch.Constraints.fixed(N, modal_ref["fixed"], 3)
    lam, modes, info = tpufem_torch.modal_solver(top, Md, (N, 3),
                                                 constraints=cons, **kw)
    k = kw["num_eigs"]
    steps = t_modal.subspace_steps(
        top, Md, (N, 3), k + kw["n_guard"], constraints=cons,
        inner_tol=kw["inner_tol"], inner_max_iter=kw["inner_max_iter"])
    lam0, X = next(steps)
    assert not lam0.any() and X.shape == (3 * N, k + kw["n_guard"])
    for i in range(kw["max_iter"]):
        lam_i, X = next(steps)
        assert np.array_equal(lam_i[:k].numpy(),
                              info.eigenvalue_history[i])
    assert torch.equal(lam_i[:k], lam) and torch.equal(X[:, :k], modes)


def test_modal_sweep_flow_on_cpu(monkeypatch, capsys):
    """scripts.modal_sweep on box_tet10(2) (its device forced to the
    CPU): one JSON line per step, whose last Ritz values are
    PackedSystem.modal's after as many steps with the same settings."""
    import json

    from tpufem_torch.scripts import modal_sweep
    monkeypatch.setattr(tpufem_torch, "resolve_device",
                        lambda device: torch.device("cpu"))
    modal_sweep.main(["2", "6:2"])
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[0]["nodes"] == 125 and len(rows) == 3
    assert [r["outer"] for r in rows[1:]] == [1, 2]
    assert all(np.isfinite(r["eigen_residuals"]).all() for r in rows[1:])
    coords, conn = meshgen.box_tet10(2, 2, 2)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", modal_sweep.E, modal_sweep.NU, n_nodes=N,
        dtype=torch.float64, device="cpu")
    system = tpufem_torch.PackedSystem(op, fixed_nodes=fixed)
    ct = torch.tensor(coords)
    plan = tpufem_torch.ScatterPlan.build(conn, N, 3, device="cpu")
    mass = plan.scatter(tpufem_torch.solid.lumped_mass(
        ct, torch.tensor(conn), "c3d10", modal_sweep.RHO)).reshape(N, 3)
    lam, _, _ = system.modal(mass, num_eigs=5, max_iter=2, inner_tol=1e-8,
                             inner_max_iter=6)
    assert rows[-1]["ritz"] == [float(x) for x in lam]


def test_naive_modal_solver_runs():
    """tpufem's own check (tests/test_solvers.py::test_naive_modal_solver_runs)
    on the port: k eigenpairs, finite."""
    coords, conn = meshgen.box_tet(1, 1, 1)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    fixed_dofs = (np.asarray(fixed)[:, None] * 3 + np.arange(3)).reshape(-1)
    c, e = torch.tensor(coords), torch.tensor(conn)
    op = tpufem_torch.MatrixFreeOperator(
        tpufem_torch.solid.stiffness(c, e, "c3d4", E, NU),
        tpufem_torch.ScatterPlan.build(conn, N, 3, device="cpu"))
    Md = t_modal.lumped_mass_diagonal(
        tpufem_torch.solid.mass(c, e, "c3d4", RHO), op.plan)
    lam, modes = tpufem_torch.naive_modal_solver(
        op, Md, (N, 3), num_eigs=3, fixed_dofs=fixed_dofs, max_iter=10)
    assert lam.shape == (3,) and modes.shape == (N * 3, 3)
    assert bool(torch.isfinite(lam).all())
