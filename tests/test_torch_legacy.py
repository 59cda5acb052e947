"""tpufem_torch.solvers.legacy (the reference-signature entry points)
against tpufem.solvers.legacy, function by function.

One problem for the solid solvers: box_tet(1, 1, 2) c3d4 (E = 200,
nu = 0.3; tpufem's element K and mass as numpy, the inputs of both), the
base fixed, a load on the top; one s4 plate (grid 3 x 3, clamped at x = 0)
for the shell solver.  f64 unless a reference default says f32 (then both
run f32).  Tolerances: f64 solutions within 1e-10 relative (max-norm), f32
within 1e-4; the parse_* tables and apply_loads_to_F bitwise; the modal
eigenvalues (box_tet(1, 1, 1)) within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import shell as j_shell
from tpufem.elements import solid as j_solid
from tpufem.solvers import legacy as jl
from tpufem.utils import meshgen

from tpufem_torch.solvers import legacy as tl

E, NU = 200.0, 0.3
CPU = dict(device="cpu")


def _k_and_m(coords, conn):
    """tpufem's c3d4 element K and consistent mass, as numpy (one jitted
    program)."""
    c4 = jnp.asarray(conn)
    return tuple(np.asarray(a) for a in jax.jit(
        lambda c: (j_solid.stiffness(c, c4, "c3d4", E, NU),
                   j_solid.mass(c, c4, "c3d4", 5.0)))(jnp.asarray(coords)))


def _ref(fn, *args, **kw):
    """A tpufem legacy call traced into one jitted program (every input is
    a host constant; its eager dispatch compiles each op on its own)."""
    return jax.jit(lambda: fn(*args, **kw))()



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
    coords, conn = meshgen.box_tet(1, 1, 2)
    N = coords.shape[0]
    K, Mloc = _k_and_m(coords, conn)
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    top = meshgen.boundary_nodes(coords, 2, 1.0)
    F = np.zeros((N, 3))
    F[top, 0], F[top, 2] = 0.02, -0.01
    return dict(coords=coords, conn=conn, N=N, K=K, Mloc=Mloc, fixed=fixed,
                top=top, F=F)


@pytest.mark.parametrize("name", [
    "stable_conjugate_gradient_solver", "final_solver"])
def test_fixed_cg_solvers(prob, name):
    args = (prob["K"], prob["conn"], prob["F"], prob["fixed"])
    kw = dict(tol=1e-12, max_iter=500)
    uj = _ref(getattr(jl, name), *args, **kw)
    ut = getattr(tl, name)(*args, **kw, **CPU)
    assert ut.dtype == torch.float64
    assert _rel(ut, uj) <= 1e-10


def test_shell_cg_solver():
    coords, conn = meshgen.grid_quad(3, 3)
    N = coords.shape[0]
    mat = (E, NU, 0.05)
    cj, ej = jnp.asarray(coords), jnp.asarray(conn)
    K, unit = (np.asarray(a) for a in jax.jit(lambda c: (
        j_shell.shell_stiffness(c, ej, mat, mat),
        j_shell.local_frames(c, ej)))(cj))
    # an in-plane pull and an end moment: the Kirchhoff element has no
    # stiffness on w (nor theta_z), and this reference solver does not
    # mask such DOFs, so a force on w would end it at NOT_SPD at once
    F = np.zeros((N, 6))
    F[meshgen.boundary_nodes(coords, 0, 1.0), 0] = 1e-3
    F[meshgen.boundary_nodes(coords, 0, 1.0), 4] = 1e-4
    fixed = meshgen.boundary_nodes(coords, 0, 0.0)
    kw = dict(tol=1e-12, max_iter=4000)
    uj = _ref(jl.stable_conjugate_gradient_shell_solver, K, conn, F, fixed,
              coords=coords, **kw)
    ut = tl.stable_conjugate_gradient_shell_solver(K, conn, F, fixed,
                                                   coords=coords, **kw, **CPU)
    assert _rel(ut, uj) <= 1e-10
    assert torch.equal(tl.stable_conjugate_gradient_shell_solver(
        K, conn, F, fixed, unit=unit, **kw, **CPU), ut)
    with pytest.raises(ValueError):
        tl.stable_conjugate_gradient_shell_solver(K, conn, F, fixed, **CPU)


def test_parse_and_loads_bitwise():
    spc = [{"node": 3, "dofs": [0, 2], "value": 0.5},
           {"node": 1, "dofs": [1], "value": -1.0}]
    rbe2 = [{"master": 0, "slaves": [4, 5], "dofs": [0, 1, 2]}]
    rbe3 = [{"master": 7, "slaves": [2, 3, 6], "dofs": [0, 2],
             "weights": [1.0, 2.0, 0.5]},
            {"master": 8, "slaves": [1], "dofs": [1], "weights": [3.0]}]
    pairs = [(tl.parse_spc_list(spc, **CPU), jl.parse_spc_list(spc)),
             (tl.parse_rbe2_list(rbe2, **CPU), jl.parse_rbe2_list(rbe2)),
             (tl.parse_rbe3_list(rbe3, **CPU), jl.parse_rbe3_list(rbe3))]
    for got, want in pairs:
        assert len(got) == len(want)
        for t, j in zip(got, want):
            j = np.asarray(j)
            assert t.numpy().dtype == j.dtype and np.array_equal(t.numpy(), j)
    loads = [{"node": 2, "force": [1.0, 0.0, -2.0]},
             {"node": 2, "force": [0.5, 0.5, 0.5]},
             {"node": 0, "force": [0.0, 3.0, 0.0]}]
    F = np.arange(30, dtype=np.float64).reshape(10, 3)
    got = tl.apply_loads_to_F(F, loads)
    assert np.array_equal(got, jl.apply_loads_to_F(F, loads))
    assert np.array_equal(F, np.arange(30, dtype=np.float64).reshape(10, 3))


def test_constrained_cg_solvers(prob):
    N, top = prob["N"], prob["top"]
    spc = [{"node": int(n), "dofs": [0, 1, 2], "value": 0.0}
           for n in prob["fixed"]]
    spc[0]["value"] = 1e-4
    rbe2 = [{"master": int(top[0]), "slaves": [int(top[1])],
             "dofs": [0, 1, 2]}]
    rbe3 = [{"master": int(top[2]), "slaves": [int(top[0]), int(top[3])],
             "dofs": [2], "weights": [1.0, 2.0]}]
    kw = dict(tol=1e-12, max_iter=500)
    args = (prob["K"], prob["conn"], prob["F"], rbe2, spc)
    assert _rel(tl.constrained_conjugate_gradient_solver(*args, **kw, **CPU),
                _ref(jl.constrained_conjugate_gradient_solver, *args,
                     **kw)) <= 1e-10
    loads = [{"node": int(n), "force": [0.02, 0.0, -0.01]} for n in top]
    args = (prob["K"], prob["conn"], N, rbe2, rbe3, spc, loads)
    assert _rel(
        tl.new_constrained_conjugate_gradient_solver(*args, **kw, **CPU),
        _ref(jl.new_constrained_conjugate_gradient_solver, *args,
             **kw)) <= 1e-10


def test_preconditioned_cg_solver(prob):
    """The reference defaults are f32: both run f32."""
    N = prob["N"]
    # no constraints here (the reference's signature has none): a spring
    # on every DOF keeps K regular
    K = prob["K"] + 10.0 * np.eye(prob["K"].shape[1])[None]
    mj = jl.compute_diagonal_preconditioner(K, prob["conn"], N)
    mt = tl.compute_diagonal_preconditioner(K, prob["conn"], N, **CPU)
    assert mt.dtype == torch.float32 and _rel(mt, mj) <= 1e-6
    args = (K, prob["conn"], prob["F"], np.asarray(mj))
    kw = dict(tol=1e-6, max_iter=50)
    uj = _ref(jl.preconditioned_conjugate_gradient_solver, *args, **kw)
    ut = tl.preconditioned_conjugate_gradient_solver(*args, **kw, **CPU)
    assert ut.dtype == torch.float32 and _rel(ut, uj) <= 1e-4


def test_bicgstab_and_gmres_solvers(prob):
    """f32 defaults; the pinned base for BiCGStab; GMRES's reference
    signature has no constraints, so K gets a diagonal spring (f64)."""
    args = (prob["K"], prob["conn"], prob["F"], prob["fixed"])
    kw = dict(tol=1e-5, max_iter=400)
    uj = _ref(jl.bicgstab_solver, *args, **kw)
    ut = tl.bicgstab_solver(*args, **kw, **CPU)
    assert ut.dtype == torch.float32 and _rel(ut, uj) <= 1e-4
    K = prob["K"] + 10.0 * np.eye(prob["K"].shape[1])[None]
    kw = dict(tol=1e-12, max_iter=200, restart=20, dtype=np.float64)
    uj = _ref(jl.gmres_solver, K, prob["conn"], prob["F"], **kw)
    ut = tl.gmres_solver(K, prob["conn"], prob["F"], **kw, **CPU)
    assert _rel(ut, uj) <= 1e-10


def test_newton_raphson_solver(prob):
    """A linear K(u): one solve and a check, as in tpufem's test; the
    reference signature has no constraints, so K gets a diagonal spring."""
    d = prob["K"].shape[1]
    K = prob["K"] + 10.0 * np.eye(d)[None]
    kw = dict(tol=1e-6, max_iter=5)
    uj = jl.newton_raphson_solver(lambda u: K, prob["conn"], prob["F"], **kw)
    ut = tl.newton_raphson_solver(lambda u: K, prob["conn"], prob["F"], **kw,
                                  **CPU)
    assert _rel(ut, uj) <= 1e-4


def test_vectorized_modal_solver():
    """box_tet(1, 1, 1) c3d4, two modes, five subspace iterations."""
    coords, conn = meshgen.box_tet(1, 1, 1)
    N = coords.shape[0]
    K, Mloc = _k_and_m(coords, conn)
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    kw = dict(num_eigs=2, max_iter=5, dtype=np.float64)
    lam_j, _ = jl.vectorized_modal_solver(K, Mloc, conn, fixed, N, **kw)
    lam_t, modes_t = tl.vectorized_modal_solver(K, Mloc, conn, fixed, N,
                                                **kw, **CPU)
    assert modes_t.shape == (N * 3, 2)
    lam_j = np.asarray(lam_j)
    assert np.abs(lam_t.numpy() - lam_j).max() <= 1e-6 * lam_j.max()
