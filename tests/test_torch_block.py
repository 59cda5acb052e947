"""The port's block-Jacobi preconditioner against tpufem's.

box_tet10(3) with a curved map (so the 3x3 node blocks are full), fixed
base, load on the top face.  The element-block math
(pa_blockdiag_planar), the assembled block diagonal (block_diagonal:
compress_gather twice per bucket, then combine twice), the closed-form
inversion (invert_block_planes, with the constraint mask and a singular
block) and block_apply agree with tpufem's to 1e-12 relative in f64.  The
block-Jacobi PCG in f64 reaches tpufem's status in iterations within 3%
and the same u to 1e-6.  Its tolerance, 1e-9 on a unit-norm RHS, sits
above this problem's f64 floor: at 1e-10 both packages stop NOT_SPD
after 173-174 iterations with the residual at 3e-10.  The refined solve
(f32 operator, block-Jacobi inner PCG at 1e-5, above the f32 floor)
reaches a 1e-10 f64 true residual and agrees with tpufem's f64 block-PCG
displacement to 1e-6 (tpufem's own refined solve is left out: its
interpret-mode programs would double the file's time).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements.tables import element_table
from tpufem.ops import packed as j_packed
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.ops import packed as t_packed
from tpufem_torch.solvers import cg as t_cg

E, NU = 200e9, 0.3
INNER_TOL = 1e-5     # absolute PCG tolerances on a unit-norm right-hand side
PCG_TOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def problem():
    coords, conn = meshgen.box_tet10(3, 3, 3)
    coords = coords.copy()
    coords[:, 0] += 0.05 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    b /= np.linalg.norm(b)
    # tpufem's staged operator: its interpret-mode solves compile in about
    # half the time of the fused one's
    jop = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords), conn, "c3d10", E, NU, n_nodes=N,
        interpret=True, fuse="")
    return dict(coords=coords, conn=conn, fixed=fixed, b=b, jop=jop,
                tp=t_packed.PackedPlan.build(coords, conn, N, device="cpu"))


@pytest.fixture(scope="module")
def port_op(problem):
    """The port's f64 fused operator with tpufem's (planar) geometry
    carried across."""
    jop = problem["jop"]
    return tpufem_torch.PackedPartialOperator.build(
        problem["coords"], problem["conn"], "c3d10", E, NU,
        plan=problem["tp"], geometry=(jop.Jinv, jop.W), dtype=torch.float64,
        device="cpu")


@pytest.fixture(scope="module")
def tpufem_blocks(problem):
    D, O = jax.jit(lambda o: o.block_diagonal())(problem["jop"])
    return np.asarray(D), np.asarray(O)


def test_pa_blockdiag_planar_matches_tpufem():
    dN = element_table("c3d10").dN
    rng = np.random.default_rng(0)
    J = rng.standard_normal((4, 9, 5, 32))
    W = rng.random((4, 5, 32))
    want = j_packed.pa_blockdiag_planar(jnp.asarray(J), jnp.asarray(W), dN,
                                        1.3, 0.7)
    got = t_packed.pa_blockdiag_planar(torch.from_numpy(J),
                                       torch.from_numpy(W), dN, 1.3, 0.7)
    for g, w in zip(got, want, strict=True):
        assert g.shape == (3, 10, 5, 32)
        assert _rel(g.numpy(), w) <= 1e-14


@pytest.mark.parametrize("fuse", ["dense", ""])
def test_block_diagonal_and_inverse_match_tpufem(problem, port_op,
                                                 tpufem_blocks, fuse):
    """block_diagonal in both geometry layouts, then invert_block_planes
    with the constraint mask, with one singular block, and block_apply."""
    jop = problem["jop"]
    op = port_op
    if not fuse:
        op = tpufem_torch.PackedPartialOperator.build(
            problem["coords"], problem["conn"], "c3d10", E, NU, plan=op.plan,
            fuse="", geometry=(op.Jinv, op.W), dtype=torch.float64,
            device="cpu")
    Dj, Oj = tpufem_blocks
    D, O = op.block_diagonal()
    assert _rel(D.numpy(), Dj) <= 1e-12 and _rel(O.numpy(), Oj) <= 1e-12
    mask = tpufem_torch.PackedConstraints.fixed(
        op.plan, problem["fixed"], torch.float64).mask
    mask_j = np.asarray(j_packed.PackedConstraints.fixed(
        jop.plan, problem["fixed"], np.float64).mask)
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    # a singular block: node 0 of row 0 gets a rank-1 block
    Ds, Os = Dj.copy(), Oj.copy()
    for c in range(3):
        Ds[0, c * 128] = 1.0
        Os[0, c * 128] = 1.0
    r = np.random.default_rng(1).standard_normal(Dj.shape)
    for Dx, Ox, m_t, m_j in ((Dj, Oj, mask, mask_j), (Dj, Oj, None, None),
                             (Ds, Os, None, None)):
        inv_j = j_packed.invert_block_planes(jnp.asarray(Dx), jnp.asarray(Ox),
                                             None if m_j is None
                                             else jnp.asarray(m_j))
        inv_t = tpufem_torch.invert_block_planes(
            torch.from_numpy(Dx), torch.from_numpy(Ox), m_t)
        for g, w in zip(inv_t, inv_j, strict=True):
            assert _rel(g.numpy(), w) <= 1e-12
        z_j = j_packed.block_apply(*inv_j, jnp.asarray(r))
        z_t = tpufem_torch.block_apply(*inv_t, torch.from_numpy(r))
        assert _rel(z_t.numpy(), z_j) <= 1e-12
    # the singular block fell back to the scalar diagonal
    inv_d, inv_o = tpufem_torch.invert_block_planes(torch.from_numpy(Ds),
                                                    torch.from_numpy(Os))
    assert float(inv_d[0, 0]) == 1.0 and float(inv_o[0, 0]) == 0.0
    jac = tpufem_torch.BlockJacobi.build(op, mask=mask)
    assert torch.equal(jac(torch.from_numpy(r)),
                       tpufem_torch.block_apply(jac.inv_d, jac.inv_o,
                                                torch.from_numpy(r)))


@pytest.fixture(scope="module")
def tpufem_solve(problem):
    """tpufem's f64 block-Jacobi PCG."""
    sys64 = j_packed.PackedSystem(problem["jop"],
                                  fixed_nodes=problem["fixed"],
                                  precondition="block")
    u, info = sys64.solve(problem["b"], tol=PCG_TOL, max_iter=2000)
    return dict(u=np.asarray(u), status=int(info.status),
                iterations=int(info.iterations))


def test_block_pcg_matches_tpufem(problem, port_op, tpufem_solve):
    system = tpufem_torch.PackedSystem(port_op, fixed_nodes=problem["fixed"],
                                       precondition="block")
    assert isinstance(system.M_inv, tpufem_torch.BlockJacobi)
    u, info = system.solve(problem["b"], tol=PCG_TOL, max_iter=2000)
    assert int(info.status) == tpufem_solve["status"] == t_cg.CONVERGED
    it, it_j = int(info.iterations), tpufem_solve["iterations"]
    assert abs(it - it_j) <= max(1, 0.03 * it_j)
    assert _rel(u.numpy(), tpufem_solve["u"]) <= 1e-6


def test_refined_block_solve_matches_tpufem(problem, tpufem_solve):
    coords, conn, fixed, b = (problem[k] for k in ("coords", "conn",
                                                    "fixed", "b"))
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=problem["tp"], fuse="",
        dtype=torch.float32, device="cpu")
    system = tpufem_torch.PackedSystem(op, fixed_nodes=fixed,
                                       precondition="block")
    ref = tpufem_torch.RefinedSystem(system, coords, conn, "c3d10", E, NU,
                                     geometry_dtype=torch.float64)
    u, info = ref.solve(b.astype(np.float32), tol_rel=1e-10,
                        inner_tol=INNER_TOL, inner_max_iter=2000, every=50)
    assert info.converged and info.rel_residual <= 1e-10
    assert info.cycles >= 2
    uj = tpufem_solve["u"].reshape(-1)
    assert np.linalg.norm(u.numpy() - uj) <= 1e-6 * np.linalg.norm(uj)
