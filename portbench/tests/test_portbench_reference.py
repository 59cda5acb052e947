"""The plain reference: a converged solve on box_tet10(3), and agreement
with the program's own float64 operators on the CPU."""
import numpy as np
import pytest
import torch

from portbench import mesh as meshmod
from portbench.reference import elasticity as ref

E, NU = 200e9, 0.3


@pytest.fixture(scope="module")
def box():
    coords, conn = meshmod.box_tet10(3, 3, 3)
    fixed = meshmod.boundary_nodes(coords, 2, 0.0)
    top = meshmod.boundary_nodes(coords, 2, 1.0)
    return coords, conn, fixed, top


def test_converged_plain_solve(box):
    coords, conn, fixed, top = box
    op = ref.Elasticity(coords, conn, E, NU)
    free = ref.free_mask(coords.shape[0], fixed)
    b = np.zeros((coords.shape[0], 3))
    b[top, 2] = -1e3
    u, it, conv = ref.jacobi_pcg(op, b, free, 1e-10, 3000)
    assert conv and 0 < it < 3000
    assert ref.relative_residual(op, u, b, free) <= 1e-10
    assert float(u[torch.as_tensor(top).long(), 2].mean()) < 0
    assert float(u[torch.as_tensor(fixed).long()].abs().max()) == 0.0
    # the residual of zero displacement is the whole load
    assert ref.relative_residual(op, np.zeros_like(b), b, free) == 1.0


def test_operator_symmetric_and_rigid(box):
    coords, conn, _, _ = box
    op = ref.Elasticity(coords, conn, E, NU, chunk=50)
    g = torch.Generator().manual_seed(0)
    u = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    v = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    uKv, vKu = float((u * op.apply(v)).sum()), float((v * op.apply(u)).sum())
    assert abs(uKv - vKu) <= 1e-12 * abs(uKv)
    assert float((u * op.apply(u)).sum()) > 0
    X = torch.as_tensor(coords)
    scale = float(op.apply(u).abs().max())
    rigid = [torch.ones_like(X),                              # translation
             torch.stack([-X[:, 1], X[:, 0], 0 * X[:, 0]], 1)]  # rotation
    for r in rigid:
        assert float(op.apply(r).abs().max()) <= 1e-12 * scale
    # a uniform strain: only the boundary nodes carry forces
    lin = torch.stack([X[:, 0], 0.3 * X[:, 1], -0.2 * X[:, 2]], 1)
    inner = ((X > 1e-9) & (X < 1 - 1e-9)).all(1)
    assert float(op.apply(lin)[inner].abs().max()) <= 1e-12 * scale


def test_agrees_with_the_programs_f64_operators(box):
    from tpufem_torch import PackedPartialOperator
    from tpufem_torch.solvers.refine import F64Operator
    coords, conn, _, _ = box
    op = ref.Elasticity(coords, conn, E, NU)
    g = torch.Generator().manual_seed(1)
    u = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    want = op.apply(u)
    f64 = F64Operator(coords, conn, "c3d10", E, NU,
                      geometry_dtype=torch.float64, device="cpu")
    got = f64(u.reshape(-1)).reshape(-1, 3)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    pk = PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                     n_nodes=coords.shape[0],
                                     dtype=torch.float64, device="cpu")
    got = pk.plan.unpack(pk(pk.plan.pack(u)))
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    d = pk.plan.unpack(pk.diagonal())
    d_ref = op.diagonal()
    assert float(((d - d_ref).abs() / d_ref).max()) <= 1e-12
