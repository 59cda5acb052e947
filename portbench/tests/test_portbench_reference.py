"""The plain reference: a converged solve on a box of each element,
agreement with the program's own float64 operators on the CPU, and the
judge's readings of one fixed answer frozen to the bit."""
import numpy as np
import pytest
import torch

from portbench import judge
from portbench import loads as loadsmod
from portbench import mesh as meshmod
from portbench.reference import elasticity as ref
from portbench.tests.cells import tiny_cell

E, NU = 200e9, 0.3
# (generator, element type) of each element the reference holds
ELEMENTS = [("box_tet10", "c3d10"), ("box_tet4", "c3d4")]


@pytest.fixture(scope="module", params=ELEMENTS, ids=[e for _, e in ELEMENTS])
def box(request):
    generator, etype = request.param
    coords, conn = meshmod.generator(generator).make((3, 3, 3),
                                                     (1.0, 1.0, 1.0))
    fixed = meshmod.boundary_nodes(coords, 2, 0.0)
    top = meshmod.boundary_nodes(coords, 2, 1.0)
    return coords, conn, fixed, top, etype


def test_converged_plain_solve(box):
    coords, conn, fixed, top, etype = box
    op = ref.Elasticity(coords, conn, etype, E, NU)
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
    coords, conn, _, _, etype = box
    op = ref.Elasticity(coords, conn, etype, E, NU, chunk=50)
    g = torch.Generator().manual_seed(0)
    u = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    v = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    uKv, vKu = float((u * op.apply(v)).sum()), float((v * op.apply(u)).sum())
    assert abs(uKv - vKu) <= 1e-12 * abs(uKv)
    assert float((u * op.apply(u)).sum()) > 0
    X = torch.as_tensor(coords)
    scale = float(op.apply(u).abs().max())
    x, y, z = X[:, 0], X[:, 1], X[:, 2]
    one, nil = torch.ones_like(x), torch.zeros_like(x)
    rigid = [torch.stack([one, nil, nil], 1),              # translations
             torch.stack([nil, one, nil], 1),
             torch.stack([nil, nil, one], 1),
             torch.stack([-y, x, nil], 1),                 # rotations
             torch.stack([nil, -z, y], 1),
             torch.stack([z, nil, -x], 1)]
    for r in rigid:
        assert float(op.apply(r).abs().max()) <= 1e-12 * scale
    # a uniform strain: only the boundary nodes carry forces
    lin = torch.stack([X[:, 0], 0.3 * X[:, 1], -0.2 * X[:, 2]], 1)
    inner = ((X > 1e-9) & (X < 1 - 1e-9)).all(1)
    assert float(op.apply(lin)[inner].abs().max()) <= 1e-12 * scale


def test_agrees_with_the_programs_f64_operators(box):
    from tpufem_torch import PackedPartialOperator
    from tpufem_torch.solvers.refine import F64Operator
    coords, conn, _, _, etype = box
    op = ref.Elasticity(coords, conn, etype, E, NU)
    g = torch.Generator().manual_seed(1)
    u = torch.randn(coords.shape[0], 3, generator=g, dtype=torch.float64)
    want = op.apply(u)
    f64 = F64Operator(coords, conn, etype, E, NU,
                      geometry_dtype=torch.float64, device="cpu")
    got = f64(u.reshape(-1)).reshape(-1, 3)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    pk = PackedPartialOperator.build(coords, conn, etype, E, NU,
                                     n_nodes=coords.shape[0],
                                     dtype=torch.float64, device="cpu")
    got = pk.plan.unpack(pk(pk.plan.pack(u)))
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    d = pk.plan.unpack(pk.diagonal())
    d_ref = op.diagonal()
    assert float(((d - d_ref).abs() / d_ref).max()) <= 1e-12


def test_judge_refuses_an_element_that_the_configuration_misstates():
    coords, conn = meshmod.generator("box_tet4").make((1, 1, 1),
                                                     (1.0, 1.0, 1.0))
    fixed = meshmod.boundary_nodes(coords, 2, 0.0)
    u = np.zeros(coords.shape)
    with pytest.raises(ValueError):
        judge.judge(coords, conn, fixed,
                    {"type": "c3d4", "nodes": 4, "points": 4},
                    {"E": E, "nu": NU}, [(u, u)], None, 1e-6, None, "cpu")


# The judge's readings of one fixed answer at box_tet10(2, 2, 3), as the
# reference read them before it found its element by name (float.hex):
# resid_max and diag_rel of each configuration, and fixed_max 0.
FROZEN = {
    "tet10_box_1m.refined_f32": ("0x1.4bf784071de3cp+0",
                                 "0x1.addc6c992dae0p+2"),
    "tet10_box_1m_f64.pcg_f64": ("0x1.4bf784071de3cp+0",
                                 "0x1.addc6c992dae0p+2"),
    "tet10_box_1m_assembled.assembled_f64": ("0x1.4bf784071de3cp+0",
                                             "0x1.addc6c992dae0p+2"),
}


@pytest.mark.parametrize("workload", sorted(FROZEN))
def test_judge_readings_are_frozen(workload):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = (cell := tiny_cell(workload, (2, 2, 3))).config
        coords, conn = meshmod.make(cfg["mesh"])
        fixed = meshmod.boundary_nodes(coords, cfg["fixed"]["axis"],
                                       cfg["fixed"]["value"])
        b = loadsmod.LoadStream(cell.traffic, coords, 11).warm
        rng = np.random.default_rng(2026)
        u = rng.standard_normal(coords.shape) * 1e-9
        u[fixed] = 0.0
        diag = rng.uniform(1e9, 2e11, coords.shape)
        nums, resid = judge.judge(coords, conn, fixed, cfg["element"],
                                  cfg["material"], [(b, u), (-b, 0.5 * u)],
                                  diag, 1e-6, 1e-9, "cpu")
    finally:
        torch.set_num_threads(n)
    got = {x.name: x.value for x in nums}
    assert got["resid_max"].hex() == FROZEN[workload][0]
    assert got["diag_rel"].hex() == FROZEN[workload][1]
    assert got["fixed_max"] == 0.0
    assert resid[1].hex() == "0x1.14641ec3af4bcp+0"
