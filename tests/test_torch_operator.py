"""tpufem_torch's PackedPartialOperator against tpufem's (fuse="dense",
interpret-mode Pallas kernels) on the same plan tables.

With tpufem's geometry carried across, the two differ only in the order
XLA evaluates tpufem's arithmetic: one apply and the diagonal agree to
1e-12 relative in f64 and 1e-5 in f32 (max-norm).  Geometry the port
computes itself from the coordinates agrees with tpufem's to f32 (f64)
roundoff of the Jacobian contraction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import packed as j_packed
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.ops import packed as t_packed
from tpufem_torch.solvers.refine import F64Operator

E, NU = 200e9, 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curve(coords):
    c = coords.copy()
    c[:, 0] += 0.05 * np.sin(2.0 * c[:, 1]) * c[:, 2]
    c[:, 1] += 0.03 * np.cos(1.0 + c[:, 2]) * c[:, 0]
    return c


CASES = {"f64": (np.float64, torch.float64, False),
         "f32": (np.float32, torch.float32, False),
         "f64-curved": (np.float64, torch.float64, True)}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """tpufem's operator, apply and diagonal (one jitted program) on
    box_tet10(3), and the port's plan for the same mesh."""
    np_dt, t_dt, curved = CASES[request.param]
    coords, conn = meshgen.box_tet10(3, 3, 3)
    if curved:
        coords = _curve(coords)
    N = coords.shape[0]
    jp = j_packed.PackedPlan.build(coords, conn, N)
    op = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords, np_dt), conn, "c3d10", E, NU, plan=jp,
        interpret=True, fuse="dense", dtype=np_dt)
    u = np.random.default_rng(0).standard_normal((N, 3)).astype(np_dt)
    X = np.array(jp.pack(jnp.asarray(u)))
    F, d = jax.jit(lambda o, x: (o(x), o.diagonal()))(op, jnp.asarray(X))
    tp = t_packed.PackedPlan.build(coords, conn, N, device="cpu")
    return dict(coords=coords, conn=conn, t_dt=t_dt, tp=tp, X=X,
                Jinv=np.array(op.Jinv), W=np.array(op.W),
                F=np.asarray(F), d=np.asarray(d), curved=curved)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_apply_and_diagonal_carried_geometry(case):
    t_dt = case["t_dt"]
    op = tpufem_torch.PackedPartialOperator.build(
        case["coords"], case["conn"], "c3d10", E, NU, plan=case["tp"],
        geometry=(case["Jinv"], case["W"]), dtype=t_dt, device="cpu")
    assert op.Jinv.shape[1] == (36 if case["curved"] else 9)
    tol = 1e-12 if t_dt == torch.float64 else 1e-5
    F = op(torch.from_numpy(case["X"])).numpy()
    assert _rel(F, case["F"]) <= tol
    assert _rel(op.diagonal().numpy(), case["d"]) <= tol


def test_geometry_computed_independently(case):
    """J = dN^T X sums coordinates of size ~1 into entries of size ~h, so
    f32 geometry carries ~eps_f32 / h relative error (h = 1/3 here):
    bounded at 1e-5 in f32 and 1e-12 in f64, the apply likewise."""
    t_dt = case["t_dt"]
    op = tpufem_torch.PackedPartialOperator.build(
        case["coords"], case["conn"], "c3d10", E, NU, plan=case["tp"],
        dtype=t_dt, device="cpu")
    tol = 1e-12 if t_dt == torch.float64 else 1e-5
    assert op.Jinv.shape == case["Jinv"].shape
    assert _rel(op.Jinv.numpy(), case["Jinv"]) <= tol
    assert _rel(op.W.numpy(), case["W"]) <= tol
    assert _rel(op(torch.from_numpy(case["X"])).numpy(), case["F"]) <= tol


@pytest.mark.parametrize("curved", [False, True], ids=["straight",
                                                      "curved"])
def test_operator_matches_independent_f64_operator(curved):
    """The packed f64 apply equals the refinement's f64 operator (natural
    layout, incidence scatter): two independent formulations."""
    coords, conn = meshgen.box_tet10(3, 3, 4)
    if curved:
        coords = _curve(coords)
    tp = t_packed.PackedPlan.build(coords, conn, coords.shape[0],
                                   device="cpu")
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=tp, dtype=torch.float64,
        device="cpu")
    op64 = F64Operator(coords, conn, "c3d10", E, NU, chunk_elems=50,
                       geometry_dtype=torch.float64, device="cpu")
    assert len(op64.chunks) > 1
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(
        3 * coords.shape[0]))
    F_packed = tp.unpack_flat(op(tp.pack_flat(u)))
    assert _rel(F_packed.numpy(), op64(u).numpy()) <= 1e-12


def test_entry_points_need_a_card(monkeypatch, tmp_path):
    """device=None means CUDA; without a card every entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coords, conn = meshgen.box_tet10(2, 2, 2)
    N = coords.shape[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.PackedPlan.build(coords, conn, N)
    plan = tpufem_torch.PackedPlan.build(coords, conn, N, device="cpu")
    assert plan.device.type == "cpu"
    plan.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.PackedPlan.load(str(tmp_path))
    assert tpufem_torch.PackedPlan.load(str(tmp_path),
                                        device="cpu").meta == plan.meta
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.PackedPartialOperator.build(coords, conn, "c3d10", E,
                                                 NU, n_nodes=N)
    with pytest.raises(RuntimeError, match="CUDA"):
        F64Operator(coords, conn, "c3d10", E, NU)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, device="cpu")
    assert op.W.device.type == "cpu"
    # the assembled-stiffness path
    for build in (lambda **kw: tpufem_torch.ScatterPlan.build(conn, N, 3,
                                                             **kw),
                  lambda **kw: tpufem_torch.ClusterPlan.build(conn, N, 3,
                                                             **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        assert build(device="cpu").device.type == "cpu"
    K = np.zeros((conn.shape[0], 30, 30))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.ClusteredOperator.build(K, conn, N)
    assert tpufem_torch.ClusteredOperator.build(
        K, conn, N, device="cpu").K.device.type == "cpu"
    force = np.zeros((N, 6))
    with pytest.raises(RuntimeError, match="CUDA"):
        tpufem_torch.static_structure_solver(
            coords, force, material={"E": E, "nu": NU}, c3d10=conn)


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
