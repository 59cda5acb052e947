"""tpufem_torch's BSR assembly against tpufem's ops/assembly.py.

On box_tet(2, 2, 3) c3d4 and box_tet10(2, 1, 2) c3d10 with curved
coordinates, tpufem's element K (as numpy, f64) drives both packages:
the structure tables (indptr, col_ids, row_ids, perm, segments) are
bitwise tpufem's; the block values, bsr_matvec, the diagonal and
assemble_dense agree within 1e-13 relative (max-norm; the sums run in
another order), to_scipy gives the dense matrix, and a 6-values-per-node
block assembly holds the same.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as j_solid
from tpufem.ops import assembly as ja
from tpufem.utils import meshgen

from tpufem_torch.ops import assembly as ta

E, NU = 200.0, 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


MESHES = {"c3d4": lambda: meshgen.box_tet(2, 2, 3),
          "c3d10": lambda: meshgen.box_tet10(2, 1, 2)}


@pytest.fixture(scope="module", params=sorted(MESHES))
def problem(request):
    etype = request.param
    coords, conn = MESHES[etype]()
    coords = coords + 0.03 * np.random.default_rng(0).standard_normal(
        coords.shape)
    K = np.array(jax.jit(lambda c: j_solid.stiffness(
        c, jnp.asarray(conn), etype, E, NU))(jnp.asarray(coords)))
    N = coords.shape[0]
    js = ja.build_bsr_structure(conn, N)
    jA = ja.assemble_bsr(jnp.asarray(K), conn.shape[1], js)
    ts = ta.build_bsr_structure(conn, N, device="cpu")
    tA = ta.assemble_bsr(torch.from_numpy(K), conn.shape[1], ts)
    return conn, K, N, js, jA, ts, tA


def test_structure_bitwise(problem):
    _, _, N, js, _, ts, _ = problem
    for name in ("indptr", "col_ids", "row_ids", "perm", "segments"):
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert ts.nnzb == js.nnzb and ts.nnz == js.nnz
    assert ts.n_block_rows == js.meta.n_block_rows == N


def test_values_matvec_diagonal(problem):
    _, _, N, _, jA, _, tA = problem
    assert _rel(tA.data9.numpy(), jA.data9) <= 1e-13
    assert _rel(tA.data.numpy(), jA.data) <= 1e-13
    x = np.random.default_rng(1).standard_normal((N, 3))
    yj = jax.jit(ja.bsr_matvec)(jA, jnp.asarray(x))
    assert _rel(tA(torch.from_numpy(x)).numpy(), yj) <= 1e-13
    assert _rel(tA.diagonal().numpy(), jA.diagonal()) <= 1e-13


def test_dense_and_scipy(problem):
    conn, K, N, _, _, _, tA = problem
    dj = np.asarray(ja.assemble_dense(jnp.asarray(K), conn, N))
    dt = ta.assemble_dense(torch.from_numpy(K), conn, N).numpy()
    assert _rel(dt, dj) <= 1e-13
    assert np.array_equal(ta.to_scipy(tA).toarray(), dt)


def test_six_values_per_node():
    """block=6 (a shell-like node block) on a random symmetric element
    matrix: the same structure and values as tpufem."""
    _, conn = meshgen.grid_quad(3, 2)
    N = int(conn.max()) + 1
    rng = np.random.default_rng(3)
    Ke = rng.standard_normal((conn.shape[0], 24, 24))
    Ke = Ke + Ke.transpose(0, 2, 1)
    js = ja.build_bsr_structure(conn, N, block=6)
    ts = ta.build_bsr_structure(conn, N, block=6, device="cpu")
    assert np.array_equal(np.asarray(js.perm), ts.perm.numpy())
    jA = ja.assemble_bsr(jnp.asarray(Ke), 4, js)
    tA = ta.assemble_bsr(torch.from_numpy(Ke), 4, ts)
    x = rng.standard_normal((N, 6))
    assert _rel(tA(torch.from_numpy(x)).numpy(),
                ja.bsr_matvec(jA, jnp.asarray(x))) <= 1e-13
    assert _rel(tA.diagonal().numpy(), jA.diagonal()) <= 1e-13
