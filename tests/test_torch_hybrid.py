"""tpufem_torch's Schur substructuring against tpufem's solvers/hybrid.py.

box_tet(3, 3, 4) c3d4 over a 1 x 1 x 1.3 box (E = 200, nu = 0.3), z = 0
fixed, a load in x and z on the top face, four parts from the same
region-growing partition, f64; four builds in both packages: Jacobi, NN,
BDD with slim + interior_inverse + matrix_free_gg, and Jacobi with the
same three flags.

* bitwise: the index tables (gmap, gmask, imap, imask, g_nodes,
  scat_perm, scat_seg) and meta;
* within 1e-12 relative (max-norm): chol, K_IG, K_GG, Kinv, S, Sinv,
  Zloc, Echol, Minv_G, Dw, gfree, and schur_matvec and apply_M on a
  seeded vector;
* solve (tol 1e-6 absolute, ||g|| about 6.8): the same status and
  iteration count (NN: within one), the first ten history entries within
  1e-10 relative (later ones part: NN's near-singular floating-part
  inverses amplify the operators' 1e-16 differences about tenfold an
  iteration), the displacement within 1e-8 relative;
* solve_chunked against tpufem's (every 7: the same count, displacement
  within 1e-8) and against solve; hybrid_solve; one part against a dense
  direct solve (1e-8); the slim + Jacobi ValueError; and
  solve_chunked(max_iter=0), which returns the initial state here where
  tpufem raises AttributeError (a difference kept on purpose);
* a float32 BDD build: its K_IG, Kinv and Minv_G bitwise the float64
  build's rounded to float32, its solve within 5e-6 of tpufem's f64
  displacement;
* parts of several face-connected pieces (box_tet(3), 8 RCB parts: six
  parts of two or three pieces): the port's BDD basis has six modes per
  piece (tpufem's, six per part, where each part is one piece) and its
  interface CG takes 16 iterations to tpufem's 48 at tol 1e-8, to the
  same displacement within 1e-8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.solvers import hybrid as jh
from tpufem.utils import meshgen

from tpufem_torch import assemble_dense, solid
from tpufem_torch.solvers import hybrid as th
from tpufem_torch.solvers.cg import CONVERGED, MAX_ITER

E, NU, PARTS, TOL = 200.0, 0.3, 4, 1e-6
CONFIGS = {
    "jacobi": {},
    "nn": dict(precondition="nn"),
    "bdd_slim": dict(precondition="bdd", slim=True, interior_inverse=True,
                     matrix_free_gg=True),
    "jacobi_mf": dict(slim=True, interior_inverse=True,
                      matrix_free_gg=True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small
    (and MKL's batched float64 LU can stall under several threads)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def mesh():
    coords, conn = meshgen.box_tet(3, 3, 4, 1.0, 1.0, 1.3)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    top = meshgen.boundary_nodes(coords, 2, 1.3)
    b = np.zeros((N, 3))
    b[top, 0] = 1.0
    b[top, 2] = -0.5
    return coords, conn, fixed, b


_BUILDS = {}


def _pair(mesh, name):
    """(config, tpufem's system, the port's, tpufem's solve, the port's),
    built once per config."""
    if name not in _BUILDS:
        coords, conn, fixed, b = mesh
        kw = CONFIGS[name]
        js = jh.build_hybrid(coords, conn, "c3d4", E, NU, PARTS,
                             fixed_nodes=fixed, **kw)
        ts = th.build_hybrid(coords, conn, "c3d4", E, NU, PARTS,
                             fixed_nodes=fixed, device="cpu", **kw)
        jsol = jax.jit(lambda sy, f: sy.solve(f, tol=TOL, max_iter=300))(
            js, jnp.asarray(b))
        _BUILDS[name] = (name, js, ts, jsol, ts.solve(b, tol=TOL,
                                                      max_iter=300))
    return _BUILDS[name]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request, mesh):
    return _pair(mesh, request.param)


def test_tables_bitwise(pair):
    _, js, ts, _, _ = pair
    for name in ("gmap", "gmask", "imap", "imask", "g_nodes", "scat_perm",
                 "scat_seg"):
        a, b = np.asarray(getattr(js, name)), np.asarray(getattr(ts, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for f in ("n_parts", "n_nodes", "n_interface", "nI_max", "nG_max"):
        assert getattr(ts.meta, f) == getattr(js.meta, f), f


def test_blocks(pair):
    _, js, ts, _, _ = pair
    for name in ("chol", "K_IG", "K_GG", "Kinv", "S", "Sinv", "Zloc",
                 "Echol", "Minv_G", "Dw", "gfree", "mf_free"):
        a, b = getattr(js, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert tuple(b.shape) == tuple(a.shape), name
            assert _rel(b.numpy(), a) <= 1e-12, name
    x = np.random.default_rng(5).standard_normal((ts.meta.n_interface, 3))
    for fn in ("schur_matvec", "apply_M"):
        want = jax.jit(lambda sy, v: getattr(sy, fn)(v))(js, jnp.asarray(x))
        assert _rel(getattr(ts, fn)(torch.from_numpy(x)).numpy(),
                    want) <= 1e-12, fn


def test_solve(pair):
    name, _, _, (uj, ij), (ut, it) = pair
    assert int(it.status) == int(ij.status) == CONVERGED
    assert abs(int(it.iterations) - int(ij.iterations)) <= (name == "nn")
    hj, ht = np.asarray(ij.history), it.history.numpy()
    assert ht.shape == hj.shape
    assert np.all(np.abs(ht[:10] - hj[:10]) <= 1e-10 * hj[:10])
    assert ht[int(it.iterations)] < TOL
    assert _rel(ut.numpy(), uj) <= 1e-8
    last = ht[int(it.iterations)]
    assert abs(float(it.residual_norm) - last) <= 1e-12 * last


@pytest.mark.parametrize("name", ["jacobi", "bdd_slim"])
def test_solve_chunked(mesh, name):
    _, js, ts, _, (us, _) = _pair(mesh, name)
    b = mesh[3]
    uj, ij = js.solve_chunked(jnp.asarray(b), tol=TOL, max_iter=300,
                              every=7)
    seen = []
    ut, it = ts.solve_chunked(b, tol=TOL, max_iter=300, every=7,
                              progress=lambda d, r: seen.append(d))
    assert int(it.status) == int(ij.status) == CONVERGED
    assert int(it.iterations) == int(ij.iterations) == seen[-1]
    assert it.history.shape == np.asarray(ij.history).shape
    assert _rel(ut.numpy(), uj) <= 1e-8
    assert _rel(ut.numpy(), us.numpy()) <= 1e-8


def test_hybrid_solve(mesh):
    """hybrid_solve (build + solve, fixed rows zeroed) gives the solve of
    the same build."""
    coords, conn, fixed, b = mesh
    _, _, _, (uj, ij), _ = _pair(mesh, "jacobi")
    bb = b.copy()
    bb[fixed] = 7.0                    # zeroed by hybrid_solve
    u, info = th.hybrid_solve(coords, conn, "c3d4", E, NU, bb, PARTS,
                              fixed_nodes=fixed, tol=TOL, max_iter=300,
                              device="cpu")
    assert int(info.iterations) == int(ij.iterations)
    assert _rel(u.numpy(), uj) <= 1e-8


def test_single_part_is_direct(mesh):
    """One part: every free node is interior, the interface CG has the
    fixed nodes alone, and u is the direct solve's."""
    coords, conn, fixed, b = mesh
    N = coords.shape[0]
    u, info = th.hybrid_solve(coords, conn, "c3d4", E, NU, b, 1,
                              fixed_nodes=fixed, tol=1e-12, max_iter=50,
                              device="cpu")
    K = solid.stiffness(torch.from_numpy(coords), torch.from_numpy(conn),
                        "c3d4", E, NU)
    A = assemble_dense(K, conn, N).numpy()
    free = np.ones((N, 3), bool)
    free[fixed] = False
    free = free.reshape(-1)
    ref = np.zeros(3 * N)
    ref[free] = np.linalg.solve(A[np.ix_(free, free)], b.reshape(-1)[free])
    assert int(info.iterations) <= 1
    assert _rel(u.numpy().reshape(-1), ref) <= 1e-8


def test_slim_jacobi_needs_matrix_free(mesh):
    coords, conn, fixed, _ = mesh
    with pytest.raises(ValueError):
        th.build_hybrid(coords, conn, "c3d4", E, NU, PARTS,
                        fixed_nodes=fixed, slim=True, device="cpu")


def test_max_iter_zero(mesh):
    """solve_chunked(max_iter=0): the initial state, status MAX_ITER and 0
    iterations, where tpufem's loop leaves its info unset and raises."""
    b = mesh[3]
    _, js, ts, _, _ = _pair(mesh, "jacobi")
    with pytest.raises(AttributeError):
        js.solve_chunked(jnp.asarray(b), tol=TOL, max_iter=0)
    u, info = ts.solve_chunked(b, tol=TOL, max_iter=0)
    fIp, g = ts._condense(ts._force(b))
    assert int(info.status) == MAX_ITER and int(info.iterations) == 0
    assert np.allclose(info.history, [float(torch.linalg.norm(g))],
                       rtol=1e-15)
    assert torch.equal(u, ts._backsub(fIp, ts._force(b),
                                      torch.zeros_like(g)))


def test_bdd_pieces():
    """Six rigid modes per face-connected piece: where RCB leaves parts in
    pieces, the BDD solve converges in fewer iterations than tpufem's and
    to its displacement."""
    from tpufem.parallel.partition import rcb_partition
    coords, conn = meshgen.box_tet(3, 3, 3)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 1.0
    b[fixed] = 0.0
    labels = rcb_partition(coords, conn, 8)
    kw = dict(fixed_nodes=fixed, labels=labels, precondition="bdd")
    js = jh.build_hybrid(coords, conn, "c3d4", E, NU, 8, **kw)
    ts = th.build_hybrid(coords, conn, "c3d4", E, NU, 8, device="cpu", **kw)
    pieces = th._part_pieces(conn, "c3d4", labels, 8)[1]
    assert pieces.max() == 3 and (pieces > 1).sum() == 6
    assert ts.Zloc.shape[2] == 18 and ts.zcols.numel() == 6 * pieces.sum()
    uj, ij = jax.jit(lambda sy, f: sy.solve(f, tol=1e-8, max_iter=500))(
        js, jnp.asarray(b))
    ut, it = ts.solve(b, tol=1e-8, max_iter=500)
    assert int(it.status) == int(ij.status) == CONVERGED
    assert 2 * int(it.iterations) <= int(ij.iterations)       # 16 and 48
    assert _rel(ut.numpy(), uj) <= 1e-8


def test_float32_build(mesh):
    """A float32 build stores the float32 rounding of the float64 build's
    blocks (the element K, the blocks and K_II^-1 are formed in float64),
    and its BDD solve lands within 5e-6 of tpufem's f64 displacement
    (1.2e-6 here; the float32 rounding of the solution is 3.7e-8)."""
    coords, conn, fixed, b = mesh
    _, _, ts, (uj, _), _ = _pair(mesh, "bdd_slim")
    sys32 = th.build_hybrid(coords, conn, "c3d4", E, NU, PARTS,
                            fixed_nodes=fixed, dtype=torch.float32,
                            device="cpu", **CONFIGS["bdd_slim"])
    for name in ("K_IG", "Kinv", "Minv_G"):
        got, want = getattr(sys32, name), getattr(ts, name)
        assert got.dtype == torch.float32, name
        assert torch.equal(got, want.float()), name
    g = sys32._condense(sys32._force(b))[1]
    u, info = sys32.solve(b.astype(np.float32),
                          tol=1e-6 * float(torch.linalg.norm(g)),
                          max_iter=300)
    assert int(info.status) == CONVERGED
    assert u.dtype == torch.float32 and _rel(u.numpy(), uj) <= 5e-6


def test_bench_hybrid_flow_on_cpu():
    """scripts/bench_hybrid's flow at box_tet(4) in 4 RCB parts (f32, BDD,
    slim, inverse, matrix-free) on the CPU: one chunk (every = max_iter),
    two solves with equal histories, CONVERGED, and the displacement
    within 1e-4 of the refined packed reference (f64 true residual 1e-6)."""
    from tpufem_torch.scripts import bench_hybrid
    out, system, u, u_ref = bench_hybrid.run(
        4, 4, "rcb", "bdd", tol_rel=1e-7, max_iter=200, ref="refined",
        ref_tol_rel=1e-6, solves=2, device="cpu", log=lambda *a: None)
    assert out["every"] == 200
    assert out["n_interface"] == system.meta.n_interface
    h = [r["history"] for r in out["solves"]]
    assert np.array_equal(h[0], h[1])
    assert all(r["status"] == CONVERGED for r in out["solves"])
    assert out["reference"]["rel_residual"] <= 1e-6
    assert out["reference"]["rel_displacement_diff"] <= 1e-4
    assert u.dtype == torch.float32 and tuple(u.shape) == tuple(u_ref.shape)
