"""tpufem_torch's solid elements and its stiffness kernel K6 against tpufem.

Small curved meshes of the four types the fused stiffness kernel takes
(c3d4, c3d10, c3d8, c3d6), the same float64 inputs to both packages:

* volumes, stiffness_bmat, stiffness_isotropic, stiffness_per_ip, mass,
  lumped_mass, element_stress and node_vm_stress agree to <= 1e-12
  relative (max-norm);
* the plain K6 (stiffness_fused_plain, the router's CPU path) matches
  tpufem's Pallas kernel in interpret mode on c3d4 to <= 1e-12 in f64,
  and to <= 1e-6 relative in f32: XLA's CPU compiler contracts and
  reorders some of the interpret-mode arithmetic (FMA), so the f32
  roundings differ (2e-7 measured);
* on c3d4, c3d10 and c3d8 it matches tpufem's Pallas kernel function run
  eagerly on the block pallas_call would give it, to the same
  tolerances (bitwise, measured): an interpret-mode call of the unrolled
  c3d10 or c3d8 kernel takes 120-140 s on the CPU;
* for c3d10, c3d8 and c3d6 the plain K6 matches tpufem's B^T D B pipeline
  (the same K, other arithmetic) to <= 1e-12 in f64, as tpufem's own
  tests hold its kernel against that pipeline.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.core import voigt as j_voigt
from tpufem.core.materials import elasticity_matrix, lame_parameters
from tpufem.elements import solid as js
from tpufem.ops import stiffness_kernels as jsk
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.core import voigt as t_voigt
from tpufem_torch.elements import solid as ts
from tpufem_torch.ops import stiffness_kernels as tsk

E, NU, RHO = 200e9, 0.3, 7800.0
MESHES = {"c3d4": ("box_tet", (2, 2, 2)), "c3d10": ("box_tet10", (2, 2, 2)),
          "c3d8": ("box_hex", (2, 2, 3)), "c3d6": ("box_wedge", (2, 2, 2))}
TYPES = list(MESHES)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curved(etype):
    gen, dims = MESHES[etype]
    coords, conn = getattr(meshgen, gen)(*dims)
    c = coords.copy()
    c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
    c[:, 1] += 0.03 * np.cos(1.0 + c[:, 2]) * c[:, 0]
    return c, conn


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=TYPES)
def mesh(request):
    etype = request.param
    c, conn = _curved(etype)
    rng = np.random.default_rng(7)
    u = rng.standard_normal((c.shape[0], 3)) * 1e-3
    return dict(etype=etype, c=c, conn=conn, u=u,
                cj=jnp.asarray(c), connj=jnp.asarray(conn),
                ct=torch.from_numpy(c), connt=torch.from_numpy(conn))


def test_meshgen_box_wedge_bitwise():
    a = meshgen.box_wedge(3, 2, 4, 1.0, 2.0, 0.5)
    b = tpufem_torch.meshgen.box_wedge(3, 2, 4, 1.0, 2.0, 0.5)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_voigt():
    s = np.random.default_rng(0).standard_normal((5, 4, 6))
    T = t_voigt.stress_tensor(torch.from_numpy(s))
    assert np.array_equal(T.numpy(), np.asarray(j_voigt.stress_tensor(
        jnp.asarray(s))))
    for x in (torch.from_numpy(s), T):
        want = np.asarray(j_voigt.von_mises(jnp.asarray(x.numpy())))
        assert _rel(t_voigt.von_mises(x), want) <= 1e-14


@pytest.mark.parametrize("fn", ["volumes", "stiffness_bmat",
                                "stiffness_isotropic", "stiffness_per_ip",
                                "mass", "lumped_mass"])
def test_element_matrices_f64(mesh, fn):
    et = mesh["etype"]
    D = elasticity_matrix(E, NU)
    calls = {
        "volumes": lambda m, c, e: m.volumes(c, e, etype=et),
        "stiffness_bmat": lambda m, c, e: m.stiffness_bmat(c, e, et, D),
        "stiffness_isotropic": lambda m, c, e: m.stiffness_isotropic(
            c, e, et, E, NU),
        "stiffness_per_ip": lambda m, c, e: m.stiffness_per_ip(
            c, e, et, E, NU),
        "mass": lambda m, c, e: m.mass(c, e, et, RHO),
        "lumped_mass": lambda m, c, e: m.lumped_mass(c, e, et, RHO),
    }
    want = calls[fn](js, mesh["cj"], mesh["connj"])
    got = calls[fn](ts, mesh["ct"], mesh["connt"])
    assert got.dtype == torch.float64
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("single", [True, False], ids=["avg", "per_ip"])
def test_stress_recovery_f64(mesh, single):
    et, N = mesh["etype"], mesh["c"].shape[0]
    tj, vj = js.element_stress(mesh["cj"], mesh["connj"],
                               jnp.asarray(mesh["u"]), et, E, NU,
                               single=single)
    tt, vt = ts.element_stress(mesh["ct"], mesh["connt"],
                               torch.from_numpy(mesh["u"]), et, E, NU,
                               single=single)
    assert _rel(tt, tj) <= 1e-12 and _rel(vt, vj) <= 1e-12
    if single:
        nj = js.node_vm_stress(N, mesh["connj"], vj)
        nt = ts.node_vm_stress(N, mesh["connt"], vt)
        assert _rel(nt, nj) <= 1e-12


def test_stiffness_router_takes_plain_k6_on_cpu(mesh):
    """solid.stiffness on a CPU tensor is the plain K6 (bitwise), and it
    equals tpufem's B^T D B pipeline (the same K) to 1e-12 in f64."""
    et = mesh["etype"]
    got = ts.stiffness(mesh["ct"], mesh["connt"], et, E, NU)
    plain = tsk.stiffness_fused_plain(mesh["ct"], mesh["connt"], et, E, NU)
    assert torch.equal(got, plain)
    want = js.stiffness_bmat(mesh["cj"], mesh["connj"], et,
                             elasticity_matrix(E, NU))
    assert _rel(got, want) <= 1e-12
    # numpy connectivity, and a B^T D B route for a custom rule
    assert torch.equal(tsk.stiffness_fused(mesh["ct"], mesh["conn"], et, E,
                                           NU), plain)
    full = ts.stiffness(mesh["ct"], mesh["connt"], et, E, NU, rule="full")
    want = js.stiffness(mesh["cj"], mesh["connj"], et, E, NU, rule="full")
    assert _rel(full, want) <= 1e-12


class _Ref:
    """A Pallas ref over a numpy buffer: a read gives a jnp array, a write
    stores into the buffer."""

    def __init__(self, a):
        self.a, self.dtype = a, a.dtype

    def __getitem__(self, i):
        return jnp.asarray(self.a[i])

    def __setitem__(self, i, v):
        self.a[i] = np.asarray(v)


def _k6_kernel_body(c, conn, etype):
    """tpufem's Pallas K6 kernel function (_stiffness_kernel) run eagerly,
    op by op, on the one [3k, 1, 8, 128] block that stiffness_fused hands
    its pallas_call for M <= 1024 (element 0 in the padded slots), and its
    output laid out as stiffness_fused lays it out: K [M, 3k, 3k]."""
    tab = js.element_table(etype)
    lam, mu = lame_parameters(E, NU)
    M, k = conn.shape
    S, L = 8, 128
    assert M <= S * L
    Xe = c[conn]
    Xe = np.concatenate([Xe, np.broadcast_to(Xe[:1], (S * L - M, k, 3))])
    xe = np.ascontiguousarray(Xe.reshape(S * L, 3 * k).T).reshape(
        3 * k, 1, S, L)
    d = 3 * k
    out = np.zeros((d * d, 1, S, L), c.dtype)
    jsk._stiffness_kernel(_Ref(xe), _Ref(out), S=S, L=L, k=k,
                          dN=np.asarray(tab.dN), w=np.asarray(tab.weights),
                          lam=float(lam), mu=float(mu))
    return out.reshape(d * d, S * L).T[:M].reshape(M, d, d)


@pytest.mark.parametrize("etype,np_dt,t_dt,tol", [
    ("c3d4", np.float64, torch.float64, 1e-12),
    ("c3d4", np.float32, torch.float32, 1e-6),
    ("c3d10", np.float64, torch.float64, 1e-12),
    ("c3d10", np.float32, torch.float32, 1e-6),
    ("c3d8", np.float64, torch.float64, 1e-12),
    ("c3d8", np.float32, torch.float32, 1e-6)],
    ids=["f64", "f32", "c3d10-f64", "c3d10-f32", "c3d8-f64", "c3d8-f32"])
def test_stiffness_fused_plain_vs_interpret(etype, np_dt, t_dt, tol):
    """The plain K6 against tpufem's Pallas K6 per dtype.  c3d4: one
    interpret-mode call, and tpufem's kernel function run eagerly
    (_k6_kernel_body) against it.  c3d10, c3d8: the kernel function run
    eagerly alone, since an interpret-mode call of their unrolled kernel
    takes 120-140 s on the CPU, ~24 s of it lowering, whatever the mesh
    size.  Eager, op by op, no compiler contracts or reorders the
    arithmetic, so the eager kernel agrees with the plain K6 bitwise in
    both types (measured); the tolerances are the interpret-mode ones."""
    c, conn = _curved(etype)
    c = c.astype(np_dt)
    got = tsk.stiffness_fused_plain(torch.from_numpy(c), conn, etype, E, NU)
    assert got.dtype == t_dt
    body = _k6_kernel_body(c, conn, etype)
    assert _rel(got, body) <= tol
    if etype == "c3d4":
        want = jsk.stiffness_fused(jnp.asarray(c), conn, "c3d4", E, NU,
                                   interpret=True)
        assert _rel(got, want) <= tol
        assert _rel(body, want) <= tol


def test_stiffness_fused_checks():
    c, conn = _curved("c3d4")
    with pytest.raises(ValueError):
        tsk.stiffness_fused(torch.from_numpy(c), conn[:, :3], "c3d4", E, NU)
    c20, conn20 = meshgen.hex8_to_hex20(*meshgen.box_hex(1, 1, 1))
    with pytest.raises(ValueError, match="built for"):
        tsk.stiffness_fused(torch.from_numpy(c20), conn20, "c3d20", E, NU)
    # k > 10 goes to B^T D B
    K = ts.stiffness(torch.from_numpy(c20), torch.from_numpy(conn20),
                     "c3d20", E, NU)
    want = js.stiffness(jnp.asarray(c20), jnp.asarray(conn20), "c3d20", E, NU)
    assert _rel(K, want) <= 1e-12


def test_b_matrix_from_gradients():
    c, conn = _curved("c3d10")
    tab = tpufem_torch.element_table("c3d10")
    g, _ = ts.shape_gradients(torch.from_numpy(c), torch.from_numpy(conn),
                              tab)
    gj, _ = js.shape_gradients(jnp.asarray(c), jnp.asarray(conn),
                               js.element_table("c3d10"))
    assert _rel(g, gj) <= 1e-12
    assert np.array_equal(ts.b_matrix_from_gradients(g).numpy(),
                          np.asarray(js.b_matrix_from_gradients(
                              jnp.asarray(g.numpy()))))
    assert np.array_equal(ts._packed_b_coeffs(tab),
                          js._packed_b_coeffs(js.element_table("c3d10")))
