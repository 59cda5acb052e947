"""tpufem_torch's Kirchhoff shells, element dispatch, conversions and shell
grids against tpufem's.

kirchhoff_D_matrix, the conversions of topology.convert and the s3/s4
grids are host numpy copies: bitwise.  The shell frames, stiffness, NMQ
stress, nodal forces, assembled diagonal and postprocessed stresses run
in f64 on a perturbed 4 x 4 grid (so that the frames are not the global
axes) and agree to 1e-12 relative (max-norm).  The dispatch wrappers
agree with tpufem's to 1e-12 relative in f64 (the stiffness through the
fused kernel's plain version on the CPU, tpufem's through XLA).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.core import materials as j_materials
from tpufem.elements import dispatch as j_dispatch
from tpufem.elements import shell as j_shell
from tpufem.ops.scatter import ScatterPlan as JScatterPlan
from tpufem.topology import convert as j_convert
from tpufem.utils import meshgen as j_meshgen

import tpufem_torch
from tpufem_torch.core import materials as t_materials
from tpufem_torch.elements import dispatch as t_dispatch
from tpufem_torch.elements import shell as t_shell
from tpufem_torch.topology import convert as t_convert
from tpufem_torch.utils import meshgen as t_meshgen

MEMBRANE, BENDING = (200.0, 0.3, 0.05), (210.0, 0.28, 0.04)
TOL = 1e-12



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
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module", params=["s3", "s4"])
def plate(request):
    gen = t_meshgen.grid_tri if request.param == "s3" else t_meshgen.grid_quad
    coords, conn = gen(4, 4, 1.0, 0.8)
    rng = np.random.default_rng(11)
    coords = coords + 0.04 * rng.standard_normal(coords.shape)
    u = rng.standard_normal((coords.shape[0], 6))
    return request.param, coords, conn, u


def test_kirchhoff_D_bitwise():
    for m, b in ((MEMBRANE, BENDING), ((1.0, 0.0, 1.0), (70e9, 0.33, 2e-3))):
        D1 = j_materials.kirchhoff_D_matrix(m, b)
        D2 = t_materials.kirchhoff_D_matrix(m, b)
        assert D1.dtype == D2.dtype and np.array_equal(D1, D2)
        assert np.array_equal(tpufem_torch.kirchhoff_D_matrix(m, b), D1)


def _shell_ref(coords, conn, u):
    """tpufem's shell functions on one input, in one jitted program (its
    eager dispatch would compile each op on its own)."""
    N = coords.shape[0]
    plan = JScatterPlan.build(conn, N, 6)

    def ref(cj, uj):
        ej = jnp.asarray(conn)
        unit = j_shell.local_frames(cj, ej)
        K = j_shell.shell_stiffness(cj, ej, MEMBRANE, BENDING)
        S = j_shell.shell_stress(cj, ej, MEMBRANE, BENDING, uj)
        op = j_shell.ShellOperator(K=K, unit=unit, plan=plan)
        return dict(
            unit=unit, xyz=j_shell.local_coordinates(cj, ej, unit),
            normals=j_shell.shell_normals(cj, ej), K=K, S=S,
            F=j_shell.shell_nodal_forces(K, plan, uj, unit), op=op(uj),
            diag=op.diagonal(), ediag=j_shell.shell_operator_diagonal(K, unit),
            post=[j_shell.shell_postprocess_values(S, 0.05, z)
                  for z in (0.0, 0.02)])

    return jax.jit(ref)(jnp.asarray(coords), jnp.asarray(u))


def test_shell_kernels_match_tpufem(plate):
    """Frames, local coordinates, normals, K, stress, nodal forces, the
    operator's diagonal and the postprocessed stresses, f64, 1e-12."""
    etype, coords, conn, u = plate
    N = coords.shape[0]
    j = _shell_ref(coords, conn, u)
    ct, et, ut = torch.tensor(coords), torch.tensor(conn), torch.tensor(u)
    unit_t = t_shell.local_frames(ct, et)
    assert _rel(unit_t, j["unit"]) <= TOL
    assert _rel(t_shell.local_coordinates(ct, et, unit_t), j["xyz"]) <= TOL
    assert _rel(t_shell.shell_normals(ct, et), j["normals"]) <= TOL
    Kt = t_shell.shell_stiffness(ct, et, MEMBRANE, BENDING)
    assert Kt.shape == j["K"].shape == (conn.shape[0], 6 * conn.shape[1],
                                        6 * conn.shape[1])
    assert _rel(Kt, j["K"]) <= TOL
    St = t_shell.shell_stress(ct, et, MEMBRANE, BENDING, ut)
    assert _rel(St, j["S"]) <= TOL
    assert _rel(t_shell.shell_nodal_forces(Kt, et, ut, unit_t),
                j["F"]) <= TOL
    opt = tpufem_torch.ShellOperator(
        Kt, unit_t, tpufem_torch.ScatterPlan.build(conn, N, 6, device="cpu"))
    assert _rel(opt(ut), j["op"]) <= TOL
    assert _rel(opt.diagonal(), j["diag"]) <= TOL
    assert _rel(t_shell.shell_operator_diagonal(Kt, unit_t),
                j["ediag"]) <= TOL
    for z, pj in zip((0.0, 0.02), j["post"]):
        pt = t_shell.shell_postprocess_values(St, 0.05, z)
        assert set(pt) == set(pj)
        for k in pj:
            assert _rel(pt[k], pj[k]) <= TOL, k


@pytest.mark.parametrize("etype", ["c3d4", "c3d10"])
def test_dispatch_matches_tpufem(etype):
    coords, conn = j_meshgen.box_tet(2, 2, 2)
    if etype == "c3d10":
        coords, conn = j_meshgen.tet4_to_tet10(coords, conn)
    coords = coords + 0.02 * np.sin(3.0 * coords[:, [1, 2, 0]])
    u = np.random.default_rng(5).standard_normal((coords.shape[0], 3))
    E, nu = 200.0, 0.3
    kw = dict(device="cpu")
    pts_j, w_j = j_dispatch.integral_points(etype)
    pts_t, w_t = t_dispatch.integral_points(etype)
    assert np.array_equal(pts_j, pts_t) and np.array_equal(w_j, w_t)
    D = j_materials.elasticity_matrix(E, 0.25)

    def ref(c, uu):
        """tpufem's wrappers in one jitted program."""
        d = j_dispatch
        return [d.compute_jacobian(c, conn, etype),
                d.compute_B_matrix(c, conn, etype),
                d.compute_K_matrix(c, conn, etype, E, nu),
                d.compute_K_matrix(c, conn, etype, E, nu, single=False),
                d.compute_K_matrix(c, conn, etype, E, nu, D=D),
                d.compute_volumes(c, conn, etype),
                d.compute_M_matrix(c, conn, etype, 7.8),
                d.compute_M_matrix(c, conn, etype, 7.8, lumped=True),
                *d.compute_shape_gradients(c, conn, etype),
                *d.compute_element_stress(c, conn, uu, E, nu, etype)]

    want = jax.jit(ref)(jnp.asarray(coords), jnp.asarray(u))
    got = [t_dispatch.compute_jacobian(coords, conn, etype, **kw),
           t_dispatch.compute_B_matrix(coords, conn, etype, **kw),
           t_dispatch.compute_K_matrix(coords, conn, etype, E, nu, **kw),
           t_dispatch.compute_K_matrix(coords, conn, etype, E, nu,
                                       single=False, **kw),
           t_dispatch.compute_K_matrix(coords, conn, etype, E, nu, D=D,
                                       **kw),
           t_dispatch.compute_volumes(coords, conn, etype, **kw),
           t_dispatch.compute_M_matrix(coords, conn, etype, 7.8, **kw),
           t_dispatch.compute_M_matrix(coords, conn, etype, 7.8, lumped=True,
                                       **kw),
           *t_dispatch.compute_shape_gradients(coords, conn, etype, **kw),
           *t_dispatch.compute_element_stress(coords, conn, u, E, nu, etype,
                                              **kw)]
    pairs = list(zip(got, want))
    for i, (t, j) in enumerate(pairs):
        assert tuple(t.shape) == tuple(np.shape(j)), i
        assert _rel(t, j) <= TOL, i
    with pytest.raises(ValueError):
        t_dispatch.compute_K_matrix(coords, conn[:, :4], "s4", E, nu, **kw)


def test_convert_bitwise():
    coords, tets = j_meshgen.box_tet(2, 2, 1)
    _, hexes = j_meshgen.box_hex(2, 1, 2)
    hc, _ = j_meshgen.box_hex(2, 1, 2)
    wc, wedges = j_meshgen.box_wedge(1, 2, 2)
    rbe2, rbe3 = np.arange(0, 9), np.arange(5, 14)
    cases = [
        (j_convert.to_c3d4(hexes), t_convert.to_c3d4(hexes)),
        (j_convert.to_c3d4(wedges), t_convert.to_c3d4(wedges)),
        (j_convert.c3d4_to_c3d10(coords, tets, rbe2, rbe3),
         t_convert.c3d4_to_c3d10(coords, tets, rbe2, rbe3)),
        (j_convert.to_2nd_order(hc, hexes, "c3d8"),
         t_dispatch.to_2nd_order(hc, hexes, "c3d8")),
        (j_convert.to_2nd_order(wc, wedges, "c3d6"),
         t_dispatch.to_2nd_order(wc, wedges, "c3d6")),
        (j_convert.shell_extrude(*j_meshgen.grid_quad(3, 2)[:1],
                                 quad=j_meshgen.grid_quad(3, 2)[1],
                                 thickness=0.1),
         t_convert.shell_extrude(*t_meshgen.grid_quad(3, 2)[:1],
                                 quad=t_meshgen.grid_quad(3, 2)[1],
                                 thickness=0.1)),
        (j_convert.shell_extrude(j_meshgen.grid_tri(2, 2)[0],
                                 tri=j_meshgen.grid_tri(2, 2)[1]),
         t_convert.shell_extrude(t_meshgen.grid_tri(2, 2)[0],
                                 tri=t_meshgen.grid_tri(2, 2)[1])),
    ]
    c10 = t_convert.to_c3d4(j_convert.c3d4_to_c3d10(coords, tets)[1])
    cases.append((j_convert.to_c3d4(j_convert.c3d4_to_c3d10(coords, tets)[1]),
                  c10))
    for i, (a, b) in enumerate(cases):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        assert len(a) == len(b), i
        for x, y in zip(a, b):
            assert np.asarray(x).dtype == np.asarray(y).dtype, i
            assert np.array_equal(x, y), i


@pytest.mark.parametrize("gen,dims", [
    ("grid_quad", (3, 4)), ("grid_quad", (5, 2, 2.0, 0.5, 0.3)),
    ("grid_tri", (4, 3)), ("hex8_to_hex20", None),
    ("wedge6_to_wedge15", None)])
def test_grids_bitwise(gen, dims):
    if dims is None:
        src = "box_hex" if gen == "hex8_to_hex20" else "box_wedge"
        args = getattr(j_meshgen, src)(2, 3, 2)
        a, b = getattr(j_meshgen, gen)(*args), getattr(t_meshgen, gen)(*args)
    else:
        a, b = getattr(j_meshgen, gen)(*dims), getattr(t_meshgen, gen)(*dims)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
