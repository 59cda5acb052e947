"""tpufem_torch host modules against tpufem: element tables, materials,
box meshes, fixed-node constraints and the native plan-build engine, all
bitwise; and the port's import isolation from JAX and tpufem."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpufem.core import materials as j_materials
from tpufem.solvers import constraints as j_constraints
from tpufem.elements import tables as j_tables
import tpufem.native as j_native
from tpufem.utils import meshgen as j_meshgen

from tpufem_torch.core import materials as t_materials
from tpufem_torch.solvers import constraints as t_constraints
from tpufem_torch.elements import tables as t_tables
import tpufem_torch.native as t_native
from tpufem_torch.utils import meshgen as t_meshgen

_RULES = [(et, r) for et in ("c3d4", "c3d10", "c3d8", "c3d20", "c3d6",
                             "c3d15", "s3", "s4", "c3d8i")
          for r in ("default", "reduced", "full", "mass")] + [("c3d10",
                                                               "ref11")]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("etype,rule", _RULES)
def test_element_tables_bitwise(etype, rule):
    a = j_tables.element_table(etype, rule)
    b = t_tables.element_table(etype, rule)
    assert a.etype == b.etype and a.n_nodes == b.n_nodes
    for name in ("points", "weights", "N", "dN"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_materials_bitwise():
    for E, nu in ((200e9, 0.3), (70e9, 0.33), (1.0, 0.0)):
        assert j_materials.lame_parameters(E, nu) == \
            t_materials.lame_parameters(E, nu)
        assert np.array_equal(j_materials.elasticity_matrix(E, nu),
                              t_materials.elasticity_matrix(E, nu))


@pytest.mark.parametrize("gen,dims", [
    ("box_hex", (3, 4, 5)), ("box_tet", (3, 2, 4)),
    ("box_tet10", (3, 3, 3)), ("box_tet10", (4, 5, 6, 2.0, 1.0, 0.5)),
])
def test_meshgen_bitwise(gen, dims):
    c1, e1 = getattr(j_meshgen, gen)(*dims)
    c2, e2 = getattr(t_meshgen, gen)(*dims)
    assert c1.dtype == c2.dtype and e1.dtype == e2.dtype
    assert np.array_equal(c1, c2) and np.array_equal(e1, e2)
    for axis, value in ((2, 0.0), (0, 0.0), (2, float(c1[:, 2].max()))):
        assert np.array_equal(j_meshgen.boundary_nodes(c1, axis, value),
                              t_meshgen.boundary_nodes(c2, axis, value))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fixed_constraints_bitwise(dtype):
    coords, _ = t_meshgen.box_tet10(3, 3, 3)
    fixed = t_meshgen.boundary_nodes(coords, 2, 0.0)
    a = j_constraints.Constraints.fixed(coords.shape[0], fixed, 3, dtype=dtype)
    b = t_constraints.Constraints.fixed(coords.shape[0], fixed, 3, dtype=dtype)
    for name in ("free_mask", "spc_dofs", "spc_values", "mask2d"):
        x, y = np.asarray(getattr(a, name)), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_native_engine_builds():
    assert t_native.available()


def test_native_entry_points_match_tpufem():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, 5000).astype(np.int32)
    assert np.array_equal(t_native.radix_argsort(keys),
                          j_native.radix_argsort(keys))
    k64 = rng.integers(0, 1 << 40, 5000)
    for a, b in zip(t_native.unique_inverse_i64(k64),
                    j_native.unique_inverse_i64(k64)):
        assert np.array_equal(a, b)
    flat = rng.integers(-1, 300, 4000).astype(np.int32)
    assert np.array_equal(t_native.first_touch(flat, 300),
                          j_native.first_touch(flat, 300))
    # a small real plan's intermediates drive the table-filling entry points
    coords, conn = t_meshgen.box_tet10(3, 3, 3)
    B, E_c, k = 8, 32, 10
    rows = np.full((B, E_c * k), -1, np.int32)
    rows.reshape(-1)[:conn.size] = conn.reshape(-1)[:B * E_c * k]
    rows[-1, 100:] = -1
    for a, b in zip(t_native.cluster_slots(rows), j_native.cluster_slots(rows)):
        assert np.array_equal(a, b)
    l2g, slot, _ = t_native.cluster_slots(rows)
    nb = int(l2g.max()) // 128 + 1
    for a, b in zip(t_native.cluster_windows(l2g, nb),
                    j_native.cluster_windows(l2g, nb)):
        assert np.array_equal(a, b)
    wc = t_native.block_windows_count(l2g, nb)
    assert np.array_equal(wc, j_native.block_windows_count(l2g, nb))
    bpos = rng.permutation(nb)
    cpos = rng.permutation(B)
    for a, b in zip(
            t_native.block_windows_fill_packed(l2g, nb, int(wc.max()),
                                               bpos, cpos),
            j_native.block_windows_fill_packed(l2g, nb, int(wc.max()),
                                               bpos, cpos)):
        assert np.array_equal(a, b)
    Rp = 384
    lconn = np.zeros((B, Rp), np.int32)
    lconn[:, :k * E_c] = slot.reshape(B, E_c, k).transpose(0, 2, 1).reshape(
        B, -1)
    ev = np.ones((B, E_c), bool)
    ev[-1, 10:] = False
    wid = t_native.cinc_widths(lconn, ev, k, E_c, 3)
    assert np.array_equal(wid, j_native.cinc_widths(lconn, ev, k, E_c, 3))
    ids = np.arange(2, 6)
    w = wid[ids].max(axis=0).astype(np.int64)
    voff = np.concatenate([[0], np.cumsum(w)[:-1]])
    Wp = -(-int(w.sum()) // 4)
    assert np.array_equal(
        t_native.cinc_fill_packed(lconn, ev, ids, k, E_c, 3, voff, Wp),
        j_native.cinc_fill_packed(lconn, ev, ids, k, E_c, 3, voff, Wp))


_ALL_MODULES = [
    "tpufem_torch", "tpufem_torch.core.device", "tpufem_torch.core.materials",
    "tpufem_torch.elements.tables", "tpufem_torch.elements.solid",
    "tpufem_torch.native", "tpufem_torch.utils.meshgen",
    "tpufem_torch.ops.cuda", "tpufem_torch.ops.packed",
    "tpufem_torch.ops.fused_kernels", "tpufem_torch.ops.packed_kernels",
    "tpufem_torch.ops.partial", "tpufem_torch.solvers.cg",
    "tpufem_torch.solvers.constraints", "tpufem_torch.solvers.refine",
    "tpufem_torch.core.voigt", "tpufem_torch.ops.stiffness_kernels",
    "tpufem_torch.ops.scatter", "tpufem_torch.ops.operator",
    "tpufem_torch.ops.cluster_kernels", "tpufem_torch.ops.clustered",
    "tpufem_torch.solvers.static", "tpufem_torch.ops.probe_fused",
    "tpufem_torch.ops.probe_kernels", "tpufem_torch.ops.probe_reshape",
    "tpufem_torch.ops.probe_rowdma", "tpufem_torch.ops.probe_planar_io",
    "tpufem_torch.scripts", "tpufem_torch.scripts.solve_scale",
    "tpufem_torch.scripts.modal_sweep",
    "tpufem_torch.examples", "tpufem_torch.examples.refined_solve",
    "tpufem_torch.elements.shell", "tpufem_torch.elements.dispatch",
    "tpufem_torch.topology", "tpufem_torch.topology.convert",
    "tpufem_torch.ops.packed_mixed", "tpufem_torch.solvers.bicgstab",
    "tpufem_torch.solvers.gmres", "tpufem_torch.solvers.newton",
    "tpufem_torch.solvers.modal", "tpufem_torch.solvers.legacy",
    "tpufem_torch.core.dtypes", "tpufem_torch.core.xmath",
    "tpufem_torch.topology.faces", "tpufem_torch.topology.edges",
    "tpufem_torch.topology.diagnostics", "tpufem_torch.parallel",
    "tpufem_torch.parallel.partition", "tpufem_torch.ops.assembly",
    "tpufem_torch.solvers.hybrid", "tpufem_torch.scripts.bench_hybrid",
    "tpufem_torch.examples.hybrid_subdomain",
    "tpufem_torch.io", "tpufem_torch.io.vtk", "tpufem_torch.io.h5",
    "tpufem_torch.viz", "tpufem_torch.viz.plot",
    "tpufem_torch.utils.format", "tpufem_torch.utils.profiling",
    "tpufem_torch.utils.checkpoint", "tpufem_torch.workloads",
    "tpufem_torch.workloads.simjeb",
    "tpufem_torch.examples.static_cantilever",
    "tpufem_torch.examples.simjeb_workload",
    "tpufem_torch.examples.packed_solve",
    "tpufem_torch.parallel.dist", "tpufem_torch.parallel.halo",
    "tpufem_torch.parallel.halo_partial",
    "tpufem_torch.parallel.packed_dist",
    "tpufem_torch.scripts.dist_cost_model",
    "tpufem_torch.examples.distributed_solve",
]


def test_import_isolation():
    """The port imports neither jax nor the tpufem package."""
    code = (
        "import importlib, sys\n"
        f"for m in {_ALL_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'tpufem' or m.startswith('tpufem.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
