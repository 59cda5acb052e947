"""tpufem_torch's topology tools and native mesh entries against tpufem's.

The port's topology.faces, .edges and .diagnostics are copies of tpufem's
jax-free modules on the port's native library: every output here is held
bitwise equal to tpufem's on small seeded meshes (c3d4, c3d10, c3d8, c3d6;
s3/s4 grids), and the port's native path bitwise equal to its own numpy
fallback (the library switched off).  The four native entries
(extract_faces, region_grow, bfs_distances, unique_edges) are held bitwise
against tpufem's library on the same inputs.
"""
import numpy as np
import pytest
import torch

import tpufem.native as j_native
from tpufem.parallel.partition import build_adjacency as j_adjacency
from tpufem.topology import diagnostics as j_diag
from tpufem.topology import edges as j_edges
from tpufem.topology import faces as j_faces
from tpufem.utils import meshgen

import tpufem_torch.native as t_native
from tpufem_torch.topology import diagnostics as t_diag
from tpufem_torch.topology import edges as t_edges
from tpufem_torch.topology import faces as t_faces


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs (it runs no torch work of
    size; under the suite's parallel workers the pool costs more)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _curved(coords, seed=0):
    rng = np.random.default_rng(seed)
    return coords + 0.03 * rng.standard_normal(coords.shape)


MESHES = {
    "c3d4": lambda: meshgen.box_tet(2, 3, 2),
    "c3d10": lambda: meshgen.box_tet10(2, 2, 2),
    "c3d8": lambda: meshgen.box_hex(3, 2, 2),
    "c3d6": lambda: meshgen.box_wedge(2, 2, 3),
}


@pytest.fixture
def no_native(monkeypatch):
    """The port's native library switched off (its numpy fallbacks run)."""
    monkeypatch.setattr(t_native, "_load", lambda: None)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("etype", sorted(MESHES))
def test_faces_bitwise(etype):
    coords, conn = MESHES[etype]()
    coords = _curved(coords)
    for name in ("boundary_faces", "shared_faces", "element_dual_graph"):
        _same(getattr(t_faces, name)(conn, etype),
              getattr(j_faces, name)(conn, etype))
    for name in ("outward_surface_normals", "face_normals_area",
                 "node_curvatures"):
        _same(getattr(t_faces, name)(coords, conn, etype),
              getattr(j_faces, name)(coords, conn, etype))


@pytest.mark.parametrize("etype", sorted(MESHES))
def test_faces_native_equals_numpy(etype, no_native):
    """The numpy fallback gives the native path's arrays (tpufem's native
    output is the reference: it stays on)."""
    _, conn = MESHES[etype]()
    for name in ("boundary_faces", "shared_faces", "element_dual_graph"):
        got = getattr(t_faces, name)(conn, etype)
        want = getattr(j_faces, name)(conn, etype)
        if name == "boundary_faces":
            # the numpy path emits the same faces in element-major order
            # but keeps conn's integer dtype
            for kind in want:
                for g, w in zip(got[kind], want[kind]):
                    assert np.array_equal(g, w)
        else:
            assert np.array_equal(got, want)


@pytest.mark.parametrize("etype", ["c3d4", "c3d8", "c3d6", "s3", "s4"])
def test_edges_bitwise(etype):
    if etype == "s3":
        _, conn = meshgen.grid_tri(3, 2)
    elif etype == "s4":
        _, conn = meshgen.grid_quad(3, 2)
    else:
        _, conn = MESHES[etype]()
    _same(t_edges.element_to_edge(conn, etype),
          j_edges.element_to_edge(conn, etype))
    if etype in ("s3", "s4"):
        _same(t_edges.shared_edges(conn, etype),
              j_edges.shared_edges(conn, etype))
        _same(t_edges.boundary_edges(conn, etype),
              j_edges.boundary_edges(conn, etype))


def test_edges_native_equals_numpy(no_native):
    _, conn = meshgen.box_tet(3, 2, 2)
    assert np.array_equal(t_edges.element_to_edge(conn, "c3d4"),
                          j_edges.element_to_edge(conn, "c3d4"))


def test_diagnostics_bitwise():
    coords, conn = meshgen.box_tet(2, 2, 2)
    coords = _curved(coords, 1)
    stress = np.random.default_rng(2).standard_normal((conn.shape[0], 3, 3))
    f_t = t_diag.element_face_forces(coords, conn, "c3d4", stress)
    f_j = j_diag.element_face_forces(coords, conn, "c3d4", stress)
    _same(f_t, f_j)
    _same(t_diag.shared_face_force_residual(conn, "c3d4", f_t),
          j_diag.shared_face_force_residual(conn, "c3d4", f_j))


def test_native_entries_bitwise():
    """extract_faces, unique_edges, bfs_distances and region_grow of the
    port's library against tpufem's, on the same inputs."""
    coords, conn = meshgen.box_tet(3, 3, 2)
    for table, opp in ((j_faces.TET_FACES, j_faces.TET_OPPOSITE),):
        _same(t_native.extract_faces(conn, table, opp),
              j_native.extract_faces(conn, table, opp))
        _same(t_native.extract_faces(conn, table),
              j_native.extract_faces(conn, table))
    et = j_edges._EDGE_TABLES["c3d4"]
    _same(t_native.unique_edges(conn, et), j_native.unique_edges(conn, et))
    adj = j_adjacency(j_faces.element_dual_graph(conn, "c3d4"),
                      conn.shape[0])
    ip, ix = adj.indptr.astype(np.int64), adj.indices.astype(np.int32)
    src = np.array([0, 17], np.int32)
    _same(t_native.bfs_distances(ip, ix, src),
          j_native.bfs_distances(ip, ix, src))
    seeds = np.array([0, 40, 100], np.int32)
    _same(t_native.region_grow(ip, ix, seeds, 3),
          j_native.region_grow(ip, ix, seeds, 3))
