"""tpufem_torch's partitioners against tpufem's: labels bitwise.

parallel.partition is a copy of tpufem's jax-free module on the port's
native library, topology and Morton order.  On box meshes (c3d4, c3d10,
c3d8): compute_subdivisions, build_adjacency, pick_distant_seeds,
region_growing_partition (native and numpy, balanced or not; each package
with its library on, then off), partition_elements, rcb_partition (also
with more parts than elements), morton_partition, hierarchical_partition
and owner_of_nodes give tpufem's arrays exactly.
"""
import numpy as np
import pytest
import torch

import tpufem.native as j_native
from tpufem.parallel import partition as jp
from tpufem.topology.faces import element_dual_graph
from tpufem.utils import meshgen

import tpufem_torch.native as t_native
from tpufem_torch.parallel import partition as tp


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs (host numpy work only)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = {
    "c3d4": lambda: meshgen.box_tet(4, 3, 3),
    "c3d10": lambda: meshgen.box_tet10(3, 3, 2),
    "c3d8": lambda: meshgen.box_hex(5, 4, 3),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def numpy_only(monkeypatch):
    """Both packages' native libraries switched off."""
    monkeypatch.setattr(t_native, "_load", lambda: None)
    monkeypatch.setattr(j_native, "_load", lambda: None)


def test_compute_subdivisions():
    for size, gb, bpf in ((1000, 0.001, 4), (3 * 10 ** 6, 1.0, 8),
                          (17, 1e-6, 4)):
        assert tp.compute_subdivisions(size, gb, bpf) == \
            jp.compute_subdivisions(size, gb, bpf)


def test_adjacency_and_seeds():
    _, conn = MESHES["c3d4"]()
    edge = element_dual_graph(conn, "c3d4")
    a, b = tp.build_adjacency(edge, conn.shape[0]), jp.build_adjacency(
        edge, conn.shape[0])
    for name in ("indptr", "indices", "data"):
        _same(getattr(a, name), getattr(b, name))
    _same(tp.pick_distant_seeds(a, 5, seed=3),
          jp.pick_distant_seeds(b, 5, seed=3))


@pytest.mark.parametrize("etype", sorted(MESHES))
@pytest.mark.parametrize("balanced", [False, True])
def test_partition_elements(etype, balanced):
    _, conn = MESHES[etype]()
    for n_parts, seed in ((3, 0), (7, 5)):
        lt, st = tp.partition_elements(conn, etype, n_parts, seed, balanced)
        lj, sj = jp.partition_elements(conn, etype, n_parts, seed, balanced)
        _same(lt, lj)
        _same(st, sj)


@pytest.mark.parametrize("balanced", [False, True])
def test_region_growing_numpy(numpy_only, balanced):
    """The numpy BFS and region growing (no library in either package)."""
    _, conn = MESHES["c3d4"]()
    lt, st = tp.partition_elements(conn, "c3d4", 5, 1, balanced)
    lj, sj = jp.partition_elements(conn, "c3d4", 5, 1, balanced)
    _same(lt, lj)
    _same(st, sj)


def test_region_growing_native_equals_numpy(monkeypatch):
    """The port's native growth gives its own numpy path's labels."""
    _, conn = MESHES["c3d4"]()
    native = tp.partition_elements(conn, "c3d4", 6, 2)[0]
    monkeypatch.setattr(t_native, "_load", lambda: None)
    _same(tp.partition_elements(conn, "c3d4", 6, 2)[0], native)


@pytest.mark.parametrize("etype", sorted(MESHES))
def test_geometric_partitions(etype):
    coords, conn = MESHES[etype]()
    for n_parts in (1, 4, 7):
        _same(tp.rcb_partition(coords, conn, n_parts),
              jp.rcb_partition(coords, conn, n_parts))
        _same(tp.morton_partition(coords, conn, n_parts),
              jp.morton_partition(coords, conn, n_parts))
    _same(tp.rcb_partition(coords, conn[:5], 8),
          jp.rcb_partition(coords, conn[:5], 8))


def test_hierarchical_and_owner():
    _, conn = MESHES["c3d8"]()
    lt, ht = tp.hierarchical_partition(conn, "c3d8", (2, 3), seed=1)
    lj, hj = jp.hierarchical_partition(conn, "c3d8", (2, 3), seed=1)
    _same(lt, lj)
    _same(ht, hj)
    N = int(conn.max()) + 3          # two nodes no element touches
    _same(tp.owner_of_nodes(conn, lt, N), jp.owner_of_nodes(conn, lj, N))
