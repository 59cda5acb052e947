"""The frozen mesh and the load-case generator on tiny boxes."""
import numpy as np
import pytest

from portbench import loads as loadsmod
from portbench import mesh as meshmod
from portbench import spec

BOXES = [(1, 1, 1), (2, 3, 2), (3, 3, 3), (2, 2, 4)]
TET10 = meshmod.generator("box_tet10")
TET4 = meshmod.generator("box_tet4")


def _size(n):
    return (1.0, 1.0, 2.0) if n[2] == 2 * n[0] else (1.0, 1.0, 1.0)


@pytest.mark.parametrize("n", BOXES)
def test_box_tet10_is_the_programs(n):
    from tpufem_torch.utils import meshgen
    size = _size(n)
    c, t = TET10.make(n, size)
    c0, t0 = meshgen.box_tet10(*n, *size)
    assert np.array_equal(c, c0) and np.array_equal(t, t0)
    assert t.dtype == np.int32 and c.dtype == np.float64
    assert (t.shape[0], c.shape[0]) == TET10.sizes(n)
    for axis, value in ((2, 0.0), (2, size[2]), (0, 1.0)):
        assert np.array_equal(meshmod.boundary_nodes(c, axis, value),
                              meshgen.boundary_nodes(c, axis, value))


@pytest.mark.parametrize("n", BOXES)
def test_box_tet4_is_the_programs(n):
    from tpufem_torch.utils import meshgen
    size = _size(n)
    c, t = TET4.make(n, size)
    c0, t0 = meshgen.box_tet(*n, *size)
    assert np.array_equal(c, c0) and np.array_equal(t, t0)
    assert t.dtype == np.int32 and c.dtype == np.float64
    assert t.dtype == t0.dtype and c.dtype == c0.dtype
    assert (t.shape[0], c.shape[0]) == TET4.sizes(n)
    p = c[t]
    vol = np.linalg.det(p[:, 1:4] - p[:, :1]) / 6.0
    assert (vol > 0).all() and vol.sum() == pytest.approx(np.prod(size),
                                                          rel=1e-12)


def test_make_finds_the_generator_by_name():
    mesh = {"generator": "box_tet4", "n": [2, 1, 1], "size": [1.0] * 3}
    c, t = meshmod.make(mesh)
    c0, t0 = TET4.make((2, 1, 1), (1.0, 1.0, 1.0))
    assert np.array_equal(c, c0) and np.array_equal(t, t0)
    with pytest.raises(ImportError):
        meshmod.make(dict(mesh, generator="no_such_generator"))


def test_tets_positive_and_fill_the_box():
    c, t = TET10.make((2, 3, 2), (1.0, 1.0, 2.0))
    p = c[t[:, :4]]
    vol = np.linalg.det(p[:, 1:4] - p[:, :1]) / 6.0
    assert (vol > 0).all() and vol.sum() == pytest.approx(2.0, rel=1e-12)
    # every edge node is the middle of its edge
    for m, (a, b) in enumerate(((0, 1), (1, 2), (2, 0), (0, 3), (1, 3),
                                (2, 3))):
        assert np.allclose(c[t[:, 4 + m]], 0.5 * (c[t[:, a]] + c[t[:, b]]))


def _box(workload, n):
    cell = spec.load(workload)
    coords, _ = meshmod.make(dict(cell.config["mesh"], n=list(n)))
    return cell.traffic, coords


def test_per_node_cases():
    traffic, coords = _box("tet10_box_1m.refined_f32", (3, 3, 3))
    s = loadsmod.LoadStream(traffic, coords, 7)
    face = meshmod.boundary_nodes(coords, 2, 1.0)
    for k, c in enumerate(traffic["cases"]):
        b = s.loads[k][0]
        d = np.asarray(c["direction"]) / np.linalg.norm(c["direction"])
        assert np.allclose(b[face], 1000.0 * d, rtol=1e-7, atol=1e-4)
        assert not np.delete(b, face, axis=0).any()
        assert np.array_equal(b, b.astype(np.float32).astype(np.float64))
        assert np.array_equal(s.loads[k][1], -b)


def test_unknown_case_kind_is_refused():
    coords, _ = TET10.make((1, 1, 1), (1.0, 1.0, 1.0))
    face = meshmod.boundary_nodes(coords, 2, 1.0)
    with pytest.raises(ValueError):
        loadsmod.case_load({"kind": "torque", "moment": 1.0}, coords, face)


def test_seed_draws_signs_only():
    traffic, coords = _box("tet10_box_1m.refined_f32", (2, 2, 2))
    big = 2 ** 31 + 12345
    a = loadsmod.LoadStream(traffic, coords, big)
    b = loadsmod.LoadStream(traffic, coords, big)
    c = loadsmod.LoadStream(traffic, coords, big + 1)
    K = len(traffic["cases"])
    seq = [a.case(i) for i in range(3 * K)]
    assert [x[0] for x in seq] == [traffic["cases"][i % K]["name"]
                                   for i in range(3 * K)]
    for i in range(3 * K):
        assert np.array_equal(a.case(i)[2], b.case(i)[2])
        assert np.array_equal(np.abs(a.case(i)[2]), np.abs(c.case(i)[2]))
    assert [x[1] for x in seq] != [c.case(i)[1] for i in range(3 * K)]
    assert np.array_equal(a.warm, a.loads[0][0])
    loadsmod.LoadStream(traffic, coords, -5)      # any whole number
