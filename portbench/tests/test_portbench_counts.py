"""The roofline counts against hand counts, and the peaks' bound."""
import pytest

from portbench import peaks
from portbench.metrics import assembled_apply_roofline as asm
from portbench.metrics import packed_apply_roofline as pk


def test_packed_count_by_hand():
    # one c3d10 element alone: 10 nodes, 4 points, float32
    nbytes, flops = pk.count(elements=1, nodes=10, k=10, q=4, itemsize=4)
    assert nbytes == 10 * 3 * 4 * 3 + 10 * 4           # X, Y, coords; conn
    assert flops == 2 * 4 * (9 * 10 + 27 + 12 + 36 + 9 * 10)
    # two elements sharing six nodes, float64
    nbytes, flops = pk.count(elements=2, nodes=14, k=10, q=4, itemsize=8)
    assert nbytes == 3 * 14 * 8 * 3 + 2 * 10 * 4
    assert flops == 2 * 2 * 4 * 255


def test_assembled_count_by_hand():
    nbytes, flops = asm.count(elements=1, nodes=10, k=10, itemsize=8)
    assert nbytes == 465 * 8 + 2 * 30 * 8               # triangle of 30x30
    assert flops == 2 * 900
    nbytes, flops = asm.count(elements=3, nodes=4, k=4, itemsize=4)
    assert nbytes == 3 * 78 * 4 + 2 * 12 * 4            # triangle of 12x12
    assert flops == 3 * 2 * 144


def test_bound_is_the_larger_side():
    assert peaks.bound_seconds(3.35e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.bound_seconds(0, 34e12, "float64") == pytest.approx(1.0)
    assert peaks.bound_seconds(3.35e12, 67e12 * 2, "float32") == \
        pytest.approx(2.0)


@pytest.mark.parametrize("config,dtype,expect_us", [
    # box_tet10(55) in float32: operations bound it (2.037e9 / 67e12)
    ((998250, 1367631), "float32", 30.40),
    # the SimJEB box in float64: operations (2.085e9 / 34e12)
    ((1022208, 1402017), "float64", 61.33),
])
def test_packed_bound_at_the_cells(config, dtype, expect_us):
    e, n = config
    nbytes, flops = pk.count(e, n, 10, 4, peaks.ITEMSIZE[dtype])
    assert peaks.bound_seconds(nbytes, flops, dtype) * 1e6 == \
        pytest.approx(expect_us, rel=1e-3)


def test_assembled_bound_at_the_cell():
    nbytes, flops = asm.count(998250, 1367631, 10, 8)
    assert peaks.bound_seconds(nbytes, flops, "float64") * 1e3 == \
        pytest.approx(1.1281, rel=1e-3)
