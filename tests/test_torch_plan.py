"""tpufem_torch.ops.packed.PackedPlan against tpufem's: every table bitwise
on a one-bucket and a multi-bucket box_tet10, the packing helpers, the
numpy fallbacks, and tpufem's on-disk format in both directions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import packed as j_packed
from tpufem.utils import meshgen

from tpufem_torch.ops import packed as t_packed

TABLES = ("win_nodes", "wslot", "jslot", "lconn", "winc", "slotidx",
          "new_from_old", "old_from_new", "esrc")


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


def assert_plans_equal(jp, tp):
    assert dataclass_tuple(jp.meta) == dataclass_tuple(tp.meta)
    for name in TABLES:
        a = np.asarray(getattr(jp, name))
        b = getattr(tp, name).numpy()
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(jp.cinc) == len(tp.cinc)
    for a, b in zip(jp.cinc, tp.cinc):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def dataclass_tuple(m):
    return (m.n_nodes, m.n_blocks, m.n_clusters, m.elems_per_cluster,
            m.nodes_per_elem, m.lanes, m.win_n, m.win_c, m.c_groups,
            m.b_groups, m.cv_widths)


@pytest.fixture(scope="module", params=[3, 10], ids=["one_bucket",
                                                      "multi_bucket"])
def plans(request):
    n = request.param
    coords, conn = meshgen.box_tet10(n, n, n)
    N = coords.shape[0]
    return (coords, conn, j_packed.PackedPlan.build(coords, conn, N),
            t_packed.PackedPlan.build(coords, conn, N, device="cpu"))


def test_plan_tables_bitwise(plans):
    coords, conn, jp, tp = plans
    assert_plans_equal(jp, tp)
    if coords.shape[0] > 5000:
        assert len(tp.meta.c_groups) > 1 and len(tp.meta.b_groups) > 1


def test_pack_helpers_bitwise(plans):
    coords, conn, jp, tp = plans
    N = coords.shape[0]
    rng = np.random.default_rng(1)
    for dt in (np.float64, np.float32):
        u = rng.standard_normal((N, 3)).astype(dt)
        X_j = np.asarray(jp.pack(jnp.asarray(u)))
        X_t = tp.pack(torch.from_numpy(u))
        np.testing.assert_array_equal(X_t.numpy(), X_j)
        np.testing.assert_array_equal(tp.pack_np(u), jp.pack_np(u))
        np.testing.assert_array_equal(tp.unpack(X_t).numpy(),
                                      np.asarray(jp.unpack(jnp.asarray(X_j))))
        np.testing.assert_array_equal(tp.unpack(X_t).numpy(), u)
        uf = u.reshape(-1)
        for out_dt, jdt in ((torch.float32, jnp.float32),
                            (torch.float64, jnp.float64)):
            Xf_t = tp.pack_flat(torch.from_numpy(uf), out_dt)
            Xf_j = np.asarray(jp.pack_flat(jnp.asarray(uf), jdt))
            np.testing.assert_array_equal(Xf_t.numpy(), Xf_j)
            np.testing.assert_array_equal(
                tp.unpack_flat(Xf_t, out_dt).numpy(),
                np.asarray(jp.unpack_flat(jnp.asarray(Xf_j), jdt)))


def test_load_of_tpufem_saved_plan(plans, tmp_path):
    coords, conn, jp, tp = plans
    jp.save(str(tmp_path / "j"))
    assert_plans_equal(jp, t_packed.PackedPlan.load(str(tmp_path / "j"),
                                                      device="cpu"))
    # and the port's save is tpufem's format
    tp.save(str(tmp_path / "t"))
    assert_plans_equal(j_packed.PackedPlan.load(str(tmp_path / "t")), tp)


def test_plan_numpy_fallbacks_bitwise(monkeypatch):
    """With the native engine switched off, the port's numpy fallbacks
    build tpufem's (native) plan, on a curved multi-bucket mesh."""
    import tpufem_torch.native as native
    coords, conn = meshgen.box_tet10(3, 3, 5)
    coords = _curve(coords)
    N = coords.shape[0]
    jp = j_packed.PackedPlan.build(coords, conn, N)
    for fn in ("cluster_slots", "cluster_windows", "block_windows_count",
               "block_windows_fill_packed", "cinc_widths",
               "cinc_fill_packed", "first_touch", "radix_argsort",
               "unique_inverse_i64"):
        monkeypatch.setattr(native, fn, lambda *a, **k: None)
    assert_plans_equal(jp, t_packed.PackedPlan.build(coords, conn, N,
                                                       device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ordering_helpers_bitwise(seed):
    rng = np.random.default_rng(seed)
    counts = np.sort(rng.integers(0, 40, 700))
    for mg in (1, 4, 8):
        assert (t_packed._bucket_groups(counts, mg)
                == j_packed._bucket_groups(counts, mg))
    coords = rng.random((300, 3))
    conn = rng.integers(0, 300, (500, 10)).astype(np.int32)
    np.testing.assert_array_equal(t_packed.morton_order(coords, conn),
                                  j_packed.morton_order(coords, conn))
    np.testing.assert_array_equal(
        t_packed._chunk_unique_counts(conn),
        j_packed._chunk_unique_counts(conn))


def test_plan_to_device_roundtrip(plans):
    _, _, _, tp = plans
    tp2 = tp.to("cpu")
    assert tp2.meta == tp.meta and tp2.device.type == "cpu"
    for name in TABLES:
        assert torch.equal(getattr(tp2, name), getattr(tp, name))
