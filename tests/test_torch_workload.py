"""tpufem_torch.workloads.simjeb against tpufem's: the SimJEB-shaped
bundle each package synthesizes (c3d4, n = 2, float64) and the notebook
workload that each runs, cold-started, on the port's bundle; then
tpufem's own end-to-end bars (tests/test_workload.py) on the port alone,
first and second order.  tpufem runs its packed kernels in interpret mode
on the CPU (~30 s for its two calls), so its side is limited to the c3d4
bundle; its c3d10 workload takes ~80 s there and is not repeated (the
port's c3d10 run is held to tpufem's bars instead)."""
import re

import numpy as np
import pytest
import torch

from tpufem.io import vtk as j_vtk
from tpufem.workloads import run_simjeb_workload as j_run
from tpufem.workloads import synthesize_simjeb_bundle as j_synth

import tpufem_torch as tt
from tpufem_torch.utils.profiling import StageClock
from tpufem_torch.workloads import simjeb as t_simjeb

KEYS = ("residual_truth", "residual_zero", "residual_solve", "vm_max",
        "equilibrium", "equilibrium_mean", "iterations", "status")


@pytest.fixture(scope="module", autouse=True)
def _one_thread_x64():
    """One torch thread, and float64 as torch's default floating type (the
    workload's f64 switch, tpufem's jax_enable_x64 that conftest sets),
    while this module runs."""
    n, dt = torch.get_num_threads(), torch.get_default_dtype()
    torch.set_num_threads(1)
    tt.enable_x64()
    yield
    torch.set_default_dtype(dt)
    torch.set_num_threads(n)


def _h5(path):
    import h5py
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k][...]) for k in f}


def _point_data(path):
    """The appended Float64 point-data arrays of a write_vtu file."""
    data = open(path, "rb").read()
    mark = data.find(b"<AppendedData")
    payload = data[data.find(b"_", data.find(b">", mark)) + 1:]
    out = {}
    for name, ncomp, off in re.findall(
            rb'<DataArray type="Float64" Name="([^"]+)" NumberOfComponents='
            rb'"(\d+)" format="appended" offset="(\d+)"/>', data[:mark]):
        off = int(off)
        nbytes = int(np.frombuffer(payload, "<u8", 1, off)[0])
        a = np.frombuffer(payload, "<f8", nbytes // 8, off + 8)
        out[name.decode()] = a.reshape(-1, int(ncomp))
    return out


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Both packages' c3d4 bundles at n = 2 (96 elements, 45 nodes)."""
    dj, dt = tmp_path_factory.mktemp("j"), tmp_path_factory.mktemp("t")
    pj = j_synth(str(dj), n=2, interpret=True)
    pt = tt.synthesize_simjeb_bundle(str(dt), n=2, device="cpu")
    return pj, pt


def test_synthesized_bundle_matches_tpufem(bundles):
    pj, pt = bundles
    assert pt["etype"] == pj["etype"] == "c3d4"
    assert pt["status"] == 1 and pt["iterations"] > 0
    with open(pj["mesh"], "rb") as a, open(pt["mesh"], "rb") as b:
        assert a.read() == b.read()
    hj, ht = _h5(pj["h5"]), _h5(pt["h5"])
    assert set(hj) == set(ht) == {"forces", "rbe2", "rbe3", "outputs"}
    for k in ("forces", "rbe2", "rbe3"):
        assert hj[k].dtype == ht[k].dtype
        np.testing.assert_array_equal(ht[k], hj[k])
    oj, ot = hj["outputs"], ht["outputs"]
    assert ot.shape == oj.shape == (45, 1, 6)
    np.testing.assert_allclose(ot, oj, rtol=0,
                               atol=1e-9 * np.abs(oj).max())


@pytest.fixture(scope="module")
def runs(bundles, tmp_path_factory):
    """Each package's cold-started workload on the port's bundle."""
    _, pt = bundles
    d = tmp_path_factory.mktemp("runs")
    kw = dict(warm_start=False, tol=1e-8, verbose=False)
    mj = j_run(pt["mesh"], pt["h5"], interpret=True,
               out_path=str(d / "j.vtu"), **kw)
    mt = tt.run_simjeb_workload(pt["mesh"], pt["h5"], device="cpu",
                                out_path=str(d / "t.vtu"), **kw)
    return mj, mt, d


def test_workload_metrics_match_tpufem(runs):
    """The same status and PCG count; vm_max and the two equilibrium
    numbers within 1e-9 relative.  residual_truth and residual_solve are
    sums of row norms of A u - F at ~1e-8 of the force scale, i.e. of
    cancellation left over after A u ~ F: their own leading digits are
    roundoff (the packages' f64 operators and PCG dot orders differ by
    ~1e-16), so they are held within 1e-9 of the scale they cancel from,
    residual_zero."""
    mj, mt, _ = runs
    assert set(mt) == set(mj) == set(KEYS)
    assert mt["status"] == mj["status"] == 1
    assert mt["iterations"] == mj["iterations"] > 0
    scale = mj["residual_zero"]
    assert abs(mt["residual_zero"] - scale) <= 1e-9 * scale
    for k in ("residual_truth", "residual_solve"):
        assert abs(mt[k] - mj[k]) <= 1e-9 * scale, k
    for k in ("vm_max", "equilibrium", "equilibrium_mean"):
        assert abs(mt[k] - mj[k]) <= 1e-9 * abs(mj[k]), k
    # the port passes tpufem's acceptance bars on its own bundle
    assert mt["residual_solve"] <= (1.5 * mt["residual_truth"]
                                    + 1e-6 * mt["residual_zero"])
    assert mt["residual_solve"] < 1e-3 * mt["residual_zero"]


def test_workload_result_file_matches_tpufem(runs):
    _, _, d = runs
    pj, bj = j_vtk.read_vtu(str(d / "j.vtu"))
    pt, bt = tt.vtk_io.read_vtu(str(d / "t.vtu"))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(bt["c3d4"], bj["c3d4"])
    aj, at = _point_data(str(d / "j.vtu")), _point_data(str(d / "t.vtu"))
    assert set(aj) == set(at) == {"displacement", "von_mises"}
    for k in aj:
        assert at[k].shape == aj[k].shape
        np.testing.assert_allclose(at[k], aj[k], rtol=0,
                                   atol=1e-9 * np.abs(aj[k]).max())


def test_workload_without_h5_is_the_file_path(bundles, runs, tmp_path):
    """The pipeline with the sample held in memory in place of
    sample_0.h5 (how a machine without h5py runs it) writes the same
    mesh.vtu, holds the h5 file's datasets, and gives the file path's
    metrics, bitwise."""
    _, pt = bundles
    _, mt, _ = runs
    dev = torch.device("cpu")
    mesh, sample, info = t_simjeb._bundle_arrays(
        str(tmp_path), 2, t_simjeb.SIMJEB_E, t_simjeb.SIMJEB_NU, dev, "c3d4",
        StageClock(dev))
    with open(mesh, "rb") as a, open(pt["mesh"], "rb") as b:
        assert a.read() == b.read()
    h5 = _h5(pt["h5"])
    assert set(sample) == set(h5)
    for k in h5:
        assert sample[k].dtype == h5[k].dtype
        np.testing.assert_array_equal(sample[k], h5[k])
    assert int(info.iterations) == pt["iterations"]
    m = t_simjeb._run_mesh_file(
        mesh, sample, etype=None, dev=dev, stages=StageClock(dev),
        E=t_simjeb.SIMJEB_E, nu=t_simjeb.SIMJEB_NU, tol=1e-8, max_iter=2000,
        warm_start=False, out_path=None, verbose=False)
    assert m == mt


def test_workload_end_to_end_bars(tmp_path, capsys):
    """tpufem's test_simjeb_workload_end_to_end on the port (c3d4, n = 3):
    its bars, the printed anchors, and stage timings."""
    timings = {}
    paths = tt.synthesize_simjeb_bundle(str(tmp_path), n=3, device="cpu",
                                        timings=timings)
    m = tt.run_simjeb_workload(paths["mesh"], paths["h5"], device="cpu",
                               warm_start=False, tol=1e-8,
                               out_path=str(tmp_path / "result.vtu"),
                               timings=timings)
    out = capsys.readouterr().out
    assert "참값의 오차" in out and "변위 0의 오차" in out
    assert m["status"] in (1, 2) and m["iterations"] > 0
    assert m["residual_solve"] <= 1.5 * m["residual_truth"] + \
        1e-6 * m["residual_zero"]
    assert m["residual_solve"] < 1e-3 * m["residual_zero"]
    assert m["equilibrium"] < 1.0
    assert m["equilibrium_mean"] < 0.35
    assert m["vm_max"] > 0
    pts, blocks = tt.vtk_io.read_vtu(str(tmp_path / "result.vtu"))
    c0, b0 = tt.vtk_io.read_vtu(paths["mesh"])
    np.testing.assert_array_equal(pts, c0)
    np.testing.assert_array_equal(blocks["c3d4"], b0["c3d4"])
    assert set(timings) == {"mesh", "synthesis_build", "synthesis_solve",
                            "vtu_write", "h5_write", "read", "operator",
                            "solve", "stress", "faces", "result_write"}
    assert all(v >= 0 for v in timings.values())


def test_workload_second_order_bars(tmp_path):
    """tpufem's test_simjeb_workload_second_order on the port (c3d10,
    n = 2, the notebook's warm start)."""
    paths = tt.synthesize_simjeb_bundle(str(tmp_path), n=2, device="cpu",
                                        etype="c3d10")
    m = tt.run_simjeb_workload(paths["mesh"], paths["h5"], device="cpu",
                               verbose=False)
    assert m["status"] in (1, 2)
    assert m["residual_solve"] < 1e-3 * m["residual_zero"]
    assert np.isfinite(m["vm_max"]) and m["vm_max"] > 0
