"""The port's examples on the CPU (--device cpu): static_cantilever against
tpufem's examples/static_cantilever.py (the same mesh, load and solve in
float64: the written displacement and von Mises within 1e-9, the same CG
count), simjeb_workload on a small synthesized bundle, and packed_solve's
two preconditioners on a small box."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from tpufem_torch.examples import packed_solve, simjeb_workload
from tpufem_torch.examples import static_cantilever

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vtk_point_data(path):
    """{name: array} of a legacy ASCII .vtk written by write_vtk."""
    text = open(path).read().split("POINT_DATA ")[1].split("\n")
    n = int(text[0])
    out, i = {}, 1
    while i < len(text) and text[i]:
        head = text[i].split()
        if head[0] == "SCALARS":
            out[head[1]] = np.array(text[i + 2:i + 2 + n], float)
            i += 2 + n
        else:
            out[head[1]] = np.loadtxt(text[i + 1:i + 1 + n])
            i += 1 + n
    return out


def test_static_cantilever_matches_tpufem(tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "tpufem_static_cantilever",
        os.path.join(ROOT, "examples", "static_cantilever.py"))
    j_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_example)
    j_example.main(str(tmp_path / "j.vtk"))
    j_out = capsys.readouterr().out
    info, uz = static_cantilever.main(["--device", "cpu", "--out",
                                       str(tmp_path / "t.vtk")])
    t_out = capsys.readouterr().out
    assert int(info.status) == 1 and uz < 0
    assert f"iters={int(info.iterations)} " in j_out
    # the tip and stress lines print the same digits
    for key in ("tip deflection", "mesh:"):
        assert ([ln for ln in j_out.splitlines() if key in ln]
                == [ln for ln in t_out.splitlines() if key in ln])
    pj, pt = (_vtk_point_data(str(tmp_path / f"{p}.vtk")) for p in "jt")
    assert set(pj) == set(pt) == {"displacement", "von_mises"}
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], rtol=0,
                                   atol=1e-9 * np.abs(pj[k]).max())


def test_simjeb_workload_example(capsys):
    metrics, ok = simjeb_workload.main(["--device", "cpu", "--n", "2"])
    out = capsys.readouterr().out
    assert ok and out.rstrip().endswith("ACCEPTED")
    assert metrics["status"] in (1, 2)


def test_packed_solve_example(capsys):
    out = packed_solve.main(["2", "--device", "cpu"])
    assert set(out) == {"jacobi", "block", "distributed"}
    (ij, uj), (ib, ub) = out["jacobi"], out["block"]
    (idd, ud) = out["distributed"]
    assert int(ij.status) == int(ib.status) == int(idd.status) == 1
    assert uj < 0 and abs(uj - ub) <= 1e-4 * abs(uj)
    assert abs(ud - ub) <= 1e-4 * abs(ub)
    text = capsys.readouterr().out
    assert "jacobi : status=1" in text
    assert "distributed (4 parts): status=1" in text
