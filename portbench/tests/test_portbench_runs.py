"""Runs of every cell at a size the CPU holds, through the harness with
the look for a card skipped: the program comes out correct; its control
and each fault planted under the timed path come out not correct."""
import ast
import importlib
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from portbench import harness, spans, spec, trace
from portbench.tests.cells import WORKLOADS, tiny_cell

SEED = 2 ** 31 + 77


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(workload, trace_on=False, control=False, fault=None, n=(1, 1, 2),
        root=spec.ROOT):
    res, rc = harness.run_cell(tiny_cell(workload, n, root), SEED, 0.01,
                               trace_on, "cpu", time.perf_counter(),
                               control=control, fault=fault)
    assert rc == 0
    return res


def path_module(workload, root=spec.ROOT):
    """The path module of a cell, for the constant it declares
    (portbench.paths: FROZEN_ZERO)."""
    name = spec.module_name(spec.load(workload, root).path)
    return importlib.import_module("portbench.paths." + name)


def check_program(workload, root=spec.ROOT):
    res = run(workload, root=root)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"solve_s", "setup_s"}  # no card peak
    assert list(res)[-1] == "compared"
    assert res["compared"]["resid_max"]["value"] <= \
        res["compared"]["resid_max"]["limit"]
    json.dumps(res)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_is_correct(workload):
    check_program(workload)


def test_window_ends_with_the_solve_in_flight():
    """A solve made to take two seconds and a little, in a mix of two
    cases: a 2 s window ends with its first solve, mid-way through the
    pass over the cases."""
    def slow(path):
        solve = path.solve

        def slowed(b):
            time.sleep(2.0)
            return solve(b)
        path.solve = slowed
    cell = tiny_cell("tet10_box_1m_f64.pcg_f64")
    case = cell.traffic["cases"][0]
    cell.traffic = dict(cell.traffic, cases=[case, dict(case, name="again")])
    res, rc = harness.run_cell(cell, SEED, 2.0, False, "cpu",
                               time.perf_counter(), fault=slow)
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] == 1
    assert res["metrics"]["solve_s"]["value"] > 2.0


def test_traced_run_reports_the_layers(monkeypatch):
    seen = []
    metrics = harness._metrics

    def spy(entries, ctx):
        seen.append(ctx)
        return metrics(entries, ctx)
    monkeypatch.setattr(harness, "_metrics", spy)
    res = run("tet10_box_1m_f64.pcg_f64", trace_on=True)
    assert res["correct"] is True
    assert {"pcg_iters_per_solve", "pcg_iter_ms", "plan_build_s",
            "host_syncs_per_solve"} <= set(res["metrics"])
    assert "breakdown" in res and res["device"]["window_s"] > 0
    # the traced solve's recording reaches the metrics: one host read
    # after each 32-iteration block and one in the prologue
    ctx, = seen
    counts = ctx.recording.counts
    assert counts["cg.blocks"] == -(-ctx.solves[0]["iterations"] // 32)
    assert res["metrics"]["host_syncs_per_solve"]["value"] == \
        counts["cg.blocks"] + 1
    assert all(s["detail"].startswith("own residual") for s in ctx.solves)
    assert spans.PREFIX + "cg.solve" in {r[0] for r in ctx.recording.spans}


def check_control(workload, root=spec.ROOT):
    # at (1, 1, 2) float32 round-off reads only 2.5-3.1 times the bar
    res = run(workload, control=True, n=(3, 3, 3), root=root)
    assert res["correct"] is False
    c = res["compared"]
    assert c["resid_max"]["value"] > 3 * c["resid_max"]["limit"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload):
    check_control(workload)


def _halve(path):
    """Half of the elements left out and the rest counted twice (the mean
    over the kept half), in every operator the path keeps by element after
    its build (see portbench.paths on a path that condenses the system)."""
    ws = []
    op = getattr(getattr(path, "system", None), "op", None)
    if op is not None:
        ws.append(op.W)
    if getattr(path, "refined", None) is not None:
        ws += [W for _, _, _, W in path.refined.op64.chunks]
    if hasattr(path, "model"):
        ws += [op.K for op in path.model.solid_ops]
    if hasattr(path, "element_weights"):
        ws += list(path.element_weights())
    assert ws
    for w in ws:
        w[::2] = 0.0
        w[1::2] *= 2.0


def _alter(where):
    def plant(path):
        solve = path.solve

        def altered(b):
            u, conv, it, detail = solve(b)
            u = u.copy()
            nodes = (np.nonzero(np.abs(u).sum(1) == 0)[0] if where == "fixed"
                     else np.nonzero(np.abs(u).sum(1) > 0)[0])
            u[nodes[len(nodes) // 2], 0] += 0.01 * np.abs(u).max()
            return u, conv, it, detail
        path.solve = altered
    return plant


FAULTS = {"halved_batch": _halve, "altered_answer": _alter("free"),
          "altered_fixed_dof": _alter("fixed")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_planted_fault_is_caught(workload, fault):
    assert run(workload, fault=FAULTS[fault])["correct"] is False


# a frozen state's answer where the path's is not exactly 0: 10,000 times
# the traffic's 1e-6 bar, so that no rounding error can read so high
FROZEN_FLOOR = 1e-2


def check_unchanged_state(workload, monkeypatch, root=spec.ROOT):
    from tpufem_torch.solvers.cg import CGBlock
    monkeypatch.setattr(CGBlock, "body", lambda self, n: None)
    res = run(workload, root=root)
    assert res["correct"] is False
    resid = res["compared"]["resid_max"]["value"]
    if getattr(path_module(workload, root), "FROZEN_ZERO", True):
        assert resid == 1.0
    else:
        assert res["failed"] == res["attempted"]
        assert resid >= FROZEN_FLOOR


@pytest.mark.parametrize("workload", WORKLOADS)
def test_unchanged_state_is_caught(workload, monkeypatch):
    check_unchanged_state(workload, monkeypatch)


def _bench_of_one_cell(root, config: dict, path: str):
    """A BENCHMARK.json in `root` with one cell, `config` through `path`,
    written as a later change would add them: files and entries only."""
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    name = config["name"]
    rel = f"portbench/configs/{name}.json"
    bench["configs"] = [{"name": name, "source": "a test's own box",
                         "file": rel, "reduced": [], "why": "a test"}]
    bench["workloads"] = [{"name": f"{name}.{path}", "config": name,
                           "traffic": "box_top_axial", "chips": 1,
                           "why": "a test"}]
    os.makedirs(os.path.join(root, "portbench", "configs"))
    with open(os.path.join(root, rel), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return f"{name}.{path}"


TET4_BOX = {
    "name": "tet4_box_tiny",
    "mesh": {"generator": "box_tet4", "n": [2, 2, 3],
             "size": [1.0, 1.0, 1.0]},
    "element": {"type": "c3d4", "nodes": 4, "points": 1},
    "elements": 72, "nodes": 36,
    "material": {"E": 200e9, "nu": 0.3},
    "precision": "float64",
    "fixed": {"axis": 2, "value": 0.0},
    "reduced": [],
}


def test_a_cell_of_another_element_needs_files_only(tmp_path):
    """A c3d4 cell on another mesh generator, added by a configuration
    file and BENCHMARK.json entries alone: found by name, solved by the
    program, judged by the reference's c3d4, and caught when altered."""
    workload = _bench_of_one_cell(str(tmp_path), TET4_BOX, "pcg_f64")
    cell = spec.load(workload, root=str(tmp_path))
    assert cell.config["element"]["type"] == "c3d4"
    res, rc = harness.run_cell(cell, SEED, 0.01, False, "cpu",
                               time.perf_counter())
    assert rc == 0 and res["correct"] is True and res["failed"] == 0
    assert res["compared"]["resid_max"]["value"] <= 1e-6
    res, rc = harness.run_cell(cell, SEED, 0.01, False, "cpu",
                               time.perf_counter(), fault=_alter("free"))
    assert rc == 0 and res["correct"] is False


class SubstructuredPath:
    """A path that condenses the system: the program's ``build_hybrid``
    with the BDD interface preconditioner and tpufem's settings for
    BASELINE config 4 (slim, K_II^-1 stored, the assembled interface
    block applied matrix-free), in the configuration's ``parts`` by RCB
    and its ``precision`` (the control: float32).  The interface PCG
    solves to INTERFACE_TOL times the norm of the condensed load g, as the
    program's ``scripts/bench_hybrid.py`` asks; the interiors follow from
    K_II^-1 (f_I - K_IG u_G).  The program takes only an absolute
    tolerance, so each solve condenses the load once more than it needs
    for that norm (an interior solve, a K_IG^T GEMV and a host read)."""

    INTERFACE_TOL = 1e-7
    WARM_ITERATIONS = 64

    def __init__(self, mesh, config, traffic, device, stages, control=False):
        import tpufem_torch as tt

        m = config["material"]
        dtype = (torch.float32 if control
                 else getattr(torch, config["precision"]))
        self.max_iter = int(traffic["max_iter"])
        self.fixed = torch.as_tensor(mesh.fixed, device=device).long()
        with stages("partition"):
            labels = tt.partition.rcb_partition(mesh.coords, mesh.conn,
                                                config["parts"])
        with stages("hybrid"):
            self.system = tt.build_hybrid(
                mesh.coords, mesh.conn, config["element"]["type"], m["E"],
                m["nu"], config["parts"], fixed_nodes=mesh.fixed,
                labels=labels, dtype=dtype, precondition="bdd", slim=True,
                interior_inverse=True, matrix_free_gg=True, device=device)

    def solve(self, b):
        return self._solve(b, self.max_iter)

    def warm(self, b):
        self._solve(b, self.WARM_ITERATIONS)

    def _solve(self, b, max_iter):
        s = self.system
        f = torch.tensor(b, dtype=s.dtype, device=s.device)
        f[self.fixed] = 0.0
        gn = float(torch.linalg.norm(s._condense(f)[1]))
        u, info = s.solve(f, tol=self.INTERFACE_TOL * gn, max_iter=max_iter)
        return (u.double().cpu().numpy(), int(info.status) == 1,
                int(info.iterations),
                f"own residual {float(info.residual_norm)!r}")

    def diagonal(self):
        return None

    def apply_call(self):
        v = torch.ones((self.system.meta.n_interface, 3),
                       dtype=self.system.dtype, device=self.system.device)
        return lambda: self.system.schur_matvec(v)

    def element_weights(self):
        return [self.system.mf_op.W]

    def close(self):
        self.system = None


def substructured_module():
    """SubstructuredPath's module, as ``portbench/paths/<name>.py`` would
    hold it: its answer is not 0 under a frozen interface state (the
    interiors are solved directly)."""
    mod = types.ModuleType("portbench.paths.substructured_bdd")
    mod.__dict__.update(OPERATOR="schur", DTYPE="float64", DIAG_LIMIT=None,
                        FROZEN_ZERO=False, Path=SubstructuredPath)
    return mod


def _halved_stiffness(stiffness):
    """The program's element matrices with half of the elements left out
    and the rest counted twice, as ``_halve`` leaves a built operator's
    weights: planted before a build that condenses them into blocks."""
    def halved(*args, **kwargs):
        K = stiffness(*args, **kwargs)
        K[::2] = 0.0
        K[1::2] *= 2.0
        return K
    return halved


def test_a_condensing_path_needs_files_only(tmp_path, monkeypatch):
    """A path that condenses the system, added as a path module and
    BENCHMARK.json entries alone, in 2 parts of the c3d4 box, which its
    ``cpu_test`` entry sets to (6, 6, 6): there the float32 round-off of
    the control reads above 3 times the bar.  The checks that every cell
    gets read its declared constant and weights, and find the program
    correct, its control, each planted fault and a frozen state not
    correct; half of the elements left out is planted before the build
    too, so that every block the path condenses is halved."""
    from tpufem_torch.elements import solid

    mod = substructured_module()
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    root = str(tmp_path)
    cpu_mesh = dict(TET4_BOX["mesh"], n=[6, 6, 6])
    workload = _bench_of_one_cell(
        root, dict(TET4_BOX, parts=2, cpu_test={"mesh": cpu_mesh}),
        "substructured_bdd")
    assert path_module(workload, root) is mod
    check_program(workload, root)
    check_control(workload, root)
    with monkeypatch.context() as m:
        m.setattr(solid, "stiffness", _halved_stiffness(solid.stiffness))
        assert run(workload, fault=_halve, root=root)["correct"] is False
    for fault in FAULTS.values():
        assert run(workload, fault=fault, root=root)["correct"] is False
    check_unchanged_state(workload, monkeypatch, root)


def test_trace_summary_on_a_made_timeline():
    dev = [("k1", 10.0, 20.0), ("k2", 15.0, 30.0), ("k1", 50.0, 60.0),
           ("k3", 95.0, 130.0)]
    host = [("portbench.traced", 0.0, 100.0), ("aten::item", 31.0, 49.0),
            ("portbench.solve", 60.0, 100.0), ("cudaGraphLaunch", 70.0, 71.0)]
    w = trace.summarize(dev, host, "portbench.traced")
    assert w.window_s == pytest.approx(100e-6)
    assert w.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert w.device_ops[0] == ["k1", pytest.approx(20e-6)]
    gaps = [g for g, _ in w.idle_gaps]
    assert w.idle_gaps[0][1] == pytest.approx(35e-6)     # 60 .. 95
    assert gaps[0] == "portbench.solve > cudaGraphLaunch" or \
        gaps[0] == "portbench.solve"
    assert "portbench.traced > aten::item" in gaps        # 30 .. 50
    assert trace.summarize(dev, host, "portbench.none") is None


BANNED = set(harness.BANNED)
PKG = os.path.dirname(spec.PKG + "/")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_the_reference_nothing_of_the_program():
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            tops = {m.split(".")[0] for m in _imports(p)}
            assert not tops & BANNED, (p, tops & BANNED)
            if os.sep + "reference" + os.sep in p or fn in ("mesh.py",
                                                            "loads.py"):
                assert "tpufem_torch" not in tops, p


def test_banned_names_compared_whole(monkeypatch):
    assert harness.loaded_banned() == [] or "tpufem" not in sys.modules
    monkeypatch.setitem(sys.modules, "tpufem_torchlike", sys)
    assert "tpufem" not in harness.loaded_banned()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.loaded_banned() == ["jax"]


def test_a_run_loads_no_jax_module():
    code = ("import sys, time; from portbench.harness import run_cell; "
            "from portbench.tests.cells import tiny_cell; "
            "r, rc = run_cell(tiny_cell('tet10_box_1m_f64.pcg_f64'), 5, "
            "0.01, False, 'cpu', time.perf_counter()); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & set("
            f"{sorted(BANNED)!r})), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_cli_refuses_without_a_card_or_the_program(tmp_path):
    import shutil
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    args = ["-m", "portbench.run", "--workload", WORKLOADS[0], "--seed",
            "1", "--seconds", "1", "--trace", "0"]
    for cwd in (spec.ROOT, tmp_path):
        out = subprocess.run([sys.executable, *args], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "99", "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
