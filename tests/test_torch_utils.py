"""tpufem_torch.utils.profiling and .checkpoint against tpufem's: the
roofline counters and their report, the synchronized timers, the set-up
stage clock (the port's own), the torch.profiler trace, the npz state
round trip, and checkpointed_cg's chunked restarts step for step with
tpufem's on tpufem's own box_tet(2) case (tests/test_utils_extra.py)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.elements import solid as j_solid
from tpufem.ops.operator import MatrixFreeOperator as JOperator
from tpufem.ops.scatter import ScatterPlan as JPlan
from tpufem.solvers.constraints import Constraints as JConstraints
from tpufem.utils import checkpoint as j_ckpt
from tpufem.utils import meshgen
from tpufem.utils import profiling as j_prof

import tpufem_torch as tt
from tpufem_torch.utils import checkpoint as t_ckpt
from tpufem_torch.utils import profiling as t_prof


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    dict(seconds=0.001, flops=2e9, bytes_moved=1e9, items=1e6),
    dict(seconds=0.25, flops=3.3e11, items=7.0),
    dict(seconds=2.0),
])
def test_roofline_matches_tpufem(kw):
    a, b = t_prof.Roofline(**kw), j_prof.Roofline(**kw)
    assert (a.gflops, a.gbps, a.items_per_s) == (b.gflops, b.gbps,
                                                 b.items_per_s)
    assert a.report("x") == b.report("x")
    r = t_prof.Roofline(seconds=0.001, flops=2e9, bytes_moved=1e9, items=1e6)
    assert abs(r.gflops - 2000) < 1e-6 and abs(r.gbps - 1000) < 1e-6


def test_timed_and_slope():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2

    t = t_prof.timed(f, torch.ones(1000), reps=2)
    assert t >= 0 and len(calls) == 3          # one warm-up, two timed
    assert t_prof._sync_scalar(torch.full((3,), 2.0)) == 6.0
    assert t_prof._sync_scalar(np.ones(4)) == 4.0
    assert t_prof._sync_scalar(1.5) == 1.5

    def make(iters):
        def run(x):
            for _ in range(iters):
                x = x + 1.0
            return x
        return run

    s = t_prof.timed_slope(make, 1, 50, torch.zeros(10), reps=2)
    assert s >= 1e-12


def test_stage_clock(monkeypatch):
    """StageClock adds the seconds since the last tick to its stage's key
    (a repeated stage accumulates), and without a dict records nothing."""
    now = iter([10.0, 10.5, 12.0, 12.25, 20.0, 21.0])
    monkeypatch.setattr(t_prof.time, "perf_counter", lambda: next(now))
    timings = {"before": 7.0}
    clock = t_prof.StageClock("cpu", timings)
    clock.tick("a")
    clock.tick("b")
    clock.tick("a")
    assert timings == {"before": 7.0, "a": 0.75, "b": 1.5}
    clock = t_prof.StageClock(torch.device("cpu"))
    clock.tick("a")
    assert clock.timings is None
    monkeypatch.undo()
    timings = {}
    clock = t_prof.StageClock("cpu", timings)
    for name in ("x", "y", "x"):
        torch.ones(100).sum()
        clock.tick(name)
    assert set(timings) == {"x", "y"}
    assert all(v >= 0.0 for v in timings.values())


def test_trace_writes_chrome_trace(tmp_path):
    x = torch.arange(64.0).reshape(8, 8)
    with t_prof.trace(str(tmp_path)) as prof:
        y = (x @ x).sum()
    assert float(y) == float((x @ x).sum())
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    # an exception inside the block is not swallowed
    with pytest.raises(ZeroDivisionError):
        with t_prof.trace(str(tmp_path)):
            1 / 0


def test_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "state")
    t_ckpt.save_state(p, {"u": torch.ones((4, 3), dtype=torch.float64),
                          "iterations": np.asarray(7),
                          "f32": torch.arange(5, dtype=torch.float32)})
    s = t_ckpt.load_state(p)
    assert s is not None and set(s) == {"u", "iterations", "f32"}
    assert isinstance(s["u"], np.ndarray) and s["u"].dtype == np.float64
    np.testing.assert_array_equal(s["u"], 1.0)
    assert int(s["iterations"]) == 7
    np.testing.assert_array_equal(s["f32"], np.arange(5, dtype=np.float32))
    assert s["f32"].dtype == np.float32
    assert t_ckpt.load_state(p + ".npz")["u"].shape == (4, 3)
    assert t_ckpt.load_state(str(tmp_path / "missing")) is None


def test_checkpointed_cg_matches_tpufem(tmp_path):
    """tpufem's resume case: 20 iterations in chunks of 10 at tol 1e-14,
    then a second call resuming from the file in chunks of 50 to 1e-12.
    Both packages restart cg from the saved u at each chunk; the counts
    after each call, the statuses and u (1e-10) agree."""
    coords, conn = meshgen.box_tet(2, 2, 2)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 0] = 0.01

    K = j_solid.stiffness(jnp.asarray(coords), jnp.asarray(conn), "c3d4",
                          200.0, 0.3)
    j_op = JOperator(K=K, plan=JPlan.build(conn, N, 3))
    j_cons = JConstraints.fixed(N, fixed, 3)
    Kt = tt.solid.stiffness(torch.as_tensor(coords), torch.as_tensor(conn),
                            "c3d4", 200.0, 0.3)
    t_op = tt.MatrixFreeOperator(Kt, tt.ScatterPlan.build(conn, N, 3,
                                                          device="cpu"))
    t_cons = tt.Constraints.fixed(N, fixed, 3)
    bt = torch.as_tensor(b)

    pj, pt = str(tmp_path / "j_state"), str(tmp_path / "t_state")
    steps = [dict(every=10, total_iter=20, tol=1e-14),
             dict(every=50, total_iter=500, tol=1e-12)]
    for kw in steps:
        uj, ij, dj = j_ckpt.checkpointed_cg(j_op, jnp.asarray(b), pj,
                                            constraints=j_cons, **kw)
        ut, it, dt = t_ckpt.checkpointed_cg(t_op, bt, pt,
                                            constraints=t_cons, **kw)
        assert dt == dj
        assert int(it.status) == int(ij.status)
        assert int(it.iterations) == int(ij.iterations)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0,
                                   atol=1e-10 * float(np.abs(uj).max()))
        saved = t_ckpt.load_state(pt)
        assert int(saved["iterations"]) == dt
        np.testing.assert_array_equal(saved["u"], ut.numpy())
    assert dt > 20 and int(it.status) == 1
    u_ref, _ = tt.cg(t_op, bt, constraints=t_cons, tol=1e-12, max_iter=600)
    np.testing.assert_allclose(ut.numpy(), u_ref.numpy(), rtol=1e-5,
                               atol=1e-10)
    # a call with its iterations already done returns the saved state
    u3, i3, d3 = t_ckpt.checkpointed_cg(t_op, bt, pt, constraints=t_cons,
                                        total_iter=dt)
    assert i3 is None and d3 == dt
    np.testing.assert_array_equal(u3.numpy(), ut.numpy())
