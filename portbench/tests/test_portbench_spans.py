"""portbench.spans: the program's spans read beside the card's trace, on
made timelines, and one measurement of a cell at a size the CPU holds."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from portbench import spans, trace
from portbench.tests.cells import tiny_cell

P = spans.PREFIX


def test_idle_by_span_on_a_made_timeline():
    # two 32-iteration graphs (10..40, 42..70 with a gap at 50..51 inside
    # the second) and a gap at 40..42 between them: the host woke from
    # cg.sync at 40.5 and replayed the next graph in cg.launch from 40.8
    dev = [("k", 10.0, 40.0), ("k", 42.0, 50.0), ("k", 51.0, 70.0)]
    host = [("portbench.traced", 0.0, 80.0),
            (P + "cg.solve", 1.0, 79.0),
            (P + "cg.prologue", 1.0, 9.0),
            (P + "cg.sync", 9.5, 40.5), ("aten::item", 9.5, 40.4),
            (P + "cg.launch", 40.8, 42.1), ("cudaGraphLaunch", 40.9, 42.0),
            (P + "cg.sync", 42.2, 70.5)]
    idle = spans.idle_by_span(dev, host, 0.0, 80.0)
    assert idle == {
        P + "cg.prologue": [pytest.approx(10e-6), 1],    # 0 .. 10: 5 in it
        P + "cg.launch": [pytest.approx(2e-6), 1],       # 40 .. 42
        P + "cg.sync": [pytest.approx(1e-6), 1],         # 50 .. 51
        P + "cg.solve": [pytest.approx(10e-6), 1]}       # 70 .. 80: 75
    assert spans.boundary_idle_pct(idle, 80e-6) == pytest.approx(2.5)
    # every gap is counted once, however many there are
    assert sum(v[0] for v in idle.values()) == pytest.approx(
        80e-6 - trace.summarize(dev, host, "portbench.traced").busy_s)
    # without program spans every gap lies outside them
    bare = [iv for iv in host if not iv[0].startswith(P)]
    assert spans.idle_by_span(dev, bare, 0.0, 80.0) == {
        spans.OUTSIDE: [pytest.approx(23e-6), 4]}
    assert spans.boundary_idle_pct({}, 1.0) == 0.0


def test_launch_gaps_hold_the_launches_start():
    dev = [("k", 10.0, 40.0), ("k", 42.0, 50.0), ("k", 51.0, 70.0)]
    host = [("cudaGraphLaunch", 40.9, 42.0), ("cudaGraphLaunch", 5.0, 6.0),
            ("cudaGraphLaunch", 30.0, 31.0), ("aten::item", 50.2, 50.3)]
    assert spans.launch_gaps(dev, host, 0.0, 80.0) == [
        pytest.approx(2e-6), pytest.approx(10e-6)]      # not while busy


def test_idle_by_span_sweeps_many_gaps():
    n = 20000
    dev = [("k", 10.0 * i, 10.0 * i + 9.0) for i in range(n)]
    host = [(P + "cg.solve", 0.0, 10.0 * n + 1.0)]
    host += [(P + ("cg.launch" if i % 2 else "cg.sync"), 10.0 * i + 8.5,
              10.0 * i + 10.5) for i in range(n)]
    idle = spans.idle_by_span(dev, host, 0.0, 10.0 * n)
    assert idle == {P + "cg.launch": [pytest.approx(n / 2 * 1e-6), n // 2],
                    P + "cg.sync": [pytest.approx(n / 2 * 1e-6), n // 2]}


def _event(name, s, e, kind, annotation):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: int(s * 1e3),
        end_ns=lambda: int(e * 1e3), device_type=lambda: kind,
        is_user_annotation=lambda: annotation)


def test_split_leaves_out_the_device_copies_of_annotations():
    events = [_event("k", 1, 2, DeviceType.CUDA, False),
              _event(P + "cg.launch", 0, 3, DeviceType.CUDA, False),
              _event(P + "cg.sync", 0, 3, DeviceType.CUDA, True),
              _event("portbench.traced", 0, 3, DeviceType.CUDA, False),
              _event(P + "cg.launch", 0, 3, DeviceType.CPU, True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    dev, host, copies = spans.split(prof)
    assert [d[0] for d in dev] == ["k"]
    assert [h[0] for h in host] == [P + "cg.launch"]
    assert copies == [2, 1]


def test_self_time_and_stage_seconds():
    rec = [(P + "refine.residual", 2, 1, 0, 3_000_000),
           (P + "cg.solve", 4, 3, 3_000_000, 9_000_000),
           (P + "refine.inner", 3, 1, 3_000_000, 10_000_000),
           (P + "refine.inner", 5, 1, 11_000_000, 15_000_000),
           (P + "refine.solve", 1, None, 0, 16_000_000)]
    assert spans.self_ms(rec, "refine.solve", "refine.inner") == \
        pytest.approx(5.0)
    assert spans.self_ms(rec, "plan.build", "plan.order") is None
    assert spans.span_seconds(rec)["refine.inner"] == \
        [pytest.approx(0.011), 2]


def test_measure_on_the_cpu():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = spans.measure(tiny_cell("tet10_box_1m_f64.pcg_f64"),
                            2 ** 31 + 77, 1, "cpu")
    finally:
        torch.set_num_threads(n)
    blocks = out["counts"]["cg.blocks"]
    assert blocks == -(-out["iterations"] // 32)
    assert out["counts"]["host_syncs"] == blocks + 1
    assert {"plan.build", "plan.to_device", "cg.solve"} <= \
        set(out["build_spans"])
    assert set(out["idle_by_span"]) <= {P + "cg.launch", P + "cg.sync",
                                        P + "cg.prologue", P + "cg.solve",
                                        spans.OUTSIDE}
    assert out["refine_self_ms"] is None
    assert all(len(v) == 1 for v in out["solve_s"].values())


def test_plan_split_on_the_cpu():
    mesh = tiny_cell("tet10_box_1m_f64.pcg_f64").config["mesh"]
    out = spans.plan_split(mesh, 2, "cpu")
    assert out["elements"] == 2 * 2 * 2 * 6
    assert set(out["spans"]) == {"plan.build"} | {
        "plan." + n for n in ("order", "clusters", "numbering", "slots",
                              "windows", "buckets", "tables", "to_device")}
    assert sum(v for k, v in out["spans"].items() if k != "plan.build") \
        <= out["spans"]["plan.build"] <= out["wall_s"]
