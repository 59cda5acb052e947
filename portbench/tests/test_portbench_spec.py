"""BENCHMARK.json against the benchmark's contract, and every file that it
names found by name."""
import importlib
import json
import os
import re

import pytest

from portbench import mesh as meshmod
from portbench import spec
from portbench.reference import elements

ROOT = spec.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = spec.workloads()


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert len(BENCH["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and not p.startswith("/")


def test_names_units_and_text_fields():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    texts = [e[k] for e in entries for k in ("why", "layer") if k in e]
    texts += [c["source"] for c in BENCH["configs"]] + BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_entries():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load_by_name(workload):
    cell = spec.load(workload)
    assert cell.chips == 1
    pm = importlib.import_module("portbench.paths."
                                 + spec.module_name(cell.path))
    layer = {m["name"] for m in cell.per_layer}
    assert f"{pm.OPERATOR}_apply_roofline" in layer
    assert pm.DTYPE in ("float32", "float64")
    assert callable(pm.Path)
    for m in cell.end_to_end + cell.per_layer:
        mod = importlib.import_module("portbench.metrics."
                                      + spec.module_name(m["name"]))
        assert callable(mod.read)
    assert cell.end_to_end and cell.per_layer
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    cfg = cell.config
    gen = meshmod.generator(cfg["mesh"]["generator"])
    assert (cfg["elements"], cfg["nodes"]) == gen.sizes(cfg["mesh"]["n"])
    el = elements.load(cfg["element"]["type"])
    assert el.gradients(el.POINTS).shape == (cfg["element"]["points"],
                                             cfg["element"]["nodes"], 3)
    for c in cell.traffic["cases"]:
        assert NAME.match(c["name"])


@pytest.mark.parametrize("config", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_entries(config):
    with open(os.path.join(ROOT, config["file"])) as f:
        cfg = json.load(f)
    assert cfg["name"] == config["name"]
    assert sorted(cfg["reduced"]) == sorted(config["reduced"])
    assert config["file"].startswith("portbench/configs/")
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
