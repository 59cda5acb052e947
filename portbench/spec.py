"""What a cell is, read from BENCHMARK.json and the files it names.

Every part of a cell is found by name, so that a later change adds a cell,
a configuration, a mesh generator, an element, a traffic mix, a path or a
metric by adding files and entries only:

* the configuration: the ``file`` of its entry in ``configs``;
* the mesh: the generator that the configuration's ``mesh`` entry names,
  ``portbench/meshes/<generator>.py`` (portbench.meshes);
* the element of the reference that judges the answers: the type of the
  configuration's ``element`` entry,
  ``portbench/reference/elements/<type>.py``
  (portbench.reference.elements); the paths hand the same type to the
  program;
* the traffic mix: ``portbench/traffic/<traffic>.json``;
* the path that the window drives: the cell's name less its configuration's
  name and the dot after it (``tet10_box_1m.refined_f32`` runs
  ``portbench/paths/refined_f32.py``), whose ``OPERATOR`` is any name
  that has a ``<OPERATOR>_apply_roofline`` metric;
* each metric: ``portbench/metrics/<name>.py`` (a ``.`` or ``-`` in a name
  is ``_`` in its file's name).

The cell reports every end-to-end metric whose ``workloads`` list names it
(all cells where there is no list), and every per-layer metric whose
``workloads`` list names it (where there is no list: every cell that
reports the metric's ``moves``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def module_name(name: str) -> str:
    """The Python module name of a path or metric name."""
    return name.replace(".", "_").replace("-", "_")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file's content
    traffic: dict           # the traffic file's content
    path: str               # the path module's name
    chips: int
    end_to_end: List[dict]  # BENCHMARK.json entries this cell reports
    per_layer: List[dict]


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def _bench(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workloads(root: str = ROOT) -> List[str]:
    """The names of BENCHMARK.json's cells, in its order."""
    return [w["name"] for w in _bench(root)["workloads"]]


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _bench(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    prefix = w["config"] + "."
    if not workload.startswith(prefix):
        raise ValueError(f"workload {workload!r} does not start with its "
                         f"configuration's name and a dot ({prefix!r})")
    with open(os.path.join(root, cfg["file"])) as f:
        config = json.load(f)
    with open(os.path.join(PKG, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in moved)]
    return Cell(workload, config, traffic, workload[len(prefix):],
                int(w["chips"]), e2e, layer)
