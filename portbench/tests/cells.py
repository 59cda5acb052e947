"""Cells of BENCHMARK.json shrunk to a size that the CPU tests hold: the
same configuration, traffic and path, with the mesh's counts replaced."""
from __future__ import annotations

import dataclasses

from portbench import mesh as meshmod
from portbench import spec


def tiny_cell(workload: str, n=(1, 1, 2)) -> spec.Cell:
    cell = spec.load(workload)
    cfg = dict(cell.config)
    cfg["mesh"] = dict(cfg["mesh"], n=list(n))
    cfg["elements"], cfg["nodes"] = meshmod.sizes(n)
    return dataclasses.replace(cell, config=cfg)


WORKLOADS = ("tet10_box_1m.refined_f32", "tet10_box_1m_f64.pcg_f64",
             "tet10_box_1m_assembled.assembled_f64")
