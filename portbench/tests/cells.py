"""Cells of BENCHMARK.json shrunk to a size that the CPU tests hold: the
same configuration, traffic and path, with the mesh's counts replaced and
the configuration's ``cpu_test`` entry applied."""
from __future__ import annotations

import dataclasses

from portbench import mesh as meshmod
from portbench import spec


def tiny_cell(workload: str, n=(1, 1, 2), root: str = spec.ROOT
              ) -> spec.Cell:
    """The cell at the mesh counts `n`.  A configuration may hold a
    ``cpu_test`` object of top-level keys that replace its own at the CPU
    size (a part count, say); elements and nodes follow from the mesh's
    generator."""
    cell = spec.load(workload, root)
    cfg = dict(cell.config)
    cfg["mesh"] = dict(cfg["mesh"], n=list(n))
    cfg.update(cfg.pop("cpu_test", {}))
    gen = meshmod.generator(cfg["mesh"]["generator"])
    cfg["elements"], cfg["nodes"] = gen.sizes(cfg["mesh"]["n"])
    return dataclasses.replace(cell, config=cfg)


WORKLOADS = tuple(spec.workloads())
