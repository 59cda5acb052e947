"""The general load-case generator: one traffic file in, the window's load
cases out.

A traffic file (``traffic/<mix>.json``) names the loaded face, the cases
in the order the window solves them, the accuracy each solve must reach,
and how the seed varies them.  A case is of the kind ``per_node``: every
node of the face carries ``force`` newtons along ``direction``.

The window solves the cases one after another in the file's order,
round and round.  The seed draws the sign of each solve's load and
nothing else: a load and its negative take the same arithmetic to the
last bit, so every seed asks for the same work while the inputs and the
answers differ.  Every force is rounded to the nearest
float32, so that a path that reads the load in float32 solves the same
problem as the float64 reference.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import mesh as meshmod

SIGNS_DRAWN = 4096


def rng(seed: int) -> np.random.Generator:
    """The generator of a run's seed (any whole number)."""
    return np.random.default_rng(int(seed) % 2 ** 64)


def _unit(v) -> np.ndarray:
    v = np.asarray(v, np.float64)
    return v / np.linalg.norm(v)


def case_load(case: dict, coords: np.ndarray, face: np.ndarray
              ) -> np.ndarray:
    """[N, 3] float64 nodal forces of one case (float32-exact values)."""
    if case["kind"] != "per_node":
        raise ValueError(f"unknown load case kind {case['kind']!r}")
    b = np.zeros((coords.shape[0], 3))
    b[face] = float(case["force"]) * _unit(case["direction"])
    return b.astype(np.float32).astype(np.float64)


class LoadStream:
    """The window's load cases: `warm` is the first case with its sign +,
    `case(i)` is the i-th solve's (name, sign, [N, 3] load).  Both signs of
    every case are made once, at set-up, so that the window only picks."""

    def __init__(self, traffic: dict, coords: np.ndarray, seed: int):
        f = traffic["face"]
        self.face = meshmod.boundary_nodes(coords, f["axis"], f["value"])
        if self.face.size == 0:
            raise ValueError(f"no node on the loaded face {f}")
        self.cases = traffic["cases"]
        self.loads: List[Tuple[np.ndarray, np.ndarray]] = []
        for c in self.cases:
            b = case_load(c, coords, self.face)
            self.loads.append((b, -b))
        self.signs = rng(seed).integers(0, 2, SIGNS_DRAWN)

    @property
    def warm(self) -> np.ndarray:
        return self.loads[0][0]

    def case(self, i: int) -> Tuple[str, int, np.ndarray]:
        k = i % len(self.cases)
        s = int(self.signs[i % SIGNS_DRAWN])
        return self.cases[k]["name"], (1, -1)[s], self.loads[k][s]
