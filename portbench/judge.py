"""Deciding ``correct``: the plain reference judges what the window
produced.

Once the window has closed and the program's state is freed, the float64
reference (portbench.reference) is built from the benchmark's own arrays
(coordinates, connectivity, material, fixed nodes) on the element that
the configuration names (``portbench/reference/elements/<type>.py``) and
judges every answer that the window delivered, converged or not, and the
diagonal that the path's set-up derived.  The numbers compared, each with
its limit:

* ``resid_max``: the largest ||P (b - K u)|| / ||P b|| of the window's
  answers, K the reference's operator and P the free-DOF projection; the
  limit is the accuracy that the traffic states;
* ``fixed_max``: the largest |u| on a fixed DOF; the limit is 0 (the
  configuration pins those nodes exactly);
* ``diag_rel``: the largest relative difference of the path's diagonal
  from the reference's diag(K), over all DOFs; the limit is the path's
  DIAG_LIMIT (None: printed, not compared).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .reference import elasticity as ref


@dataclasses.dataclass
class Number:
    name: str
    value: float
    limit: Optional[float]        # None: printed, not compared

    @property
    def ok(self) -> bool:
        return self.limit is None or self.value <= self.limit


def judge(coords, conn, fixed, element: dict, material: dict, answers,
          diag, tol_rel: float, diag_limit, device):
    """answers: [(b, u)] of [N, 3] float64 arrays; element: the
    configuration's "element" entry.  Returns (numbers, per-answer relative
    residuals)."""
    op = ref.Elasticity(coords, conn, element["type"], material["E"],
                        material["nu"], device=device)
    if tuple(op.dN.shape[:2]) != (element["points"], element["nodes"]):
        raise ValueError(f"the reference's {element['type']} has "
                         f"{op.dN.shape[0]} points and {op.dN.shape[1]} "
                         f"nodes; the configuration says {element}")
    free = ref.free_mask(coords.shape[0], fixed, device=device)
    resid = [ref.relative_residual(op, u, b, free) for b, u in answers]
    fixed_abs = [float(np.abs(u[fixed]).max()) if len(fixed) else 0.0
                 for _, u in answers]
    nums: List[Number] = [
        Number("resid_max", max(resid) if resid else float("inf"),
               float(tol_rel)),
        Number("fixed_max", max(fixed_abs) if fixed_abs else float("inf"),
               0.0)]
    if diag is not None:
        d_ref = op.diagonal()
        d = torch.as_tensor(diag, dtype=torch.float64, device=d_ref.device)
        rel = float(((d - d_ref).abs() / d_ref.abs()).max())
        nums.append(Number("diag_rel", rel, diag_limit))
    return nums, resid
