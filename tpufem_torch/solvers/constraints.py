"""SPC / RBE2 / RBE3 constraints (the port of tpufem.solvers.constraints).

Ingest format is tpufem's dict-list schema:

    spc_list  = [{'node': n, 'dofs': [...], 'value': v}, ...]
    rbe2_list = [{'master': m, 'slaves': [...], 'dofs': [...]}, ...]
    rbe3_list = [{'master': m, 'slaves': [...], 'dofs': [...],
                  'weights': [...]}, ...]

The tables are tpufem's, as host numpy arrays.  Enforcement on a device
field [N, nd] keeps tpufem's semantics: SPC pins exact values, RBE2 copies
master -> slaves, RBE3 sets the master to the weighted slave average.
RBE3's segment sum is a padded [C3, L] table of entries summed along its
rows (``rbe3_table``), a fixed order with no atomics, so two runs on the
card give the same bits.  ops.packed.PackedConstraints carries the same
tables in the packed layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def rbe3_table(cid: np.ndarray, n_cons: int) -> np.ndarray:
    """[n_cons, L] int64 entry indices of each RBE3 constraint, in entry
    order, padded with len(cid) (an entry of weight 0 that reads DOF 0)."""
    cid = np.asarray(cid, np.int64)
    counts = np.bincount(cid, minlength=n_cons) if cid.size else \
        np.zeros(n_cons, np.int64)
    L = max(int(counts.max()) if n_cons else 0, 1)
    table = np.full((n_cons, L), cid.size, np.int64)
    order = np.argsort(cid, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    pos = np.arange(cid.size) - starts[cid[order]]
    table[cid[order], pos] = order
    return table


def rbe3_average(xf: torch.Tensor, table: torch.Tensor, slave: torch.Tensor,
                 weights: torch.Tensor, wsum: torch.Tensor) -> torch.Tensor:
    """Weighted slave averages [C3] of the flat field xf: slave and weights
    padded by one entry (DOF 0, weight 0) that the table's pad reads."""
    vals = weights * xf[slave]
    return vals[table].sum(dim=1) / wsum


def _empty(dtype):
    return dataclasses.field(default_factory=lambda: np.zeros(0, dtype))


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Flattened constraint tables over n_nodes * dof_per_node DOFs (host
    numpy, tpufem's fields)."""

    free_mask: np.ndarray      # [n_dof] 1.0 free / 0.0 constrained (SPC+RBE2 slaves)
    spc_dofs: np.ndarray       # [S] int32
    spc_values: np.ndarray     # [S]
    n_nodes: int
    dof_per_node: int
    rbe2_slave_dofs: np.ndarray = _empty(np.int32)    # [R2]
    rbe2_master_dofs: np.ndarray = _empty(np.int32)   # [R2]
    rbe3_slave_dofs: np.ndarray = _empty(np.int32)    # [R3]
    rbe3_weights: np.ndarray = _empty(np.float64)     # [R3]
    rbe3_cid: np.ndarray = _empty(np.int32)           # [R3] constraint id
    rbe3_master_dofs: np.ndarray = _empty(np.int32)   # [C3]
    rbe3_weight_sums: np.ndarray = _empty(np.float64)  # [C3]
    spc_const: Optional[np.ndarray] = None  # [n_dof] SPC values (else 0)
    # device tensors per (device, dtype), made at first use
    _dev: dict = dataclasses.field(default_factory=dict, compare=False,
                                   repr=False)

    @property
    def mask2d(self) -> np.ndarray:
        return self.free_mask.reshape(self.n_nodes, self.dof_per_node)

    @property
    def spc_const2d(self) -> np.ndarray:
        c = self.spc_const if self.spc_const is not None else \
            np.zeros_like(self.free_mask)
        return c.reshape(self.n_nodes, self.dof_per_node)

    @property
    def shape2d(self):
        return (self.n_nodes, self.dof_per_node)

    @property
    def has_inhomogeneous(self) -> bool:
        return bool(self.spc_values.size)

    @property
    def has_sets(self) -> bool:
        return bool(self.rbe2_slave_dofs.size or self.rbe3_slave_dofs.size)

    # -- factory ----------------------------------------------------------
    @staticmethod
    def build(n_nodes: int, dof_per_node: int = 3,
              spc_list: Optional[Sequence[dict]] = None,
              rbe2_list: Optional[Sequence[dict]] = None,
              rbe3_list: Optional[Sequence[dict]] = None,
              fixed_nodes=None, dtype=np.float64) -> "Constraints":
        nd = dof_per_node
        n_dof = n_nodes * nd
        mask = np.ones(n_dof, dtype=dtype)

        spc_dofs, spc_vals = [], []
        if fixed_nodes is not None:
            for n in np.asarray(fixed_nodes).reshape(-1):
                for d in range(nd):
                    spc_dofs.append(int(n) * nd + d)
                    spc_vals.append(0.0)
        for spc in (spc_list or []):
            for d in spc["dofs"]:
                spc_dofs.append(int(spc["node"]) * nd + int(d))
                spc_vals.append(float(spc["value"]))

        r2_s, r2_m = [], []
        for r in (rbe2_list or []):
            for s in r["slaves"]:
                for d in r["dofs"]:
                    r2_s.append(int(s) * nd + int(d))
                    r2_m.append(int(r["master"]) * nd + int(d))

        r3_s, r3_w, r3_cid, r3_m, r3_ws = [], [], [], [], []
        cid = 0
        for r in (rbe3_list or []):
            ws = r["weights"]
            for d in r["dofs"]:
                for i, s in enumerate(r["slaves"]):
                    r3_s.append(int(s) * nd + int(d))
                    r3_w.append(float(ws[i]))
                    r3_cid.append(cid)
                r3_m.append(int(r["master"]) * nd + int(d))
                r3_ws.append(float(sum(ws)))
                cid += 1

        if spc_dofs:
            mask[np.asarray(spc_dofs, dtype=np.int64)] = 0.0
        if r2_s:
            mask[np.asarray(r2_s, dtype=np.int64)] = 0.0
        spc_const = np.zeros(n_dof, dtype=dtype)
        if spc_dofs:
            spc_const[np.asarray(spc_dofs, dtype=np.int64)] = \
                np.asarray(spc_vals, dtype=dtype)

        def arr(x, dt):
            return np.asarray(x, dtype=dt).reshape(-1)

        return Constraints(
            free_mask=mask, spc_dofs=arr(spc_dofs, np.int32),
            spc_values=arr(spc_vals, dtype), n_nodes=int(n_nodes),
            dof_per_node=nd,
            rbe2_slave_dofs=arr(r2_s, np.int32),
            rbe2_master_dofs=arr(r2_m, np.int32),
            rbe3_slave_dofs=arr(r3_s, np.int32),
            rbe3_weights=arr(r3_w, dtype),
            rbe3_cid=arr(r3_cid, np.int32),
            rbe3_master_dofs=arr(r3_m, np.int32),
            rbe3_weight_sums=arr(r3_ws, dtype),
            spc_const=spc_const)

    @staticmethod
    def fixed(n_nodes: int, fixed_nodes, dof_per_node: int = 3,
              dtype=np.float64) -> "Constraints":
        """Homogeneous all-DOF pin of the given nodes."""
        return Constraints.build(n_nodes, dof_per_node,
                                 fixed_nodes=fixed_nodes, dtype=dtype)

    # -- enforcement ------------------------------------------------------
    def _tables(self, x: torch.Tensor) -> dict:
        """The tables as tensors on x's device (floats in x's dtype), made
        at first use."""
        key = (x.device, x.dtype)
        if key not in self._dev:
            t = lambda a, d=x.dtype: torch.as_tensor(  # noqa: E731
                np.asarray(a), device=x.device).to(d)
            ln = torch.long
            n3 = self.rbe3_slave_dofs.size
            self._dev[key] = dict(
                mask=t(self.mask2d), spc_const=t(self.spc_const2d),
                spc_dofs=t(self.spc_dofs, ln),
                spc_values=t(self.spc_values),
                r2s=t(self.rbe2_slave_dofs, ln),
                r2m=t(self.rbe2_master_dofs, ln),
                r3s=t(np.append(self.rbe3_slave_dofs, 0), ln),
                r3w=t(np.append(self.rbe3_weights, 0.0)),
                r3m=t(self.rbe3_master_dofs, ln),
                r3ws=t(self.rbe3_weight_sums),
                r3table=t(rbe3_table(self.rbe3_cid,
                                     self.rbe3_master_dofs.size), ln)
                if n3 else None)
        return self._dev[key]

    def mask_like(self, x: torch.Tensor) -> torch.Tensor:
        """The free mask [N, nd] on x's device, in x's dtype."""
        return self._tables(x)["mask"]

    def apply_state(self, u: torch.Tensor) -> torch.Tensor:
        """Set the constrained values of a displacement-like field
        [N, nd]."""
        t = self._tables(u)
        if not self.has_sets:
            # SPC-only: mask and constant add, in the [N, nd] layout
            out = u * t["mask"]
            if np.any(self.spc_values):      # (adding zeros changes nothing)
                out = out + t["spc_const"]
            return out
        uf = u.reshape(-1).clone()
        if self.spc_dofs.size:
            uf[t["spc_dofs"]] = t["spc_values"]
        if self.rbe2_slave_dofs.size:
            uf[t["r2s"]] = uf[t["r2m"]]
        if self.rbe3_slave_dofs.size:
            uf[t["r3m"]] = rbe3_average(uf, t["r3table"], t["r3s"], t["r3w"],
                                        t["r3ws"])
        return uf.reshape(self.shape2d)

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        """Zero the constrained entries of a residual-like field [N, nd]."""
        return r * self.mask_like(r)
