"""Deterministic gather/scatter plans for the matrix-free operator.

The port of tpufem/ops/scatter.py.  The host build stays numpy plus the
native radix argsort, and gives tables bitwise equal to tpufem's:

* gather:  ``u[conn]``                                  [M, k, nd]
* scatter: per-node incidence bins over the element rows, grouped into at
  most four power-of-two width classes by valence; each class is one
  indexing into the rows with an appended zero row (the padding entries
  point there) and a fixed-width sum.  Fixed bins, fixed order, no
  atomics: the result is the same on every run.

tpufem runs these as XLA ``take``s outside any kernel; here they are torch
indexing.  tpufem's row-packing and position-chunking modes are TPU
workarounds that it disables itself, and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def element_dofs(conn, dof_per_node: int = 3) -> np.ndarray:
    """[M, k*dof] global DOF ids from connectivity [M, k] (host-side)."""
    conn = np.asarray(conn)
    M, k = conn.shape
    d = conn[:, :, None] * dof_per_node + np.arange(dof_per_node)[None, None, :]
    return d.reshape(M, k * dof_per_node).astype(np.int32)


def _stable_argsort_i32(flat: np.ndarray) -> np.ndarray:
    from .. import native
    perm = native.radix_argsort(np.ascontiguousarray(flat, np.int32))
    if perm is None:
        perm = np.argsort(flat, kind="stable").astype(np.int32)
    return perm


def _classed_bins(keys: np.ndarray, positions: np.ndarray, pad_index: int,
                  max_classes: int = 4):
    """Group entry `positions` into per-key bins, classed by width.

    Returns (classes, key_order) where classes is a list of
    (width, inc_flat [n_c * width] int32) and key_order the unique keys in
    emission order (class-major, key-sorted within class).
    """
    keys = np.asarray(keys, np.int64)
    positions = np.asarray(positions, np.int64)
    order = _stable_argsort_i32(keys.astype(np.int32)).astype(np.int64)
    sk = keys[order]
    uniq, starts_idx, cnt = np.unique(sk, return_index=True,
                                      return_counts=True)
    widths = np.maximum(1, 1 << np.ceil(
        np.log2(np.maximum(cnt, 1))).astype(np.int64))
    uniq_w = sorted(set(widths.tolist()))
    while len(uniq_w) > max_classes:
        vols = []
        for i in range(len(uniq_w) - 1):
            sel = (widths >= uniq_w[i]) & (widths <= uniq_w[i + 1])
            vols.append(int(sel.sum()) * uniq_w[i + 1])
        j = int(np.argmin(vols))
        widths[widths == uniq_w[j]] = uniq_w[j + 1]
        uniq_w.pop(j)
    # every sorted entry knows its unique-key id and its column within the
    # bin; per class, map unique ids to class rows
    ukey_of_entry = np.repeat(np.arange(uniq.size), cnt)
    col_of_entry = np.arange(sk.size) - np.repeat(starts_idx, cnt)
    pos_of_entry = positions[order]
    classes = []
    key_order: List[np.ndarray] = []
    for w in uniq_w:
        sel = np.nonzero(widths == w)[0]
        if sel.size == 0:
            continue
        row_of_uniq = np.full(uniq.size, -1, np.int64)
        row_of_uniq[sel] = np.arange(sel.size)
        mask = row_of_uniq[ukey_of_entry] >= 0
        inc = np.full((sel.size, w), pad_index, dtype=np.int32)
        inc[row_of_uniq[ukey_of_entry[mask]], col_of_entry[mask]] = \
            pos_of_entry[mask]
        classes.append((int(w), inc.reshape(-1)))
        key_order.append(uniq[sel])
    key_order = (np.concatenate(key_order) if key_order
                 else np.zeros(0, np.int64))
    return classes, key_order


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.int32), device=device)


@dataclasses.dataclass(frozen=True)
class CombinePlan:
    """Deterministic per-key reduce of value rows: y[key] = sum(rows[pos]).

    inc[c] [n_c * widths[c]] int32 lists, per key of class c, the row
    positions of its entries (padding: n_rows, the appended zero row);
    inv_order [n_keys] int32 is each key's row in the concatenated class
    sums (a key with no entry reads the trailing zero row)."""

    inc: Tuple[torch.Tensor, ...]
    widths: Tuple[int, ...]
    inv_order: torch.Tensor
    n_keys: int
    n_rows: int

    def to(self, device) -> "CombinePlan":
        dev = torch.device(device)
        return dataclasses.replace(
            self, inc=tuple(t.to(dev) for t in self.inc),
            inv_order=self.inv_order.to(dev))

    @staticmethod
    def from_arrays(inc: Sequence[np.ndarray], widths: Sequence[int],
                    inv_order: np.ndarray, n_rows: int,
                    device=None) -> "CombinePlan":
        """Plan from tpufem's single-level tables (CombinePlan.inc,
        .meta.class_widths, .inv_order) as numpy; device=None means the
        CUDA card."""
        dev = resolve_device(device)
        return CombinePlan(inc=tuple(_tensor(a, dev) for a in inc),
                           widths=tuple(int(w) for w in widths),
                           inv_order=_tensor(inv_order, dev),
                           n_keys=int(np.asarray(inv_order).shape[0]),
                           n_rows=int(n_rows))

    @staticmethod
    def build(keys, positions, n_rows: int, n_keys: int,
              max_classes: int = 4, device=None) -> "CombinePlan":
        classes, key_order = _classed_bins(keys, positions, n_rows,
                                           max_classes)
        inv_order = np.full(n_keys, key_order.size, np.int64)
        inv_order[key_order] = np.arange(key_order.size)
        return CombinePlan.from_arrays([a for _, a in classes],
                                       [w for w, _ in classes],
                                       inv_order.astype(np.int32), n_rows,
                                       device)

    def __call__(self, rows: torch.Tensor) -> torch.Tensor:
        """rows [n_rows, nd] -> per-key sums [n_keys, nd]."""
        nd = rows.shape[-1]
        zero = rows.new_zeros((1, nd))
        padded = torch.cat([rows, zero], dim=0)
        parts = [padded[ic.long()].reshape(-1, w, nd).sum(dim=1)
                 for ic, w in zip(self.inc, self.widths)]
        y_sorted = torch.cat(parts + [zero], dim=0)
        return y_sorted[self.inv_order.long()]


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """Precomputed deterministic gather/scatter for one element block."""

    conn: torch.Tensor      # [M, k] int32: row-gather indices
    dofs: torch.Tensor      # [M, k*nd] int32: flat DOF ids
    combine: CombinePlan    # element rows [M*k, nd] -> per-node sums
    perm: torch.Tensor      # [M*k*nd] int32 stable sort of dofs
    segments: torch.Tensor  # [M*k*nd] int32 sorted DOF ids
    n_nodes: int
    dof_per_node: int

    @property
    def n_dof(self) -> int:
        return self.n_nodes * self.dof_per_node

    @property
    def n_rows(self) -> int:
        return self.conn.numel()

    @property
    def device(self) -> torch.device:
        return self.conn.device

    def to(self, device) -> "ScatterPlan":
        dev = torch.device(device)
        return dataclasses.replace(
            self, conn=self.conn.to(dev), dofs=self.dofs.to(dev),
            combine=self.combine.to(dev), perm=self.perm.to(dev),
            segments=self.segments.to(dev))

    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(conn, dofs, perm, segments, combine: CombinePlan,
                    n_nodes: int, dof_per_node: int = 3,
                    device=None) -> "ScatterPlan":
        """Plan from tpufem's tables as numpy (conn, dofs, perm,
        segments) and a CombinePlan; device=None means the CUDA card."""
        dev = resolve_device(device)
        return ScatterPlan(conn=_tensor(conn, dev), dofs=_tensor(dofs, dev),
                           combine=combine.to(dev), perm=_tensor(perm, dev),
                           segments=_tensor(segments, dev),
                           n_nodes=int(n_nodes),
                           dof_per_node=int(dof_per_node))

    @staticmethod
    def build(conn, n_nodes: int, dof_per_node: int = 3,
              max_classes: int = 4, device=None) -> "ScatterPlan":
        """Build on the host (numpy + native radix sort) and move the
        tables to `device` (None: the CUDA card)."""
        dev = resolve_device(device)
        conn = np.asarray(conn)
        M, k = conn.shape
        nd = dof_per_node
        dofs = element_dofs(conn, nd)
        flat = dofs.reshape(-1)
        perm = _stable_argsort_i32(flat)
        rows_node = conn.reshape(-1).astype(np.int64)  # node per (e, l) row
        combine = CombinePlan.build(rows_node, np.arange(M * k), M * k,
                                    n_nodes, max_classes=max_classes,
                                    device=dev)
        return ScatterPlan.from_arrays(conn, dofs, perm, flat[perm], combine,
                                       n_nodes, nd, dev)

    # -- fast paths ------------------------------------------------------
    def gather_nodes(self, u2d: torch.Tensor) -> torch.Tensor:
        """u [N, nd] -> per-element nodal values [M, k, nd] (row gather)."""
        return u2d[self.conn.long()]

    def gather(self, u_flat: torch.Tensor) -> torch.Tensor:
        """u_flat [n_dof] -> [M, k*nd]."""
        g = self.gather_nodes(u_flat.reshape(self.n_nodes,
                                             self.dof_per_node))
        return g.reshape(g.shape[0], -1)

    def scatter(self, element_values: torch.Tensor) -> torch.Tensor:
        """[M, k*nd] element values -> [n_dof] deterministic sum."""
        rows = element_values.reshape(self.n_rows, self.dof_per_node)
        return self.combine(rows).reshape(-1)

    # -- sorted-stream scatter (kept for validation) ---------------------
    def scatter_sorted(self, element_values: torch.Tensor) -> torch.Tensor:
        """The same sum through the sorted DOF stream: a segment
        reduction over perm-ordered values (deterministic)."""
        vals = element_values.reshape(-1)[self.perm.long()]
        lengths = torch.bincount(self.segments.long(), minlength=self.n_dof)
        return torch.segment_reduce(vals, "sum", lengths=lengths)
