"""Distributed partial-assembly operator: halo exchange + geometry factors
(the port of tpufem/parallel/halo_partial.py).

Each part stores only its quadrature geometry (J^-1 and w * detJ) and no
element stiffness, so a part's footprint is set by its mesh slice.  On
top of parallel.halo's neighbour exchange this adds the interior/boundary
element split: each part's elements are ordered interior-first, and the
interior batch reads owned rows only.  On a GroupMesh the ghost exchange
is posted (batch_isend_irecv) before the interior batch and waited for
after it, the torch form of tpufem's overlap split; on a PartMesh the
exchange completes at once.  The boundary batch, and only it, reads the
ghosts.  The results are the same either way (elementwise element math).

Deterministic: fixed-order bins, fixed round order, psum scalars.  The
element math is the port's ops.partial.pa_apply_components, as in tpufem
(XLA einsums there, no Pallas kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.partial import pa_apply_components
from .dist import (PartSystem, _Reorder, bin_sum, gather_rows,
                   inverse_diagonal, make_mesh_1d, node_bins,
                   owned_numbering, _set_mask_and_jacobi)
from .halo import (HaloExchange, exchange_tables, ghost_lists,
                   local_connectivity)


@dataclasses.dataclass(frozen=True)
class _HPMeta:
    n_parts: int
    block_rows: int
    ghost_rows: int
    halo_width: int
    # each round is a tuple of (src, dst) part pairs forming a partial
    # permutation (every part sends <= 1 and receives <= 1 per round);
    # cross-host rounds come first
    rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    elems_per_part: int
    interior_cut: int          # static count of guaranteed-interior elements
    nodes_per_elem: int
    n_q: int
    n_qj: int
    n_nodes: int
    lam: float
    mu: float
    part_shape: Optional[Tuple[int, int]] = None  # (hosts, chips) hierarchy
    dcn_pairs: int = 0         # halo pairs crossing the host boundary
    ici_pairs: int = 0
    dcn_halo_rows: int = 0     # sum of halo rows shipped across hosts


def _color_rounds(pairs, weight) -> list:
    """Greedy edge-colouring of directed (src, dst) halo pairs into rounds.

    Each round is a partial permutation (distinct sources, distinct
    destinations) usable as one ppermute; heavy pairs are placed first so
    the round count ~ max in/out degree and the per-round H padding stays
    balanced (a copy of tpufem's)."""
    order = sorted(range(len(pairs)), key=lambda i: (-weight[i], pairs[i]))
    rounds, used_s, used_d = [], [], []
    for i in order:
        s, d = pairs[i]
        for ri in range(len(rounds)):
            if s not in used_s[ri] and d not in used_d[ri]:
                rounds[ri].append((s, d))
                used_s[ri].add(s)
                used_d[ri].add(d)
                break
        else:
            rounds.append([(s, d)])
            used_s.append({s})
            used_d.append({d})
    return [tuple(sorted(r)) for r in rounds]


@dataclasses.dataclass(frozen=True)
class HaloPartialPartition(_Reorder):
    """Per-part geometry (tensors on the build's device) + exchange plan
    (host numpy, tpufem's tables); leading axis = parts."""

    Jinv: torch.Tensor         # [P, Mp, qJ, 9]
    W: torch.Tensor            # [P, Mp, q] (zero rows pad)
    dN: tuple                  # static [q][k][3] nested tuple
    conn_local: np.ndarray     # [P, Mp, k] slots into [owned | ghost]
    inc: np.ndarray            # [P, B+G, Wb] bins into local Fe rows
                               # (real elements only; pad Mp*k)
    send_idx: np.ndarray       # [P, R, H]
    recv_slot: np.ndarray      # [P, R, H]
    recv_mask: np.ndarray      # [P, R, H]
    new_from_old: np.ndarray
    old_from_new: np.ndarray
    meta: _HPMeta

    @staticmethod
    def build(coords, conn, etype: str, E: float, nu: float, labels,
              n_parts: int, rule: str = "default", dtype=None,
              affine: Optional[bool] = None,
              part_shape: Optional[Tuple[int, int]] = None,
              device=None) -> "HaloPartialPartition":
        from ..core.device import resolve_device
        from ..core.materials import lame_parameters
        from ..elements.tables import element_table
        from ..ops.partial import chunked_geometry
        from .partition import owner_of_nodes

        dev = resolve_device(device)
        conn = np.asarray(conn)
        labels = np.asarray(labels)
        M, k = conn.shape
        coords_t = torch.as_tensor(np.asarray(coords.cpu() if
                                              torch.is_tensor(coords)
                                              else coords), device=dev)
        n_nodes = coords_t.shape[0]
        table = element_table(etype, rule)
        dtype = dtype or coords_t.dtype

        owner = owner_of_nodes(conn, labels, n_nodes)
        B, rank, new_from_old, old_from_new = owned_numbering(owner, n_parts)
        Mp = int(np.bincount(labels, minlength=n_parts).max())
        ghosts, G, H_per = ghost_lists(conn, labels, owner, n_parts)
        pairs_all = [(q_, p) for q_ in range(n_parts) for p in range(n_parts)
                     if q_ != p and H_per[q_, p] > 0]
        host_of = ((lambda p: p // part_shape[1]) if part_shape is not None
                   else (lambda p: 0))
        dcn = [e for e in pairs_all if host_of(e[0]) != host_of(e[1])]
        ici = [e for e in pairs_all if host_of(e[0]) == host_of(e[1])]
        rounds = (_color_rounds(dcn, [int(H_per[e]) for e in dcn])
                  + _color_rounds(ici, [int(H_per[e]) for e in ici]))
        rounds = [r for r in rounds if r]
        H = max(1, int(max((H_per[e] for e in pairs_all), default=1)))
        R = max(1, len(rounds))
        dcn_rows = int(sum(H_per[e] for e in dcn))

        # per-part element order: interior (all nodes owned) first
        conn_local = np.zeros((n_parts, Mp, k), np.int64)
        esel = np.full((n_parts, Mp), -1, np.int64)   # original element ids
        interior_counts = []
        for p in range(n_parts):
            sel = np.nonzero(labels == p)[0]
            is_int = (owner[conn[sel]] == p).all(axis=1)
            sel_ord = np.concatenate([sel[is_int], sel[~is_int]])
            interior_counts.append(int(is_int.sum()))
            esel[p, :sel.size] = sel_ord
            conn_local[p, :sel.size] = local_connectivity(
                conn[sel_ord], p, owner, rank, ghosts[p], B, n_nodes)
        Mi_cut = min(interior_counts) if interior_counts else 0

        mdt = np.float64 if dtype == torch.float64 else np.float32
        send_idx, recv_slot, recv_mask = exchange_tables(
            rounds, ghosts, owner, rank, n_parts, R, H, B, G, mdt)

        # local node-binned incidence over the interior-first row order of
        # each part's REAL elements.  tpufem also bins the padding
        # elements' rows (conn_local 0, zero W) into node 0's bin, where
        # they add exact zeros; that bin is then as wide as k times the
        # largest part's surplus (6,980 at box_tet10(55) in (2, 2) parts:
        # an int64 table of ~90 GB while it is built), so the port leaves
        # them out: the same sums, and tpufem's table with those entries
        # set to the fill and cut to this width
        n_real = np.bincount(labels, minlength=n_parts) * k
        Wb = 1
        for p in range(n_parts):
            rows = conn_local[p].reshape(-1)[:n_real[p]]
            Wb = max(Wb, int(np.bincount(rows, minlength=B + G).max()))
        inc = np.empty((n_parts, B + G, Wb), np.int64)
        for p in range(n_parts):
            node_bins(conn_local[p].reshape(-1)[:n_real[p]], B + G, Wb,
                      Mp * k, inc[p])

        # geometry factors per part, in element chunks
        conn_sel = torch.as_tensor(conn[np.maximum(esel.reshape(-1), 0)],
                                   device=dev)
        Jinv, Wq, affine_meas = chunked_geometry(coords_t.to(dtype),
                                                 conn_sel, table, dtype)
        Wq = Wq * torch.as_tensor(esel.reshape(-1) >= 0, device=dev).to(
            dtype)[:, None]
        if affine is None:
            affine = affine_meas
        if affine:
            Jinv = Jinv[:, :1]
        qJ = Jinv.shape[1]
        q = Wq.shape[1]
        lam, mu = lame_parameters(E, nu)

        meta = _HPMeta(n_parts, B, G, H,
                       tuple(tuple(r) for r in rounds), Mp, Mi_cut, k, q, qJ,
                       n_nodes, float(lam), float(mu),
                       part_shape=(tuple(part_shape) if part_shape is not None
                                   else None), dcn_pairs=len(dcn),
                       ici_pairs=len(ici), dcn_halo_rows=dcn_rows)
        dNt = tuple(tuple(tuple(float(v) for v in row) for row in pt)
                    for pt in np.asarray(table.dN))
        i32 = lambda a: a.astype(np.int32)  # noqa: E731
        return HaloPartialPartition(
            Jinv=Jinv.reshape(n_parts, Mp, qJ, 9).contiguous(),
            W=Wq.reshape(n_parts, Mp, q).contiguous(), dN=dNt,
            conn_local=i32(conn_local), inc=i32(inc), send_idx=i32(send_idx),
            recv_slot=i32(recv_slot), recv_mask=recv_mask,
            new_from_old=i32(new_from_old), old_from_new=i32(old_from_new),
            meta=meta)


class HaloPartialFEM(PartSystem):
    """Distributed matrix-free system: geometry-factor compute + halo
    exchange with the interior/boundary split."""

    width = 3

    def __init__(self, mesh, axis, part: HaloPartialPartition,
                 free_mask=None, M_inv=None, serialize_exchange: bool = False):
        """serialize_exchange: gather the interior batch from the
        post-exchange rows too (tpufem's measurement knob).  The results
        are identical (interior rows are owned rows either way); only the
        interior batch's wait on the exchange changes."""
        self.axis = axis
        self.part = part
        m = part.meta
        self.rows_per_part = m.block_rows
        self.serialize_exchange = serialize_exchange
        self._init_system(mesh, free_mask, M_inv)
        L, Mi, Mp = mesh.L, m.interior_cut, m.elems_per_part
        Jinv, W = mesh.take(part.Jinv), mesh.take(part.W)
        # the interior and boundary batches, each one contiguous block over
        # the local parts (the element math is elementwise over them)
        self.batches = []
        for a, b in ((0, Mi), (Mi, Mp)):
            self.batches.append((
                mesh.take(part.conn_local[:, a:b]).long(),
                Jinv[:, a:b].reshape(L * (b - a), m.n_qj, 9).contiguous(),
                W[:, a:b].reshape(L * (b - a), m.n_q).contiguous()))
        self.inc = mesh.take(part.inc).long()
        self.exchange = HaloExchange(
            mesh, self._lidx, part.send_idx, part.recv_slot, part.recv_mask,
            m.rounds, m.block_rows, m.ghost_rows)
        self.dN = np.asarray(part.dN)

    @property
    def dtype(self) -> torch.dtype:
        return self.batches[1][2].dtype

    def _pa(self, u_src: torch.Tensor, batch) -> torch.Tensor:
        """Element forces of one batch: rows [L, n*k, 3] from the slots of
        u_src [L, B+G+1, 3]."""
        conn_b, Jb, Wb = batch
        L, n, k = conn_b.shape
        if n == 0:
            return u_src.new_zeros((L, 0, 3))
        ue = gather_rows(u_src, self._lidx, conn_b).reshape(L * n, k, 3)
        cols = tuple(ue[..., c] for c in range(3))
        m = self.part.meta
        Fe = pa_apply_components(cols, Jb, Wb, self.dN, m.lam, m.mu)
        return torch.stack(Fe, dim=-1).reshape(L, n * k, 3)

    def _spmv_body(self, u: torch.Tensor) -> torch.Tensor:
        m = self.part.meta
        L = u.shape[0]
        u_pad = torch.cat([u, u.new_zeros((L, m.ghost_rows + 1, 3))], dim=1)
        handles = self.exchange.start(u)
        if not self.serialize_exchange:
            # interior batch: owned rows only, computed while the ghost
            # rounds are in flight
            Fe_int = self._pa(u_pad, self.batches[0])
        u_loc = self.exchange.finish(handles, u_pad)
        if self.serialize_exchange:
            Fe_int = self._pa(u_loc, self.batches[0])
        Fe_bnd = self._pa(u_loc, self.batches[1])
        rows = torch.cat([Fe_int, Fe_bnd], dim=1)
        return self.exchange.reverse(bin_sum(rows, self._lidx, self.inc))

    def _diag_rows(self) -> torch.Tensor:
        """Assembled-diagonal contributions [L, Mp*k, 3] (tpufem's
        _diag_shard arithmetic)."""
        m = self.part.meta
        dN = self.dN
        q, k = dN.shape[0], dN.shape[1]
        lam, mu = m.lam, m.mu
        L = self.mesh.L
        out = []
        for _, Jf, W in self.batches:
            qJ = Jf.shape[1]
            d_cols = [None, None, None]
            for qi in range(q):
                Wq = W[:, qi]
                for a in range(3):
                    col = []
                    for kk in range(k):
                        g = [sum(float(dN[qi, kk, j])
                                 * Jf[:, min(qi, qJ - 1), 3 * i + j]
                                 for j in range(3)) for i in range(3)]
                        n2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
                        col.append(Wq * ((lam + mu) * g[a] * g[a] + mu * n2))
                    col = torch.stack(col, dim=1)
                    d_cols[a] = col if d_cols[a] is None else d_cols[a] + col
            out.append(torch.stack(d_cols, dim=-1).reshape(L, -1, 3))
        return torch.cat(out, dim=1)

    def jacobi_preconditioner(self) -> torch.Tensor:
        diag = self.exchange.reverse(bin_sum(self._diag_rows(), self._lidx,
                                             self.inc))
        return inverse_diagonal(diag).reshape(self.n_local_rows, 3)


def build_halo_partial_fem(coords, conn, etype: str, E: float, nu: float,
                           mesh=None, axis=None, fixed_nodes=None,
                           labels=None, seed: int = 0, dtype=None,
                           precondition: bool = True,
                           part_shape: Optional[Tuple[int, int]] = None,
                           device=None):
    """One-call setup of the geometry-factor halo-distributed system.

    part_shape=(hosts, chips_per_host) selects the 2-level hierarchy: a
    (hosts, chips) part mesh, host-then-chip hierarchical partitioning and
    cross-host rounds first.  Default: a flat mesh.  mesh=None:
    make_mesh_1d(None) or make_mesh_2d(part_shape) on `device`."""
    from .dist import make_mesh_2d
    from .partition import hierarchical_partition, partition_elements

    if part_shape is not None:
        axis = axis or ("dcn", "ici")
        mesh = mesh or make_mesh_2d(part_shape, axis, device=device)
    else:
        axis = axis or "parts"
        mesh = mesh or make_mesh_1d(None, axis, device=device)
    n_parts = mesh.n_parts
    conn_np = np.asarray(conn)
    N = np.shape(coords)[0]
    if labels is None:
        if part_shape is not None:
            labels, _ = hierarchical_partition(conn_np, etype, part_shape,
                                               seed)
        else:
            labels, _ = partition_elements(conn_np, etype, n_parts, seed)
    part = HaloPartialPartition.build(coords, conn_np, etype, E, nu, labels,
                                      n_parts, dtype=dtype,
                                      part_shape=part_shape,
                                      device=mesh.device)
    fem = HaloPartialFEM(mesh, axis, part)
    _set_mask_and_jacobi(fem, part, N, fixed_nodes, precondition)
    return fem, part
