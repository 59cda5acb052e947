"""Halo-exchange distributed operator: neighbour ppermute instead of
all-gather (the port of tpufem/parallel/halo.py).

DistFEM (parallel.dist) moves the full O(N) vector per SpMV with
all_gather / reduce_scatter.  This variant moves only the partition-
surface DOFs:

  1. forward exchange: each part sends the owned rows its neighbours
     reference (ghost values) by ppermute rounds over part offsets;
  2. local compute: gather [owned | ghosts] rows -> batched GEMV ->
     node-binned local reduction;
  3. reverse exchange: ghost-row partial sums go back to their owners and
     are added in a fixed round order (deterministic).

Communication volume per SpMV: 2 * sum_p |halo_p| rows, against 2 * N for
the all-gather scheme.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .dist import (PartSystem, _Reorder, bin_sum, element_gemv,
                   gather_rows, inverse_diagonal, make_mesh_1d, node_bins,
                   owned_numbering, padded_stiffness, _set_mask_and_jacobi)


@dataclasses.dataclass(frozen=True)
class _HaloMeta:
    n_parts: int
    block_rows: int       # B owned (padded) nodes per part
    ghost_rows: int       # G ghost slots per part (padded)
    halo_width: int       # H rows exchanged per round (padded)
    rounds: Tuple[int, ...]  # part offsets with any traffic
    elems_per_part: int
    dof_per_elem: int
    n_nodes: int


def ghost_lists(conn: np.ndarray, labels: np.ndarray, owner: np.ndarray,
                n_parts: int):
    """Per part: the nodes its elements touch that another part owns
    (sorted), G (>= 1) and H_per[q, p], the ghosts of p owned by q."""
    ghosts = []
    for p in range(n_parts):
        nodes_p = np.unique(conn[labels == p])
        ghosts.append(nodes_p[owner[nodes_p] != p])
    G = max(1, max((g.size for g in ghosts), default=1))
    H_per = np.zeros((n_parts, n_parts), np.int64)  # sender q -> dest p
    for p in range(n_parts):
        srcs = owner[ghosts[p]]
        for q in range(n_parts):
            H_per[q, p] = int((srcs == q).sum())
    return ghosts, G, H_per


def local_connectivity(cp: np.ndarray, p: int, owner: np.ndarray,
                       rank: np.ndarray, ghosts_p: np.ndarray, B: int,
                       n_nodes: int) -> np.ndarray:
    """Element rows cp [m, k] of part p -> slots into [owned | ghost]:
    an owned node's rank, or B + its index in the part's ghost list."""
    gslot = np.full(n_nodes, -1, np.int64)
    gslot[ghosts_p] = B + np.arange(ghosts_p.size)
    return np.where(owner[cp] == p, rank[cp], gslot[cp])


def exchange_tables(rounds, ghosts, owner, rank, n_parts: int, R: int,
                    H: int, B: int, G: int, dtype):
    """(send_idx, recv_slot, recv_mask) [P, R, H]: in round ri part q sends
    the owned rows that p references to p, which receives them into its
    ghost slots (masked entries: send row 0, receive into the pad slot
    B + G, mask 0)."""
    send_idx = np.zeros((n_parts, R, H), np.int64)
    recv_slot = np.full((n_parts, R, H), B + G, np.int64)
    recv_mask = np.zeros((n_parts, R, H), dtype)
    for ri, prs in enumerate(rounds):
        for q, p in prs:
            gl = ghosts[p]
            mine = np.nonzero(owner[gl] == q)[0]
            h = mine.size
            send_idx[q, ri, :h] = rank[gl[mine]]
            recv_slot[p, ri, :h] = B + mine
            recv_mask[p, ri, :h] = 1.0
    return send_idx, recv_slot, recv_mask


@dataclasses.dataclass(frozen=True)
class HaloPartition(_Reorder):
    """Per-part tables (leading axis = parts): host numpy int32 (tpufem's),
    recv_mask in K's dtype, K a tensor on the element stiffness's
    device."""

    K: torch.Tensor            # [P, Mp, d, d]
    conn_local: np.ndarray     # [P, Mp, k] slots into [owned | ghost]
    inc: np.ndarray            # [P, B+G, W] bins into local Fe rows (+pad)
    send_idx: np.ndarray       # [P, R, H] owned rows to send per round
    recv_slot: np.ndarray      # [P, R, H] ghost slot receiving per round
    recv_mask: np.ndarray      # [P, R, H] 1/0 valid
    new_from_old: np.ndarray
    old_from_new: np.ndarray
    meta: _HaloMeta

    @staticmethod
    def build(K_elem, conn, n_nodes: int, labels, n_parts: int,
              dof_per_node: int = 3) -> "HaloPartition":
        from .partition import owner_of_nodes

        conn = np.asarray(conn)
        labels = np.asarray(labels)
        M, k = conn.shape
        d = k * dof_per_node
        owner = owner_of_nodes(conn, labels, n_nodes)
        B, rank, new_from_old, old_from_new = owned_numbering(owner, n_parts)
        Mp = int(np.bincount(labels, minlength=n_parts).max())
        ghosts, G, H_per = ghost_lists(conn, labels, owner, n_parts)
        rounds = [delta for delta in range(1, n_parts)
                  if any(H_per[q, (q + delta) % n_parts]
                         for q in range(n_parts))]
        H = max(1, int(max(
            (H_per[q, (q + delta) % n_parts]
             for delta in rounds for q in range(n_parts)), default=1)))
        R = max(1, len(rounds))

        conn_local = np.zeros((n_parts, Mp, k), np.int64)
        inc_rows = []
        W = 1
        for p in range(n_parts):
            sel = np.nonzero(labels == p)[0]
            loc = local_connectivity(conn[sel], p, owner, rank, ghosts[p], B,
                                     n_nodes)
            conn_local[p, :sel.size] = loc
            rows = loc.reshape(-1)
            cnt = np.bincount(rows, minlength=B + G)
            W = max(W, int(cnt.max()) if cnt.size else 1)
            inc_rows.append(rows)
        K = padded_stiffness(K_elem, labels, n_parts, Mp)
        mdt = np.float64 if K.dtype == torch.float64 else np.float32
        send_idx, recv_slot, recv_mask = exchange_tables(
            [[(q, (q + delta) % n_parts) for q in range(n_parts)]
             for delta in rounds], ghosts, owner, rank, n_parts, R, H, B, G,
            mdt)
        inc = np.empty((n_parts, B + G, W), np.int64)
        for p in range(n_parts):
            node_bins(inc_rows[p], B + G, W, Mp * k, inc[p])
        meta = _HaloMeta(n_parts, B, G, H, tuple(rounds), Mp, d, n_nodes)
        return HaloPartition(
            K=K, conn_local=conn_local.astype(np.int32),
            inc=inc.astype(np.int32), send_idx=send_idx.astype(np.int32),
            recv_slot=recv_slot.astype(np.int32), recv_mask=recv_mask,
            new_from_old=new_from_old.astype(np.int32),
            old_from_new=old_from_new.astype(np.int32), meta=meta)


class HaloExchange:
    """The ghost exchange of HaloFEM and HaloPartialFEM on a mesh: the
    forward rounds fill ghost slots of [owned | ghost | pad] rows, the
    reverse rounds add ghost partial sums to their owners' rows."""

    def __init__(self, mesh, lidx, send_idx, recv_slot, recv_mask, rounds,
                 B: int, G: int):
        """rounds: per round, its (src, dst) pairs of the forward
        exchange (the reverse exchange swaps them)."""
        self.mesh = mesh
        self.lidx = lidx
        self.B, self.G = B, G
        self.fwd = [tuple(r) for r in rounds]
        self.rev = [tuple((d, s) for s, d in r) for r in rounds]
        mesh.prepare(self.fwd + self.rev)
        self.send_idx = mesh.take(send_idx).long()             # [L, R, H]
        self.recv_slot = mesh.take(recv_slot).long()
        self.recv_mask = mesh.take(recv_mask)
        lid = lidx.reshape(-1, 1, 1)
        # flat row ids into [L * (B+G+1)] and [L * B]
        self.recv_flat = lid * (B + G + 1) + self.recv_slot
        self.send_flat = lid * B + self.send_idx

    def start(self, u: torch.Tensor):
        """Post the forward rounds: u_own [L, B, nd] -> handles."""
        return [self.mesh.ppermute_start(
            gather_rows(u, self.lidx, self.send_idx[:, ri]), pairs)
            for ri, pairs in enumerate(self.fwd)]

    def finish(self, handles, u_loc: torch.Tensor) -> torch.Tensor:
        """Add the received rows into u_loc [L, B+G+1, nd] (owned rows,
        zero ghost and pad slots), in place, and return it."""
        nd = u_loc.shape[-1]
        flat = u_loc.view(-1, nd)
        mask = self.recv_mask.to(u_loc.dtype)
        for ri, h in enumerate(handles):
            got = h.wait() * mask[:, ri, :, None]
            # each valid ghost slot is filled by exactly one entry of one
            # round, masked entries add exact zeros to the pad slot B + G:
            # the sum is exact in any order
            flat.index_add_(0, self.recv_flat[:, ri].reshape(-1),
                            got.reshape(-1, nd))
        return u_loc

    def reverse(self, F_loc: torch.Tensor) -> torch.Tensor:
        """Node sums [L, B+G, nd] -> owned rows [L, B, nd] with the ghost
        partial sums of the other parts added in round order."""
        B = self.B
        L, _, nd = F_loc.shape
        F_own = F_loc[:, :B].contiguous()
        F_ghost_pad = torch.cat([F_loc[:, B:], F_loc.new_zeros((L, 1, nd))],
                                dim=1)
        flat = F_own.view(-1, nd)
        mask = self.recv_mask.to(F_loc.dtype)
        for ri, pairs in enumerate(self.rev):
            buf = gather_rows(F_ghost_pad, self.lidx,
                              self.recv_slot[:, ri] - B) * mask[:, ri, :,
                                                                None]
            back = self.mesh.ppermute(buf, pairs)
            # within a round the valid targets are distinct owned rows;
            # masked entries carry exact zeros (to row 0): exact in any
            # order
            flat.index_add_(0, self.send_flat[:, ri].reshape(-1),
                            back.reshape(-1, nd))
        return F_own


class HaloFEM(PartSystem):
    """Distributed matrix-free system with neighbour halo exchange."""

    width = 3

    def __init__(self, mesh, axis: str, part: HaloPartition,
                 free_mask=None, M_inv=None):
        self.axis = axis
        self.part = part
        m = part.meta
        self.rows_per_part = m.block_rows
        self._init_system(mesh, free_mask, M_inv)
        self.K = mesh.take(part.K)
        self.conn_local = mesh.take(part.conn_local).long()
        self.inc = mesh.take(part.inc).long()
        P = m.n_parts
        self.exchange = HaloExchange(
            mesh, self._lidx, part.send_idx, part.recv_slot, part.recv_mask,
            [[(q, (q + delta) % P) for q in range(P)] for delta in m.rounds],
            m.block_rows, m.ghost_rows)

    @property
    def dtype(self) -> torch.dtype:
        return self.K.dtype

    def _spmv_body(self, u: torch.Tensor) -> torch.Tensor:
        m = self.part.meta
        L = u.shape[0]
        handles = self.exchange.start(u)
        u_loc = torch.cat([u, u.new_zeros((L, m.ghost_rows + 1, 3))], dim=1)
        u_loc = self.exchange.finish(handles, u_loc)
        ue = gather_rows(u_loc, self._lidx, self.conn_local).reshape(
            L, m.elems_per_part, m.dof_per_elem)
        Fe = element_gemv(self.K, ue)
        F_loc = bin_sum(Fe.reshape(L, -1, 3), self._lidx, self.inc)
        return self.exchange.reverse(F_loc)

    def jacobi_preconditioner(self) -> torch.Tensor:
        L = self.mesh.L
        d = torch.diagonal(self.K, dim1=2, dim2=3).reshape(L, -1, 3)
        diag = self.exchange.reverse(bin_sum(d, self._lidx, self.inc))
        return inverse_diagonal(diag).reshape(self.n_local_rows, 3)


def build_halo_fem(coords, conn, etype: str, E: float, nu: float,
                   mesh=None, axis: str = "parts", fixed_nodes=None,
                   labels=None, seed: int = 0, dtype=None,
                   precondition: bool = True, device=None):
    """One-call setup of the halo-exchange distributed system (element
    stiffness by the port's solid.stiffness, kernel stiffness_fused on the
    card).  mesh=None: make_mesh_1d(None, device=device)."""
    from ..elements.solid import stiffness
    from .partition import partition_elements

    mesh = mesh or make_mesh_1d(None, axis, device=device)
    n_parts = mesh.n_parts
    conn_np = np.asarray(conn)
    coords_np = np.asarray(coords.cpu() if torch.is_tensor(coords)
                           else coords)
    N = coords_np.shape[0]
    if labels is None:
        labels, _ = partition_elements(conn_np, etype, n_parts, seed)
    coords_t = torch.as_tensor(coords_np, device=mesh.device)
    if dtype is not None:
        coords_t = coords_t.to(dtype)
    K = stiffness(coords_t, torch.as_tensor(conn_np, device=mesh.device),
                  etype, E, nu)
    part = HaloPartition.build(K, conn_np, N, labels, n_parts, 3)
    del K
    fem = HaloFEM(mesh, axis, part)
    _set_mask_and_jacobi(fem, part, N, fixed_nodes, precondition)
    return fem, part
