"""Cluster-structured matrix-free operator on the assembled element K.

The port of tpufem/ops/clustered.py's ClusterPlan and ClusteredOperator:

* elements are grouped into clusters of E_c consecutive elements with at
  most L = 128 unique nodes;
* per apply, only the clusters' unique node rows are gathered from u and
  combined back (ops.scatter.CombinePlan), about 1.3 N rows instead of M k;
* inside a cluster, the expand (unique nodes -> element lanes) and the
  compress (element lanes -> unique nodes) are the kernels K7a and K7b
  (ops.cluster_kernels), with the batched element GEMV between them.

tpufem contracts one-hot selections on the MXU (or, with use_pallas, in
Pallas kernels); the port has one path, the kernels, whose plain versions
stand in on the CPU.  Deterministic: fixed cluster order, fixed sum order.
ClusteredPartialOperator is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from .cluster_kernels import cluster_compress, cluster_spmv
from .scatter import CombinePlan, _tensor


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    l2g: torch.Tensor          # [B, L] int32 global node per cluster slot
    lconn: torch.Tensor        # [B, E_c, k] int32 local slot per element node
    combine: CombinePlan       # Yc rows [B*L, nd] -> per-node sums [N, nd]
    n_nodes: int
    dof_per_node: int

    @property
    def n_clusters(self) -> int:
        return self.l2g.shape[0]

    @property
    def l_max(self) -> int:
        return self.l2g.shape[1]

    @property
    def elems_per_cluster(self) -> int:
        return self.lconn.shape[1]

    @property
    def device(self) -> torch.device:
        return self.l2g.device

    def to(self, device) -> "ClusterPlan":
        dev = torch.device(device)
        return dataclasses.replace(self, l2g=self.l2g.to(dev),
                                   lconn=self.lconn.to(dev),
                                   combine=self.combine.to(dev))

    @staticmethod
    def from_arrays(l2g, lconn, combine: CombinePlan, n_nodes: int,
                    dof_per_node: int = 3, device=None) -> "ClusterPlan":
        """Plan from tpufem's tables as numpy (l2g, lconn) and a
        CombinePlan; device=None means the CUDA card."""
        dev = resolve_device(device)
        return ClusterPlan(l2g=_tensor(l2g, dev), lconn=_tensor(lconn, dev),
                           combine=combine.to(dev), n_nodes=int(n_nodes),
                           dof_per_node=int(dof_per_node))

    @staticmethod
    def build(conn, n_nodes: int, dof_per_node: int = 3,
              elems_per_cluster: int = 0, l_max: int = 128,
              device=None) -> "ClusterPlan":
        """Build on the host (numpy; tables bitwise equal to tpufem's) and
        move them to `device` (None: the CUDA card)."""
        dev = resolve_device(device)
        conn = np.asarray(conn)
        M, k = conn.shape
        if elems_per_cluster <= 0:
            # largest E_c (multiple of 8) that keeps unique nodes under l_max
            elems_per_cluster = max(8, (l_max // k) * 4)
            while elems_per_cluster > 8:
                ok = True
                for a in range(0, min(M, 50 * elems_per_cluster),
                               elems_per_cluster):
                    if np.unique(conn[a:a + elems_per_cluster]).size > l_max:
                        ok = False
                        break
                if ok:
                    break
                elems_per_cluster -= 8
        E_c = elems_per_cluster
        B = -(-M // E_c)
        # per-cluster unique: pad the element list with rows of node 0,
        # sort each cluster's node row, first-occurrence mask -> slots
        pad_elems = B * E_c - M
        conn_pad = np.concatenate(
            [conn, np.zeros((pad_elems, k), conn.dtype)], axis=0
        ) if pad_elems else conn
        rows = conn_pad.reshape(B, E_c * k).astype(np.int64)
        order = np.argsort(rows, axis=1, kind="stable")
        srt = np.take_along_axis(rows, order, axis=1)
        is_first = np.ones_like(srt, dtype=bool)
        is_first[:, 1:] = srt[:, 1:] != srt[:, :-1]
        slot_sorted = np.cumsum(is_first, axis=1) - 1       # [B, E_c*k]
        n_uniq = slot_sorted[:, -1] + 1
        if int(n_uniq.max()) > l_max:
            bad = int(np.argmax(n_uniq))
            raise ValueError(
                f"cluster {bad} has {int(n_uniq[bad])} unique nodes > "
                f"l_max={l_max}; re-order elements or lower elems_per_cluster")
        l2g = np.zeros((B, l_max), np.int64)
        bidx = np.broadcast_to(np.arange(B)[:, None], srt.shape)
        l2g[bidx[is_first], slot_sorted[is_first]] = srt[is_first]
        lconn_flat = np.empty_like(rows)
        np.put_along_axis(lconn_flat, order, slot_sorted, axis=1)
        lconn = lconn_flat.reshape(B, E_c, k)
        # combine entries: (node, cluster-slot position) for real slots only
        keys = srt[is_first]
        pos = (bidx * l_max + slot_sorted)[is_first]
        combine = CombinePlan.build(keys, pos, B * l_max, n_nodes, device=dev)
        return ClusterPlan.from_arrays(l2g, lconn, combine, n_nodes,
                                       dof_per_node, dev)


class ClusteredOperator(torch.nn.Module):
    """u[N, nd] -> F[N, nd] through cluster-local gather and sum.

    K [B, E_c, d, d] is the element stiffness padded with zero elements to
    whole clusters (a buffer on the plan's device)."""

    def __init__(self, K: torch.Tensor, plan: ClusterPlan):
        super().__init__()
        self.register_buffer("K", K)
        self.plan = plan

    @staticmethod
    def build(K_elem, conn, n_nodes: int, dof_per_node: int = 3,
              plan: Optional[ClusterPlan] = None, device=None,
              **plan_kw) -> "ClusteredOperator":
        """K_elem [M, d, d] (a tensor, or numpy such as tpufem's K, which
        is copied to the plan's device); plan built from conn when None,
        on `device` (None: the CUDA card)."""
        if plan is None:
            plan = ClusterPlan.build(conn, n_nodes, dof_per_node,
                                     device=device, **plan_kw)
        if not isinstance(K_elem, torch.Tensor):
            K_elem = torch.tensor(np.asarray(K_elem))
        K_elem = K_elem.to(plan.device)
        M, d, _ = K_elem.shape
        B, E_c = plan.n_clusters, plan.elems_per_cluster
        K = K_elem.new_zeros((B * E_c, d, d))
        K[:M] = K_elem
        return ClusteredOperator(K.reshape(B, E_c, d, d), plan)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        p = self.plan
        B, L = p.n_clusters, p.l_max
        Uc = u[p.l2g.long()]                                # [B, L, nd]
        Yc = cluster_spmv(self.K, p.lconn.reshape(B, -1), Uc)
        return p.combine(Yc.reshape(B * L, -1))

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal of the global matrix, [n_dof]."""
        p = self.plan
        B, L, nd = p.n_clusters, p.l_max, p.dof_per_node
        d = torch.diagonal(self.K, dim1=2, dim2=3)          # [B, E_c, d]
        Yc = cluster_compress(p.lconn.reshape(B, -1),
                              d.reshape(B, -1, nd).contiguous(), L)
        return p.combine(Yc.reshape(B * L, nd)).reshape(-1)
