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

ClusteredPartialOperator keeps no element K: the in-cluster expand and
compress around tpufem's component-unrolled partial-assembly action
(ops.partial.pa_apply_components).  On a CUDA device they are K7a and K7b
whatever ``use_pallas`` says (the flag keeps tpufem's signature); on the
CPU ``use_pallas=False`` contracts tpufem's one-hot selections
(ClusterPlan.onehot) and ``use_pallas=True`` runs the kernels' plain
versions.
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

    def onehot(self, dtype) -> torch.Tensor:
        """[B, E_c*k, L] exact 0/1 selection matrices (tpufem's MXU form of
        the in-cluster gather and sum, built on the fly)."""
        lc = self.lconn.reshape(self.n_clusters, -1).long()
        iota = torch.arange(self.l_max, device=lc.device)
        return (lc[:, :, None] == iota).to(dtype)

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


class ClusteredPartialOperator(torch.nn.Module):
    """Cluster-structured geometry-factor SpMV: no element K in memory.

    Buffers: Jinv [Mpad, qJ, 9] (qJ in {1, q}) and W [Mpad, q] (w * detJ),
    zero rows for the padding elements of the last cluster; dN [q, k, 3]
    stays a host constant (pa_apply_components skips its zero weights).
    Three values per node (a solid)."""

    def __init__(self, Jinv: torch.Tensor, W: torch.Tensor, dN: np.ndarray,
                 plan: ClusterPlan, lam_mu, use_pallas: bool = False):
        super().__init__()
        self.register_buffer("Jinv", Jinv)
        self.register_buffer("W", W)
        self.dN = np.asarray(dN, np.float64)
        self.plan = plan
        self.lam_mu = (float(lam_mu[0]), float(lam_mu[1]))
        self.use_pallas = bool(use_pallas)

    @staticmethod
    def build(coords, conn, etype: str, E: float, nu: float,
              rule: str = "default", plan: Optional[ClusterPlan] = None,
              affine: Optional[bool] = None, dtype=None,
              use_pallas: bool = False, n_nodes: Optional[int] = None,
              device=None, **plan_kw) -> "ClusteredPartialOperator":
        """The geometry of conn [M, k] on the plan's device (a plan is
        built from conn when None, on `device`; None: the CUDA card)."""
        from ..core.materials import lame_parameters
        from ..elements.tables import element_table
        from .partial import chunked_geometry

        conn = np.asarray(conn)
        table = element_table(etype, rule)
        if plan is None:
            if n_nodes is None:
                raise ValueError(
                    "ClusteredPartialOperator.build needs the true node "
                    "count: pass n_nodes= (conn.max()+1 silently drops "
                    "trailing unreferenced nodes) or a prebuilt plan=")
            plan = ClusterPlan.build(conn, int(n_nodes), 3, device=device,
                                     **plan_kw)
        dev = plan.device
        coords_t = torch.as_tensor(
            coords if isinstance(coords, torch.Tensor)
            else np.asarray(coords), device=dev)
        dtype = dtype or coords_t.dtype
        Jinv, W, is_affine = chunked_geometry(
            coords_t.to(dtype), torch.as_tensor(conn, device=dev), table,
            dtype)
        if affine is None:
            affine = is_affine
        if affine:
            Jinv = Jinv[:, :1]
        Jflat = Jinv.reshape(Jinv.shape[0], Jinv.shape[1], 9)
        Mpad = plan.n_clusters * plan.elems_per_cluster
        pad = Mpad - conn.shape[0]
        if pad:
            Jflat = torch.cat([Jflat, Jflat.new_zeros(
                (pad, Jflat.shape[1], 9))], dim=0)
            W = torch.cat([W, W.new_zeros((pad, W.shape[1]))], dim=0)
        lam, mu = lame_parameters(E, nu)
        return ClusteredPartialOperator(Jflat.contiguous(), W.contiguous(),
                                        table.dN, plan, (lam, mu),
                                        use_pallas)

    def _kernels(self, x: torch.Tensor) -> bool:
        return x.device.type == "cuda" or self.use_pallas

    def _expand(self, u: torch.Tensor):
        """u [N, 3] -> tuple of 3 tensors [Mpad, k] (element nodal values)."""
        from .cluster_kernels import cluster_expand
        p = self.plan
        B, E_c = p.n_clusters, p.elems_per_cluster
        k = self.dN.shape[1]
        Uc = u[p.l2g.long()]                                # [B, L, 3]
        if self._kernels(Uc):
            ue = cluster_expand(p.lconn.reshape(B, -1), Uc)
        else:
            ue = torch.einsum("bel,blc->bec", p.onehot(u.dtype), Uc)
        return tuple(ue[..., c].reshape(B * E_c, k) for c in range(3))

    def _compress(self, Fe_cols, dtype) -> torch.Tensor:
        """tuple of 3 tensors [Mpad, k] -> Yc [B, L, 3]."""
        p = self.plan
        B, L = p.n_clusters, p.l_max
        Fe = torch.stack([f.reshape(B, -1) for f in Fe_cols], dim=-1)
        if self._kernels(Fe):
            return cluster_compress(p.lconn.reshape(B, -1), Fe, L)
        return torch.einsum("bel,bec->blc", p.onehot(dtype), Fe)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        from .partial import pa_apply_components
        p = self.plan
        lam, mu = self.lam_mu
        Fe_cols = pa_apply_components(self._expand(u), self.Jinv, self.W,
                                      self.dN, lam, mu)
        Yc = self._compress(Fe_cols, u.dtype)
        return p.combine(Yc.reshape(p.n_clusters * p.l_max, 3))

    def diagonal(self) -> torch.Tensor:
        """Assembled diagonal [n_dof]: d[3i+a] = sum_q W ((lam+mu) g_ia^2
        + mu |g_i|^2), component form."""
        p = self.plan
        lam, mu = self.lam_mu
        q = self.W.shape[1]
        qJ = self.Jinv.shape[1]
        dN = self.dN
        k = dN.shape[1]
        d_cols = [None, None, None]
        for qi in range(q):
            Wq = self.W[:, qi]
            for a in range(3):
                col = []
                for kk in range(k):
                    g = [sum(float(dN[qi, kk, j])
                             * self.Jinv[:, min(qi, qJ - 1), 3 * i + j]
                             for j in range(3)) for i in range(3)]
                    norm2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
                    col.append(Wq * ((lam + mu) * g[a] * g[a] + mu * norm2))
                col = torch.stack(col, dim=1)               # [Mpad, k]
                d_cols[a] = col if d_cols[a] is None else d_cols[a] + col
        Yc = self._compress(tuple(d_cols), self.W.dtype)
        return p.combine(Yc.reshape(p.n_clusters * p.l_max, 3)).reshape(-1)
