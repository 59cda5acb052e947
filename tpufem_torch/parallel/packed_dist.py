"""Distributed packed-layout operator: the packed SpMV of ops.packed
sharded over a part mesh (the port of tpufem/parallel/packed_dist.py).

Design (tpufem's): one GLOBAL PackedPlan built with window_buckets=0, so
clusters stay Morton-ordered and node blocks stay in first-touch order:

* part d owns cluster range [d Bp, (d+1) Bp) and node-block range
  [d Nbp, (d+1) Nbp), contiguous slices of the global plan's tables;
* an apply exchanges GHOST ROWS at block granularity (whole 384-lane
  rows): the X rows a part's cluster windows read from other parts'
  blocks, before the cluster stage, and the Yc rows (cluster slot sums)
  a part's block windows read from other parts' clusters, before the
  combine.  No reverse scatter is needed: the combine PULLS every
  contribution through its fixed window order, so the sum order is fixed
  and equal to the single-device packed operator's on the same plan;
* each part's clusters are ordered interior-first (window entirely in the
  owned block range).  On a GroupMesh the interior clusters are computed
  while the X ghost rows are in flight; on a PartMesh, where the exchange
  completes at once, all clusters run in one pass (the same values: every
  cluster's gather, element math and slot sum is its own).

Per part and per apply the hand-written kernels run on the part's
remapped tables: K4 ``expand`` reads rows of [X | ghost X | zero] by
index, the element math is the eager ``pa_apply_planar`` (batched over the
local parts), K3 ``compress_gather`` writes the slot sums into
[Yc | ghost Yc | zero], and K2 ``combine`` pulls them through the remapped
winc at each row's window width.  tpufem's pre-gathers of those rows
(``Xp[win_nodes]``, ``Yc_ext[winc]``) are not carried: the kernels read
rows by index.  The [X | ghost] and [Yc | ghost] rows are buffers made
with the system, so a CUDA graph of the PCG block reads fixed addresses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import packed_kernels as pk
from ..ops.packed import (BLK, ROW, PackedPlan, block_apply,
                          invert_block_planes, pa_apply_planar,
                          pa_blockdiag_planar, pa_diag_planar)
from ..utils.profiling import StageClock
from .dist import PartSystem, gather_rows, inverse_diagonal, make_mesh_1d
from .halo_partial import _color_rounds

@dataclasses.dataclass(frozen=True)
class _PDMeta:
    n_parts: int
    Bp: int                  # clusters per part (padded, multiple of 8)
    Nbp: int                 # node blocks per part (padded, multiple of 8)
    Gx: int                  # ghost X block rows (max over parts)
    Gc: int                  # ghost Yc cluster rows (likewise)
    Hx: int                  # max rows per X exchange round
    Hc: int
    x_rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    c_rounds: Tuple[Tuple[Tuple[int, int], ...], ...]
    interior_cut: int        # per-part interior-cluster count (mult of 8)
    elems_per_cluster: int
    nodes_per_elem: int
    lanes: int
    win_n: int
    win_c: int
    v_widths: Tuple[int, ...]   # single global bucket
    n_q: int
    n_qj: int
    n_nodes: int
    lam: float
    mu: float


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def ghosts_and_remap(tab: np.ndarray, owner_val: np.ndarray, n_local: int,
                     n_valid: int, Pn: int):
    """tab values are global ids in [0, n_valid) (>= n_valid = pad), rows
    split evenly over the Pn parts.  Returns (per-part sorted ghost id
    lists, the table in local-ext ids: owned id - d * n_local, ghost
    n_local + its index, pad -1; G >= 1)."""
    rows_per = tab.shape[0] // Pn
    ghosts, remap = [], np.empty_like(tab)
    for d in range(Pn):
        sl = slice(d * rows_per, (d + 1) * rows_per)
        vals = tab[sl]
        valid = vals < n_valid
        own = owner_val[np.minimum(vals, owner_val.size - 1)]
        remote = valid & (own != d)
        gl = np.unique(vals[remote])
        ghosts.append(gl)
        gidx = np.full(owner_val.size, -1, np.int64)
        gidx[gl] = np.arange(gl.size)
        ext = n_local + gidx[np.minimum(vals, owner_val.size - 1)]
        remap[sl] = np.where(remote, ext,
                             np.where(valid, vals - d * n_local, -1))
    G = max(1, max((g.size for g in ghosts), default=1))
    return ghosts, remap, G


def ghost_exchange(ghosts, owner_val: np.ndarray, n_local: int, Pn: int,
                   dtype):
    """(rounds, send, recv, mask, H, R): round ri's pairs (src, dst), the
    local rows src sends, the ghost index dst receives them at (-1
    masked) and the 0/1 mask, each [Pn, R, H]."""
    pairs = {}
    for d in range(Pn):
        src = owner_val[ghosts[d]]
        for s in np.unique(src):
            pairs[(int(s), d)] = int((src == s).sum())
    plist = sorted(pairs)
    rounds = [r for r in _color_rounds(plist, [pairs[e] for e in plist])
              if r]
    H = max(1, max(pairs.values(), default=1))
    R = max(1, len(rounds))
    send = np.zeros((Pn, R, H), np.int64)
    recv = np.full((Pn, R, H), -1, np.int64)
    mask = np.zeros((Pn, R, H), dtype)
    for ri, prs in enumerate(rounds):
        for s, d in prs:
            mine = np.nonzero(owner_val[ghosts[d]] == s)[0]
            h = mine.size
            send[s, ri, :h] = ghosts[d][mine] - s * n_local
            recv[d, ri, :h] = mine
            mask[d, ri, :h] = 1.0
    return rounds, send, recv, mask, H, R


@dataclasses.dataclass(frozen=True)
class PackedDistPartition:
    """Per-part slices of one global PackedPlan + the ghost-row exchange.
    Integer tables are host numpy (int32, tpufem's); the geometry and the
    masks' dtype are the build's, the geometry a tensor on its device."""

    # cluster tables [P, Bp, ...] (win_nodes remapped to local-ext block ids)
    win_nodes: np.ndarray    # [P, Bp, Wn] -> [0, Nbp+Gx]; pad = Nbp+Gx
    wslot: np.ndarray        # [P, Bp, 128]
    jslot: np.ndarray        # [P, Bp, 128]
    lconn: np.ndarray        # [P, Bp, Rp]
    cinc: np.ndarray         # [P, Bp, Wp, 128] byte-packed incidence
    Jinv: torch.Tensor       # [P, qJ, 9, Bp, E_c]
    W: torch.Tensor          # [P, q, Bp, E_c]
    # block tables [P, Nbp, ...] (winc remapped to local-ext cluster ids)
    winc: np.ndarray         # [P, Nbp, Wc] -> [0, Bp+Gc]; pad = Bp+Gc
    slotidx: np.ndarray      # [P, Nbp, ceil(Wc/4), 128] byte-packed
    # exchanges (block rows of X; cluster rows of Yc)
    xsend: np.ndarray        # [P, Rx, Hx] local row to send (pad 0)
    xrecv: np.ndarray        # [P, Rx, Hx] ghost slot; masked -> Gx (scratch)
    xmask: np.ndarray        # [P, Rx, Hx]
    csend: np.ndarray        # [P, Rc, Hc]
    crecv: np.ndarray        # [P, Rc, Hc]
    cmask: np.ndarray        # [P, Rc, Hc]
    new_from_old: np.ndarray   # [N] -> global packed node id (< P*Nbp*128)
    old_from_new: np.ndarray   # [P*Nbp*128] (-1 pad)
    dN: tuple                # static [q][k][3]
    meta: _PDMeta
    # [P, Bp] the plan's cluster of each local cluster (>= the plan's
    # cluster count: padding); not one of tpufem's tables
    clusters: Optional[np.ndarray] = None

    @staticmethod
    def build(coords, conn, etype: str, E: float, nu: float, n_parts: int,
              n_nodes: Optional[int] = None, rule: str = "default",
              dtype=None, elems_per_cluster: int = 32,
              affine: Optional[bool] = None, device=None,
              plan: Optional[PackedPlan] = None,
              timings: Optional[dict] = None) -> "PackedDistPartition":
        """plan: a PackedPlan of this mesh built with window_buckets=0 (on
        any device), else one is built here on the host.  The geometry is
        computed on `device` (None: the CUDA card).  timings: a dict that
        receives the seconds of the stages ("plan", "tables",
        "geometry")."""
        from ..core.device import resolve_device
        from ..core.materials import lame_parameters
        from ..elements.tables import element_table
        from ..ops.partial import chunked_geometry

        dev = resolve_device(device)
        conn = np.asarray(conn)
        coords_np = _np(coords)
        if n_nodes is None:
            n_nodes = coords_np.shape[0]
        stage = StageClock(dev, timings).tick
        if plan is None:
            plan = PackedPlan.build(coords_np, conn, int(n_nodes),
                                    elems_per_cluster, window_buckets=0,
                                    device="cpu")
            stage("plan")
        m = plan.meta
        if len(m.c_groups) != 1 or len(m.cv_widths) != 1:
            raise ValueError("PackedDistPartition needs a plan built with "
                             "window_buckets=0")
        Wn = max(m.c_groups[0][2], 1)
        Wc = max(m.b_groups[0][2], 1)
        v_widths = m.cv_widths[0]
        Pn = n_parts

        # pad global cluster/block counts to P * (multiple of 8)
        Bp = -(-m.n_clusters // (Pn * 8)) * 8
        Nbp = -(-m.n_blocks // (Pn * 8)) * 8
        Bt, Nbt = Pn * Bp, Pn * Nbp

        def padc(a, fill):   # pad cluster-axis tables to Bt rows
            out = np.full((Bt,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        def padb(a, fill):   # pad block-axis tables to Nbt rows
            out = np.full((Nbt,) + a.shape[1:], fill, a.dtype)
            out[: a.shape[0]] = a
            return out

        win_nodes = padc(_np(plan.win_nodes)[:, :Wn].astype(np.int64),
                         m.n_blocks)
        wslot = padc(_np(plan.wslot), Wn)
        jslot = padc(_np(plan.jslot), 0)
        lconn = padc(_np(plan.lconn), 0)
        cinc = padc(_np(plan.cinc[0]), 0)
        esrc = padc(_np(plan.esrc).reshape(m.n_clusters, -1), -1)
        winc = padb(_np(plan.winc)[:, :Wc].astype(np.int64), m.n_clusters)
        # slotidx is byte-packed 4 windows per int32 word (0 = absent)
        slotidx = padb(_np(plan.slotidx)[:, : -(-Wc // 4)], 0)

        cluster_owner = np.arange(Bt) // Bp
        block_owner = np.arange(Nbt) // Nbp

        # interior-first reorder within each part's cluster range
        wn_valid = win_nodes < m.n_blocks
        w_owner = np.where(wn_valid,
                           block_owner[np.minimum(win_nodes, Nbt - 1)], -1)
        is_int = ((w_owner == cluster_owner[:, None]) | ~wn_valid).all(axis=1)
        cperm = np.empty(Bt, np.int64)
        int_counts = []
        for d in range(Pn):
            sl = np.arange(d * Bp, (d + 1) * Bp)
            ii = is_int[sl]
            cperm[sl] = np.concatenate([sl[ii], sl[~ii]])
            int_counts.append(int(ii.sum()))
        Mi = (min(int_counts) // 8) * 8 if int_counts else 0
        cpos = np.empty(Bt, np.int64)
        cpos[cperm] = np.arange(Bt)
        win_nodes = win_nodes[cperm]
        wslot = wslot[cperm]
        jslot = jslot[cperm]
        lconn = lconn[cperm]
        cinc = cinc[cperm]
        esrc = esrc[cperm]
        winc = np.where(winc < m.n_clusters,
                        cpos[np.minimum(winc, Bt - 1)], Bt)

        # ghost lists + local-ext remaps
        xg, win_l, Gx = ghosts_and_remap(win_nodes, block_owner, Nbp,
                                         m.n_blocks, Pn)
        cg_, winc_l, Gc = ghosts_and_remap(winc, cluster_owner, Bp, Bt, Pn)
        win_l = np.where(win_l < 0, Nbp + Gx, win_l)     # pad -> scratch (0)
        winc_l = np.where(winc_l < 0, Bp + Gc, winc_l)

        table = element_table(etype, rule)
        coords_t = torch.as_tensor(coords_np, device=dev)
        dtype = dtype or coords_t.dtype
        mdt = np.float64 if dtype == torch.float64 else np.float32
        x_rounds, xsend, xrecv, xmask, Hx, Rx = ghost_exchange(
            xg, block_owner, Nbp, Pn, mdt)
        c_rounds, csend, crecv, cmask, Hc, Rc = ghost_exchange(
            cg_, cluster_owner, Bp, Pn, mdt)
        xrecv = np.where(xrecv < 0, Gx, xrecv)   # masked -> scratch row
        crecv = np.where(crecv < 0, Gc, crecv)
        stage("tables")

        # geometry factors over the padded, reordered element set
        esrc_f = esrc.reshape(-1)
        conn_sel = torch.as_tensor(conn[np.maximum(esrc_f, 0)], device=dev)
        Jinv, Wq, affine_meas = chunked_geometry(coords_t.to(dtype), conn_sel,
                                                 table, dtype)
        Wq = Wq * torch.as_tensor(esrc_f >= 0, device=dev).to(dtype)[:, None]
        if affine is None:
            affine = affine_meas
        if affine:
            Jinv = Jinv[:, :1]
        qJ = Jinv.shape[1]
        q = Wq.shape[1]
        E_c = m.elems_per_cluster
        # [Bt*E_c, qJ, 3, 3] -> [P, qJ, 9, Bp, E_c]
        Jp = Jinv.reshape(Pn, Bp, E_c, qJ, 9).permute(0, 3, 4, 1, 2)
        Wp = Wq.reshape(Pn, Bp, E_c, q).permute(0, 3, 1, 2)
        lam, mu = lame_parameters(E, nu)
        stage("geometry")

        # node mapping: global packed ids (pad node space to P*Nbp*128)
        nfo = _np(plan.new_from_old).astype(np.int64)
        ofn = np.full(Nbt * BLK, -1, np.int64)
        ofn[: m.n_blocks * BLK] = _np(plan.old_from_new)

        meta = _PDMeta(
            Pn, Bp, Nbp, Gx, Gc, Hx, Hc,
            tuple(tuple(r) for r in x_rounds),
            tuple(tuple(r) for r in c_rounds),
            Mi, E_c, m.nodes_per_elem, m.lanes, Wn, Wc, tuple(v_widths),
            q, qJ, int(n_nodes), float(lam), float(mu))
        dNt = tuple(tuple(tuple(float(v) for v in row) for row in pt)
                    for pt in np.asarray(table.dN))
        i32 = lambda a: np.ascontiguousarray(a).astype(np.int32)  # noqa: E731
        return PackedDistPartition(
            win_nodes=i32(win_l.reshape(Pn, Bp, Wn)),
            wslot=i32(wslot.reshape(Pn, Bp, BLK)),
            jslot=i32(jslot.reshape(Pn, Bp, BLK)),
            lconn=i32(lconn.reshape(Pn, Bp, -1)),
            cinc=np.ascontiguousarray(cinc.reshape(Pn, Bp, -1, BLK)),
            Jinv=Jp.contiguous(), W=Wp.contiguous(),
            winc=i32(winc_l.reshape(Pn, Nbp, Wc)),
            slotidx=i32(slotidx.reshape(Pn, Nbp, -1, BLK)),
            xsend=i32(xsend), xrecv=i32(xrecv), xmask=xmask,
            csend=i32(csend), crecv=i32(crecv), cmask=cmask,
            new_from_old=i32(nfo), old_from_new=i32(ofn),
            dN=dNt, meta=meta, clusters=cperm.reshape(Pn, Bp))

    def plan_geometry(self, n_clusters: int):
        """(Jinv [qJ, 9, B, E_c], W [q, B, E_c]): this partition's
        geometry in the plan's cluster order (B = n_clusters, the plan's
        count), the staged layout of PackedPartialOperator."""
        m = self.meta
        ids = torch.as_tensor(self.clusters.reshape(-1),
                              device=self.W.device)
        keep = ids < n_clusters
        J = self.Jinv.permute(1, 2, 0, 3, 4).reshape(
            m.n_qj, 9, -1, m.elems_per_cluster)
        W = self.W.permute(1, 0, 2, 3).reshape(m.n_q, -1,
                                               m.elems_per_cluster)
        Jp = J.new_zeros((m.n_qj, 9, n_clusters, m.elems_per_cluster))
        Wp = W.new_zeros((m.n_q, n_clusters, m.elems_per_cluster))
        Jp[:, :, ids[keep]] = J[:, :, keep]
        Wp[:, ids[keep]] = W[:, keep]
        return Jp, Wp

    # -- packing helpers (host) ---------------------------------------------
    def pack_np(self, u: np.ndarray) -> np.ndarray:
        """u [N, 3] -> X [P*Nbp, 384] (the parts' rows in order)."""
        m = self.meta
        rows = m.n_parts * m.Nbp
        out = np.zeros((rows * BLK, 3), u.dtype)
        out[self.new_from_old] = u
        out = out.reshape(rows, BLK, 3).transpose(0, 2, 1)
        return np.ascontiguousarray(out).reshape(rows, ROW)

    def unpack_np(self, X) -> np.ndarray:
        m = self.meta
        rows = m.n_parts * m.Nbp
        u = _np(X).reshape(rows, 3, BLK).transpose(0, 2, 1)
        return u.reshape(rows * BLK, 3)[self.new_from_old]


def row_widths(winc_l: np.ndarray, pad: int) -> np.ndarray:
    """Each block row's combine width: one past its last real window
    (winc < pad), 0 for a row without one.  The windows cut are padding,
    which adds nothing (PackedPlan.row_wk's rule)."""
    w = np.arange(1, winc_l.shape[-1] + 1)
    return np.where(winc_l < pad, w, 0).max(axis=-1).astype(np.int32)


class PackedHaloFEM(PartSystem):
    """Distributed packed-layout matrix-free system on a part mesh: K4, the
    element math, K3 per part into [Yc | ghost], the Yc exchange, K2 per
    part."""

    width = ROW

    def __init__(self, mesh, axis: str, part: PackedDistPartition,
                 free_mask=None, M_inv=None):
        self.axis = axis
        self.part = part
        m = part.meta
        self.rows_per_part = m.Nbp
        self._init_system(mesh, free_mask, M_inv)
        L = mesh.L
        take32 = lambda a: mesh.take(a).to(torch.int32).contiguous()  # noqa
        self.win_nodes = take32(part.win_nodes)
        self.wslot = take32(part.wslot)
        self.jslot = take32(part.jslot)
        self.lconn = take32(part.lconn)
        self.cinc = take32(part.cinc)
        self.winc = take32(part.winc)
        self.slotidx = take32(part.slotidx)
        self.wk = take32(row_widths(part.winc, m.Bp + m.Gc))
        # planar geometry over the local parts: [qJ, 9, L, Bp, E_c],
        # [q, L, Bp, E_c]
        self.Jinv = mesh.take(part.Jinv).permute(1, 2, 0, 3, 4).contiguous()
        self.W = mesh.take(part.W).permute(1, 0, 2, 3).contiguous()
        self.dN = np.asarray(part.dN)
        dt, dev = self.W.dtype, mesh.device
        lid = self._lidx.reshape(-1, 1, 1)
        mesh.prepare(list(m.x_rounds) + list(m.c_rounds))
        self.xsend = mesh.take(part.xsend).long()
        self.xrecv_flat = lid * (m.Nbp + m.Gx + 1) + m.Nbp + \
            mesh.take(part.xrecv).long()
        self.xmask = mesh.take(part.xmask).to(dt)
        self.csend = mesh.take(part.csend).long()
        self.crecv_flat = lid * (m.Bp + m.Gc + 1) + m.Bp + \
            mesh.take(part.crecv).long()
        self.cmask = mesh.take(part.cmask).to(dt)
        # [X | ghost X | zero] and [Yc | ghost Yc | zero] rows, and the
        # element lanes: fixed buffers (graph replays read these addresses)
        self.Xext = torch.zeros((L, m.Nbp + m.Gx + 1, ROW), dtype=dt,
                                device=dev)
        self.Ycext = torch.zeros((L, m.Bp + m.Gc + 1, ROW), dtype=dt,
                                 device=dev)
        self.ue = torch.zeros((L, m.Bp, 3, m.lanes), dtype=dt, device=dev)

    @property
    def dtype(self) -> torch.dtype:
        return self.W.dtype

    # -- the stages ---------------------------------------------------------
    def _yc_slice(self, a: int, b: int, expand=pk.expand,
                  compress=pk.compress_gather) -> None:
        """Cluster stage (expand -> element math -> compress) for the
        clusters [a, b) of every local part, from Xext into Ycext."""
        m = self.part.meta
        n, k, E_c = b - a, m.nodes_per_elem, m.elems_per_cluster
        if n <= 0:
            return
        L = self.mesh.L
        for l in range(L):
            expand(self.Xext[l], self.win_nodes[l, a:b], self.wslot[l, a:b],
                   self.jslot[l, a:b], self.lconn[l, a:b], wk=m.win_n,
                   out=self.ue[l, a:b])
        ue3 = self.ue[:, a:b, :, :k * E_c].reshape(L, n, 3, k, E_c).permute(
            2, 3, 0, 1, 4)                            # [3, k, L, n, E_c]
        fe3 = pa_apply_planar(ue3, self.Jinv[:, :, :, a:b],
                              self.W[:, :, a:b], self.dN, m.lam, m.mu)
        self._compress(fe3, a, b, compress)

    def _compress(self, fe3: torch.Tensor, a: int, b: int,
                  compress=pk.compress_gather) -> None:
        """Planar element values [3, k, L, n, E_c] of clusters [a, b) ->
        their slot sums, written into Ycext[:, a:b]."""
        m = self.part.meta
        _, k, L, n, E_c = fe3.shape
        Fe = fe3.new_zeros((L, n, 3, m.lanes))
        Fe[..., :k * E_c] = fe3.permute(2, 3, 0, 1, 4).reshape(
            L, n, 3, k * E_c)
        for l in range(L):
            compress(Fe[l], self.cinc[l, a:b], m.v_widths,
                     out=self.Ycext[l, a:b])

    def _exchange(self, rows: torch.Tensor, send, recv_flat, mask, rounds,
                  dest: torch.Tensor, start: int):
        """Ghost rows of `rows` [L, *, 384] into dest [L, start + G + 1,
        384] after its `start` owned rows (the last row a zero scratch
        row): returns a function that waits for them."""
        handles = [self.mesh.ppermute_start(
            gather_rows(rows, self._lidx, send[:, ri]), prs)
            for ri, prs in enumerate(rounds)]

        def finish():
            dest[:, start:].zero_()
            flat = dest.view(-1, ROW)
            for ri, h in enumerate(handles):
                got = h.wait() * mask[:, ri, :, None]
                # every valid ghost row comes from one entry of one round,
                # masked entries add exact zeros to the scratch row: the
                # sum is exact in any order
                flat.index_add_(0, recv_flat[:, ri].reshape(-1),
                                got.reshape(-1, ROW))
        return finish

    def _combine(self, combine=pk.combine) -> torch.Tensor:
        """Node rows [L, Nbp, 384] from Ycext through the remapped winc."""
        m = self.part.meta
        L = self.mesh.L
        F = torch.empty((L, m.Nbp, ROW), dtype=self.dtype,
                        device=self.mesh.device)
        for l in range(L):
            combine(self.Ycext[l], self.winc[l], self.slotidx[l], self.wk[l],
                    out=F[l])
        return F

    def _c_exchange(self) -> None:
        m = self.part.meta
        self._exchange(self.Ycext, self.csend, self.crecv_flat, self.cmask,
                       m.c_rounds, self.Ycext, m.Bp)()

    def _spmv_body(self, X: torch.Tensor, expand=pk.expand,
                   compress=pk.compress_gather, combine=pk.combine
                   ) -> torch.Tensor:
        """X [L, Nbp, 384] -> F [L, Nbp, 384].  expand, compress and
        combine: the kernels' wrappers, or their plain versions (same
        signatures) for a comparison."""
        m = self.part.meta
        Mi = m.interior_cut
        self.Xext[:, :m.Nbp].copy_(X)
        finish = self._exchange(X, self.xsend, self.xrecv_flat, self.xmask,
                                m.x_rounds, self.Xext, m.Nbp)
        if self.mesh.overlaps and Mi > 0:
            # interior clusters read owned rows (and the zero scratch row)
            # only: they run while the ghost rows are in flight
            self._yc_slice(0, Mi, expand, compress)
            finish()
            self._yc_slice(Mi, m.Bp, expand, compress)
        else:
            finish()
            self._yc_slice(0, m.Bp, expand, compress)
        self._c_exchange()
        return self._combine(combine)

    def spmv_with(self, X, expand=pk.expand, compress=pk.compress_gather,
                  combine=pk.combine) -> torch.Tensor:
        """spmv through the given kernels (or plain versions)."""
        out = self._spmv_body(self._local(X), expand, compress, combine)
        return out.reshape(self.n_local_rows, ROW)

    # -- preconditioners ----------------------------------------------------
    def _assembled(self, f3: torch.Tensor) -> torch.Tensor:
        """Planar per-element values [3, k, L, Bp, E_c] -> the assembled
        field [L, Nbp, 384] (compress, Yc exchange, combine)."""
        self._compress(f3, 0, self.part.meta.Bp)
        self._c_exchange()
        return self._combine()

    def jacobi_preconditioner(self) -> torch.Tensor:
        m = self.part.meta
        d = self._assembled(pa_diag_planar(self.Jinv, self.W, self.dN,
                                           m.lam, m.mu))
        return inverse_diagonal(d).reshape(self.n_local_rows, ROW)

    def block_diagonal(self):
        """The assembled 3x3 node-block diagonal (D, O) [L*Nbp, 384]."""
        m = self.part.meta
        d3, o3 = pa_blockdiag_planar(self.Jinv, self.W, self.dN, m.lam, m.mu)
        return tuple(self._assembled(f3).reshape(self.n_local_rows, ROW)
                     for f3 in (d3, o3))

    def block_jacobi_preconditioner(self, mask=None):
        """(inv_d, inv_o) packed planes of this process's rows: the exact
        3x3 node-block inverse (ops.packed.BlockJacobi's)."""
        D, O = self.block_diagonal()
        return invert_block_planes(D, O, mask)

    def _apply_M(self, like):
        """tpufem's apply_M: the 3x3 node-block apply for both Jacobi kinds
        (scalar Jacobi is its inv_o == 0 case)."""
        if self.M_inv is None:
            inv_d, inv_o = torch.ones_like(like), torch.zeros_like(like)
        elif isinstance(self.M_inv, tuple):
            inv_d, inv_o = (self._local(t, like.dtype) for t in self.M_inv)
        else:
            inv_d = self._local(self.M_inv, like.dtype)
            inv_o = torch.zeros_like(like)
        return lambda r: block_apply(inv_d, inv_o, r)


def build_packed_halo_fem(coords, conn, etype: str, E: float, nu: float,
                          mesh=None, axis: str = "parts", fixed_nodes=None,
                          dtype=None, elems_per_cluster: int = 32,
                          precondition="jacobi", device=None,
                          plan: Optional[PackedPlan] = None,
                          timings: Optional[dict] = None):
    """One-call setup of the distributed packed-layout system
    (precondition: "jacobi", "block" or False).  mesh=None:
    make_mesh_1d(None, device=device); plan: an optional window_buckets=0
    PackedPlan of this mesh; timings: a dict that receives the seconds of
    the stages (PackedDistPartition.build's, then "preconditioner")."""
    mesh = mesh or make_mesh_1d(None, axis, device=device)
    coords_np = _np(coords)
    N = coords_np.shape[0]
    part = PackedDistPartition.build(coords_np, conn, etype, E, nu,
                                     mesh.n_parts, dtype=dtype,
                                     elems_per_cluster=elems_per_cluster,
                                     device=mesh.device, plan=plan,
                                     timings=timings)
    fem = PackedHaloFEM(mesh, axis, part)
    fdt = np.float64 if fem.dtype == torch.float64 else np.float32
    mask_n = np.ones((N, 3), fdt)
    if fixed_nodes is not None:
        mask_n[np.asarray(fixed_nodes)] = 0.0
    fem.free_mask = fem.local_rows(part.pack_np(mask_n))
    clock = StageClock(mesh.device, timings)
    if precondition == "block":
        fem.M_inv = fem.block_jacobi_preconditioner(mask=fem.free_mask)
    elif precondition:
        fem.M_inv = fem.jacobi_preconditioner() * fem.free_mask
    clock.tick("preconditioner")
    return fem, part
