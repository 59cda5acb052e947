"""Hybrid direct + iterative subdomain solver (Schur-complement
substructuring): the port of tpufem/solvers/hybrid.py.

The mesh is partitioned, each part's interior block is factorized densely,
and an outer PCG iterates on the interface unknowns only:

    K = [[K_II, K_IG], [K_GI, K_GG]]           (I = interiors, G = interface)
    S  = K_GG - sum_p K_GI,p K_II,p^-1 K_IG,p  (applied matrix-free)
    S u_G = f_G - sum_p K_GI,p K_II,p^-1 f_I,p
    u_I,p = K_II,p^-1 (f_I,p - K_IG,p u_G)

On the card: the element stiffness is kernel K6 (solid.stiffness); the
per-part blocks are assembled on the device by sorted segment sums (a
fixed order, no atomics) and factorized all at once (torch.linalg: batched
Cholesky, inverse); every Schur matvec is batched GEMVs and one
deterministic sum onto the interface (ops.scatter.CombinePlan).  The
interface PCG runs in 32-iteration blocks that the card captures once as
CUDA graphs and replays (solvers.cg.CGBlock: solve runs it once,
solve_chunked in chunks that resume its recurrence).  Fixed-node
(homogeneous) constraints are imposed by symmetric zeroing of the element
matrices plus a unit diagonal, preserving SPD.  The index tables (gmap,
imap, g_nodes, and on the host scat_perm, scat_seg) and meta are bitwise
tpufem's.

Changes from tpufem, kept on purpose:
* the NN/BDD rigid-body basis has six modes for each face-connected piece
  of a part, not six per part (a part of one piece, as in every tpufem
  test, gets tpufem's basis): an RCB or Morton cut of a tet mesh leaves
  tets joined to the rest of their part by an edge or a node, and such a
  piece floats on its own (box_tet(55) in 512 RCB parts has 3469 pieces
  in 512 parts; with six modes per part its BDD interface CG does not
  converge);
* the element stiffness (K6 in float64 on the card), the per-part
  blocks, their factors, the Schur complements, their inverses (through a
  Cholesky factor: S_p + reg is SPD), K_II^-1, the coarse operator and
  the matrix-free operator's geometry are formed in float64 from the
  float64 coordinates (WORK_DTYPE) and stored in the system's dtype (E's
  factor in float64).  tpufem's float32 build gives a NaN coarse factor;
  and a float32 system summed from a float32 K, or whose K_GG action
  comes from coordinates rounded to float32, is another mesh's system,
  and the cancellation in S amplifies the difference;
* E = sum_p Y_p^T S_p Y_p is accumulated part by part over the coarse
  columns that live on each part's interface, not from a dense host copy
  of the whole basis;
* solve_chunked(max_iter=0) returns the initial state (status MAX_ITER
  unless ||g|| < tol, 0 iterations) where tpufem raises AttributeError.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.scatter import CombinePlan
from ..utils.profiling import StageClock
from .cg import (CONVERGED, MAX_ITER, CGBlock, SolveInfo, cg_chunks,
                 chunk_history)

# bytes of the per-chunk temporaries of the factor build (tpufem: 1.5 GB
# for a 16 GB chip; the H100 holds 80 GB)
CHUNK_BYTES = 6 << 30
# the dtype of the element K, the per-part blocks, the Schur complements,
# their inverses, K_II^-1 and the coarse operator E while they are built
# (stored in the system's dtype, E's factor in this one): in float32 the
# coarse operator of floating parts is indefinite (its smallest
# eigenvalues lie below the float32 rounding of S), and tpufem's float32
# Cholesky of it is NaN; and the float32 rounding of each finished block
# is nearer the float64 system than blocks summed from a float32 K
WORK_DTYPE = torch.float64


@dataclasses.dataclass(frozen=True)
class HMeta:
    n_parts: int
    n_nodes: int
    n_interface: int
    nI_max: int
    nG_max: int


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K^-1 b from the lower Cholesky factor: two triangular solves
    (batched when L is), b a vector or a matrix per factor."""
    vec = b.dim() == L.dim() - 1
    b3 = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(L, b3, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if vec else x


def _gemv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[P, m, n] x [P, n] -> [P, m] (tpufem's "pij,pj->pi")."""
    return torch.bmm(A, x[..., None])[..., 0]


def _gemv_t(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[P, m, n]^T x [P, m] -> [P, n] (tpufem's "pig,pi->pg")."""
    return torch.bmm(x[:, None, :], A)[:, 0]


@dataclasses.dataclass(frozen=True, eq=False)
class HybridSystem:
    chol: torch.Tensor       # [P, 3nI, 3nI] lower Cholesky of K_II (padded I)
    K_IG: torch.Tensor       # [P, 3nI, 3nG]
    K_GG: torch.Tensor       # [P, 3nG, 3nG] per-part interface contribution
    gmap: torch.Tensor       # [P, nG] interface index of each part's nodes
    gmask: torch.Tensor      # [P, nG] 1/0 validity
    imap: torch.Tensor       # [P, nI] global node id of interiors (pad -> 0)
    imask: torch.Tensor      # [P, nI]
    g_nodes: torch.Tensor    # [nGlob] global node ids of interface nodes
    scat_perm: np.ndarray    # tpufem's sorted scatter plan, P*nG*3 -> dofs
    scat_seg: np.ndarray     # (host only: the device sum is `combine`)
    combine: CombinePlan     # [P*nG, 3] rows -> [nGlob, 3], fixed order
    Minv_G: torch.Tensor     # [nGlob, 3] Jacobi on assembled K_GG diagonal
    meta: HMeta
    # Neumann-Neumann / BDD (None -> scalar Jacobi): Sinv the explicit
    # inverses of the regularised per-part Schur complements, Dw the
    # inverse-multiplicity weights, gfree the free-dof mask, (Zloc, Echol)
    # the rigid-body coarse space and the factor of E = Z^T S Z
    Sinv: Optional[torch.Tensor] = None    # [P, 3nG, 3nG]
    Kinv: Optional[torch.Tensor] = None    # [P, 3nI, 3nI] K_II^-1
    S: Optional[torch.Tensor] = None       # [P, 3nG, 3nG] true S_p
    # matrix-free assembled-interface action: sum_p K_GG,p R_p v is the
    # global operator applied to an interface-supported vector
    mf_op: Optional[torch.nn.Module] = None   # ops.partial operator
    mf_free: Optional[torch.Tensor] = None    # [N, 3] 1 free / 0 fixed
    Dw: Optional[torch.Tensor] = None         # [P, 3nG]
    gfree: Optional[torch.Tensor] = None      # [nGlob, 3]
    Zloc: Optional[torch.Tensor] = None       # [P, 3nG, 6C] (C pieces)
    zcols: Optional[torch.Tensor] = None      # [ncols] E's columns in Zloc
    Echol: Optional[torch.Tensor] = None      # [ncols, ncols]
    # the interface PCG's solver blocks (and on the card their graphs),
    # made at first use; a replaced system starts without
    blocks: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def dtype(self) -> torch.dtype:
        return self.Minv_G.dtype

    @property
    def device(self) -> torch.device:
        return self.Minv_G.device

    # -- core ops --------------------------------------------------------
    def _interior_solve(self, b: torch.Tensor) -> torch.Tensor:
        """K_II^-1 b per part: a GEMV against Kinv when stored, else the
        Cholesky triangular-solve pair."""
        if self.Kinv is not None:
            if b.dim() == 2:
                return _gemv(self.Kinv, b)
            return torch.bmm(self.Kinv, b)
        return _chol_solve(self.chol, b)

    def _gather_iface(self, vG: torch.Tensor) -> torch.Tensor:
        """vG [nGlob, 3] -> per-part local [P, 3 nG]."""
        g = vG[self.gmap.long()] * self.gmask[..., None]
        return g.reshape(g.shape[0], -1)

    def _scatter_iface(self, sP: torch.Tensor) -> torch.Tensor:
        """[P, 3 nG] -> deterministic sum into [nGlob, 3]."""
        return self.combine(sP.reshape(-1, 3))

    def schur_matvec(self, vG: torch.Tensor) -> torch.Tensor:
        if self.mf_op is not None:
            # assembled-interface action through the global matrix-free
            # operator (masked rows and columns + a unit diagonal on fixed
            # dofs: the symmetric-zeroed assembled K)
            N = self.meta.n_nodes
            gn = self.g_nodes.long()
            v_full = vG.new_zeros((N, 3)).index_copy(0, gn, vG)
            vf = v_full * self.mf_free
            Av = (self.mf_op(vf) * self.mf_free)[gn]
            Av = Av + (1.0 - self.mf_free[gn]) * vG
            vp = self._gather_iface(vG)
            t1 = _gemv(self.K_IG, vp)
            t2 = self._interior_solve(t1)
            t3 = _gemv_t(self.K_IG, t2)
            return Av - self._scatter_iface(t3)
        if self.S is not None:
            # explicit per-part Schur blocks: one batched GEMV
            return self._scatter_iface(_gemv(self.S,
                                             self._gather_iface(vG)))
        vp = self._gather_iface(vG)                            # [P, 3nG]
        t1 = _gemv(self.K_IG, vp)                              # K_IG v
        t2 = self._interior_solve(t1)                          # K_II^-1
        t3 = _gemv_t(self.K_IG, t2)                            # K_GI ..
        return self._scatter_iface(_gemv(self.K_GG, vp) - t3)

    def _nn_apply(self, r: torch.Tensor) -> torch.Tensor:
        """Weighted per-part Schur inverse: sum_p D S_p^-1 D (one batched
        GEMV against the stored explicit inverses)."""
        rp = self._gather_iface(r)
        y = _gemv(self.Sinv, rp * self.Dw)
        return self._scatter_iface(y * self.Dw) * self.gfree

    def _coarse_solve(self, r: torch.Tensor) -> torch.Tensor:
        """lam = E^-1 Z^T r (coarse rigid-body coefficients [P, 6C])."""
        c = _gemv_t(self.Zloc, self._gather_iface(r)).reshape(-1)
        lam = _chol_solve(self.Echol, c[self.zcols].to(self.Echol.dtype))
        return c.new_zeros(c.shape).index_copy(
            0, self.zcols, lam.to(c.dtype)).reshape(self.meta.n_parts, -1)

    def _Z_apply(self, lam: torch.Tensor) -> torch.Tensor:
        return self._scatter_iface(_gemv(self.Zloc, lam)) * self.gfree

    def apply_M(self, r: torch.Tensor) -> torch.Tensor:
        """Interface preconditioner: Jacobi, NN, or balanced BDD (the
        projected form: the coarse rigid-body solve removes the components
        on which floating-part Schur inverses blow up)."""
        if self.Sinv is None:
            return r * self.Minv_G
        if self.Echol is None:
            return self._nn_apply(r)
        lam = self._coarse_solve(r)
        r1 = r - self.schur_matvec(self._Z_apply(lam))
        z1 = self._nn_apply(r1)
        mu = self._coarse_solve(self.schur_matvec(z1))
        return z1 - self._Z_apply(mu) + self._Z_apply(lam)

    # -- condensation and back-substitution ------------------------------
    def _force(self, f) -> torch.Tensor:
        return torch.as_tensor(np.asarray(f) if not isinstance(
            f, torch.Tensor) else f).to(device=self.device, dtype=self.dtype)

    def _condense(self, f: torch.Tensor):
        """f [N, 3] -> (fIp [P, 3nI], interface RHS g [nGlob, 3])."""
        fI = f[self.imap.long()] * self.imask[..., None]
        fIp = fI.reshape(self.meta.n_parts, -1)
        y = self._interior_solve(fIp)
        g = f[self.g_nodes.long()] - self._scatter_iface(_gemv_t(self.K_IG,
                                                                 y))
        return fIp, g

    def _backsub(self, fIp: torch.Tensor, f: torch.Tensor,
                 uG: torch.Tensor) -> torch.Tensor:
        vp = self._gather_iface(uG)
        rhs = fIp - _gemv(self.K_IG, vp)
        uI = self._interior_solve(rhs).reshape(self.meta.n_parts, -1, 3)
        uI = (uI * self.imask[..., None]).reshape(-1, 3)
        # each interior node lies in one part: a copy of the valid rows
        valid = self.imask.reshape(-1) > 0
        u = torch.zeros_like(f)
        u[self.imap.reshape(-1)[valid].long()] = uI[valid]
        return u.index_copy(0, self.g_nodes.long(), uG)

    # -- the interface PCG -----------------------------------------------
    def _block(self, tol: float, eps: float = 1e-30):
        """The interface PCG block of (tol, eps), made at first use: on the
        card its graphs are captured once and replayed by every solve."""
        key = (float(tol), float(eps))
        if key not in self.blocks:
            like = torch.zeros((self.meta.n_interface, 3), dtype=self.dtype,
                               device=self.device)
            # the block sees the system through a weak proxy: no reference
            # cycle keeps a dropped system (and its graphs) alive until a
            # garbage collection, which could fall inside another capture
            me = weakref.proxy(self)
            self.blocks[key] = CGBlock(
                lambda v: me.schur_matvec(v), like,
                M_inv=lambda r: me.apply_M(r), tol=tol, eps=eps)
        return self.blocks[key]

    def solve(self, f, tol: float = 1e-10, max_iter: int = 500,
              eps: float = 1e-30) -> Tuple[torch.Tensor, SolveInfo]:
        """Solve K u = f (f [N, 3], constrained dofs already zero): the
        interface PCG of tpufem's loop (eps in both denominators, tol on
        the recurrence ||r||, history [max_iter + 1]) as solvers.cg.CGBlock,
        which adds cg's breakdown statuses (NOT_SPD, NAN_INF), where
        tpufem's loop runs on."""
        f = self._force(f)
        fIp, g = self._condense(f)
        uG, info = self._block(tol, eps).solve(g, max_iter=max_iter)
        return self._backsub(fIp, f, uG), info

    def solve_chunked(self, f, tol: float = 1e-10, max_iter: int = 20000,
                      every: int = 400, progress=None):
        """Interface PCG as `every`-iteration chunks of solve's block,
        each resuming the last one's search direction and rz (tpufem's
        _h_chunk).  A chunk starts from the true residual g - S u, not the
        recurrence's r, so the chunks follow one solve's trajectory only
        while the two agree: near the float32 floor a restart can raise
        the residual (and the chunks diverge), so keep `every` at least
        the iterations a solve needs.  max_iter < 1 returns the initial
        state."""
        f = self._force(f)
        fIp, g = self._condense(f)
        if max_iter < 1:
            gn = torch.sqrt(torch.sum(g * g))
            st = torch.where(gn < tol, CONVERGED, MAX_ITER).to(torch.int32)
            return self._backsub(fIp, f, torch.zeros_like(g)), SolveInfo(
                st, torch.tensor(0), gn, gn.reshape(1).cpu().numpy())
        uG, info = chunk_history(cg_chunks(self._block(tol), g,
                                           torch.zeros_like(g), max_iter,
                                           every), progress)
        return self._backsub(fIp, f, uG), info

    def resident_bytes(self) -> dict:
        """Bytes of each stored block (the dense factors and the rest)."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                out[f.name] = v.numel() * v.element_size()
        return out


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

def _torch_dtype(dtype):
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def _node_parts(conn: np.ndarray, labels: np.ndarray, N: int):
    """Sorted unique (part, node) incidence pairs: (part [U], node [U],
    pair index of every element entry [M, k])."""
    from .. import native
    keys = (labels.astype(np.int64)[:, None] * N + conn).reshape(-1)
    nat = native.unique_inverse_i64(keys)
    uniq, inv = nat if nat is not None else np.unique(keys,
                                                      return_inverse=True)
    return uniq // N, uniq % N, inv.reshape(conn.shape)


def _segment_into(dense: torch.Tensor, keys: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """dense.view(-1)[key] = the sum of the vals of each key: sorted by
    key (stable), then a segment sum in that order (no atomics)."""
    from ..ops.assembly import segment_sum
    if keys.numel() == 0:
        return
    sk, order = torch.sort(keys, stable=True)
    uk, cnt = torch.unique_consecutive(sk, return_counts=True)
    dense.view(-1)[uk] = segment_sum(vals[order], cnt)


def _part_pieces(conn: np.ndarray, etype: str, labels: np.ndarray,
                 n_parts: int):
    """Each element's face-connected piece within its part, numbered per
    part in the order of the pieces' first elements ([M]), and the piece
    count of each part ([P])."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    from ..topology.faces import element_dual_graph

    M = conn.shape[0]
    ed = element_dual_graph(conn, etype)
    same = labels[ed[0]] == labels[ed[1]]
    graph = sp.coo_matrix((np.ones(int(same.sum()), np.int8),
                           (ed[0, same], ed[1, same])), shape=(M, M))
    _, comp = connected_components(graph, directed=False)
    first = np.full(comp.max() + 1, M, np.int64)
    np.minimum.at(first, comp, np.arange(M))
    key = labels.astype(np.int64) * (M + 1) + first[comp]
    uniq, inv = np.unique(key, return_inverse=True)
    owner = uniq // (M + 1)
    counts = np.bincount(owner, minlength=n_parts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return (np.arange(uniq.size) - starts[owner])[inv], counts


def _coarse_basis(conn, etype, labels, coords, is_iface, g_index, gmap,
                  nG_p, free_g, np_fdt):
    """The BDD/NN rigid-body basis: (Zloc [P, 3nG, 6C], the flat Zloc
    column of each coarse column [ncols], and per part q the tables of
    _coarse_rows).  Piece k of part p owns columns 6k..6k+5 of p; its
    modes live on its interface nodes, centred and scaled on them as
    tpufem's, weighted by 1 / (the pieces of p holding the node), so that
    pieces moving as one body sum to that body's mode."""
    P_, nG_max = gmap.shape
    N = coords.shape[0]
    piece, n_pieces = _part_pieces(conn, etype, labels, P_)
    C = int(n_pieces.max()) if P_ else 1
    key = ((labels.astype(np.int64) * C + piece)[:, None] * N
           + conn).reshape(-1)
    trip = np.unique(key)
    tn, tpk = trip % N, trip // N
    sel = is_iface[tn]
    tn, tp, tk = tn[sel], tpk[sel] // C, tpk[sel] % C
    _, inv, cnt = np.unique(tp * N + tn, return_inverse=True,
                            return_counts=True)
    wt = (1.0 / cnt[inv]) * free_g[g_index[tn]]
    # each triple's place among its part's interface nodes (gmap's rows
    # ascend)
    nG_tot = int(g_index.max()) + 1 if g_index.size else 1
    gkeys = (np.arange(P_)[:, None] * nG_tot + gmap)[np.arange(nG_max)
                                                   < nG_p[:, None]]
    gstart = np.concatenate([[0], np.cumsum(nG_p)[:-1]])
    lg = np.searchsorted(gkeys, tp * nG_tot + g_index[tn]) - gstart[tp]
    bounds = np.searchsorted(tp, np.arange(P_ + 1))
    Zloc = np.zeros((P_, 3 * nG_max, 6 * C), np_fdt)
    for p in range(P_):
        nG = int(nG_p[p])
        if nG == 0:
            continue
        Zp = np.zeros((nG, 3, 6 * int(n_pieces[p])), np_fdt)
        rows = np.arange(bounds[p], bounds[p + 1])
        for k in range(int(n_pieces[p])):
            r = rows[tk[rows] == k]
            if r.size == 0:
                continue
            X = coords[tn[r]]
            d = X - X.mean(axis=0)
            span = max(float(np.abs(d).max()), 1e-30)
            z = np.zeros((r.size, 3, 6), np_fdt)
            z[:, 0, 0] = z[:, 1, 1] = z[:, 2, 2] = 1.0
            z[:, 1, 3] = -d[:, 2] / span
            z[:, 2, 3] = d[:, 1] / span
            z[:, 0, 4] = d[:, 2] / span
            z[:, 2, 4] = -d[:, 0] / span
            z[:, 0, 5] = -d[:, 1] / span
            z[:, 1, 5] = d[:, 0] / span
            Zp[lg[r], :, 6 * k:6 * k + 6] = z * wt[r][:, None, None]
        Q, R = np.linalg.qr(Zp.reshape(3 * nG, -1))
        keep = np.abs(np.diag(R)) > 1e-8 * max(
            float(np.abs(np.diag(R)).max()), 1e-30)
        Zloc[p, :3 * nG, :Q.shape[1]] = Q * keep[None, :]
    offset = np.concatenate([[0], np.cumsum(6 * n_pieces)])
    zcols = np.concatenate([p * 6 * C + np.arange(6 * n_pieces[p])
                            for p in range(P_)]).astype(np.int64)
    # neighbours: the parts holding each of part q's interface nodes, with
    # the node's place in their rows
    import scipy.sparse as sp
    pv, gv = np.nonzero(np.arange(nG_max) < nG_p[:, None])
    B = sp.csc_matrix((gv + 1, (pv, gmap[pv, gv])), shape=(P_, nG_tot))
    tables = []
    for q in range(P_):
        nG = int(nG_p[q])
        sub = B[:, gmap[q, :nG]].tocoo()
        nb = np.unique(sub.row)
        LP = -np.ones((nG_max, nb.size), np.int64)
        LP[sub.col, np.searchsorted(nb, sub.row)] = sub.data - 1
        cols = np.concatenate([offset[p] + np.arange(6 * n_pieces[p])
                               for p in nb])
        src = np.concatenate([j * 6 * C + np.arange(6 * n_pieces[p])
                              for j, p in enumerate(nb)])
        tables.append((nb, LP, cols, src))
    return Zloc, zcols, tables


def _coarse_rows(Zw, nb, LP, cols, src):
    """(E's columns on part q's interface, Y_q [3nG, len(cols)]): the
    coarse basis restricted to q's interface dofs."""
    dev = Zw.device
    nG_max = LP.shape[0]
    lp = torch.as_tensor(LP, device=dev)
    rows = (3 * lp.clamp(min=0))[:, None, :] + torch.arange(
        3, device=dev)[None, :, None]                        # [nG, 3, nb]
    blk = Zw[torch.as_tensor(nb, device=dev)]                # [nb, 3nG, 6C]
    Y = blk[torch.arange(nb.size, device=dev)[None, None, :], rows]
    Y = Y * (lp >= 0)[:, None, :, None]                      # [nG, 3, nb, 6C]
    Y = Y.reshape(3 * nG_max, -1)[:, torch.as_tensor(src, device=dev)]
    return torch.as_tensor(cols, device=dev), Y


def build_hybrid(coords, conn, etype: str, E: float, nu: float,
                 n_parts: int, fixed_nodes=None, labels=None,
                 seed: int = 0, dtype=None, precondition: str = "jacobi",
                 reg: float = 1e-6, slim: bool = False,
                 interior_inverse: bool = False,
                 matrix_free_gg: bool = False, device=None,
                 timings: Optional[dict] = None) -> HybridSystem:
    """Partition, per-part dense blocks and their factors, on `device`
    (None: the CUDA card).

    precondition: "jacobi" (the assembled K_GG diagonal), "nn"
    (Neumann-Neumann: inverse-multiplicity-weighted per-part Schur
    inverses) or "bdd" (nn with the rigid-body coarse space: six modes
    for each face-connected piece of a part).
    reg scales the regularisation of floating-part Schur complements.
    slim (nn/bdd, or jacobi with matrix_free_gg) drops K_GG once the
    blocks that replace it exist; interior_inverse stores K_II^-1 in place
    of the factor; matrix_free_gg applies the assembled interface block
    through the global PartialAssemblyOperator (S is then not kept).
    labels: element part labels [M] (else partition_elements with seed).
    timings, when given, gets the seconds of each stage ("partition",
    "stiffness", "tables", "assembly", "factorization", "schur",
    "coarse", "operator"), each ending in a device synchronise."""
    from ..elements.solid import stiffness
    from ..parallel.partition import partition_elements

    if precondition == "jacobi" and slim and not matrix_free_gg:
        raise ValueError(
            "slim with precondition='jacobi' requires matrix_free_gg=True: "
            "the Jacobi-path Schur matvec reads the dense K_GG blocks "
            "unless the matrix-free interface action replaces them")
    dev = resolve_device(device)
    stages = {k: 0.0 for k in ("partition", "stiffness", "tables",
                               "assembly", "factorization", "schur",
                               "coarse", "operator")}
    tick = StageClock(dev, stages).tick

    conn_np = np.asarray(conn)
    coords_np = (coords.cpu().numpy() if isinstance(coords, torch.Tensor)
                 else np.asarray(coords))
    N = coords_np.shape[0]
    M, k = conn_np.shape
    if labels is None:
        labels, _ = partition_elements(conn_np, etype, n_parts, seed)
    labels = np.asarray(labels)
    tick("partition")

    fdt = _torch_dtype(dtype) or _torch_dtype(coords_np.dtype)
    np_fdt = np.float64 if fdt == torch.float64 else np.float32
    # the element K and the per-part blocks in WORK_DTYPE, each block
    # stored in fdt once nothing more is formed from it
    K = stiffness(torch.as_tensor(coords_np, device=dev).to(WORK_DTYPE),
                  torch.as_tensor(conn_np, device=dev), etype, E, nu)
    # symmetric elimination of fixed dofs (homogeneous): zero rows/cols
    fixed_nodes = (np.asarray(fixed_nodes).reshape(-1)
                   if fixed_nodes is not None else np.zeros(0, np.int64))
    fixed_mask_node = np.zeros(N, bool)
    fixed_mask_node[fixed_nodes] = True
    elem_free = torch.as_tensor(
        np.repeat(~fixed_mask_node[conn_np], 3, axis=1),
        device=dev).to(WORK_DTYPE)
    K = K * elem_free[:, :, None] * elem_free[:, None, :]
    tick("stiffness")

    # node -> parts; interface = nodes in more than one part, plus the
    # fixed nodes (their unit-diagonal equations live in K_GG only)
    pp, nn, pair = _node_parts(conn_np, labels, N)
    n_parts_per_node = np.bincount(nn, minlength=N)
    is_iface = (n_parts_per_node > 1) | fixed_mask_node
    g_nodes = np.nonzero(is_iface)[0]
    g_index = -np.ones(N, np.int64)
    g_index[g_nodes] = np.arange(g_nodes.size)
    P_ = n_parts
    pair_g = is_iface[nn]
    nI_p = np.bincount(pp[~pair_g], minlength=P_)
    nG_p = np.bincount(pp[pair_g], minlength=P_)
    nI_max, nG_max = int(nI_p.max()), int(nG_p.max())
    # each pair's position among its part's interiors (or interfaces):
    # the pairs are sorted by (part, node), as np.unique of each part is
    loc = np.empty(pp.size, np.int64)
    for sel, counts in ((~pair_g, nI_p), (pair_g, nG_p)):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        loc[sel] = np.arange(int(sel.sum())) - starts[pp[sel]]
    gmap = np.zeros((P_, nG_max), np.int64)
    gmask = np.zeros((P_, nG_max), np_fdt)
    imap = np.zeros((P_, nI_max), np.int64)
    imask = np.zeros((P_, nI_max), np_fdt)
    gmap[pp[pair_g], loc[pair_g]] = g_index[nn[pair_g]]
    gmask[pp[pair_g], loc[pair_g]] = 1.0
    imap[pp[~pair_g], loc[~pair_g]] = nn[~pair_g]
    imask[pp[~pair_g], loc[~pair_g]] = 1.0
    # tpufem's scatter plan: (p, local g, comp) -> global interface dof
    targets = (gmap[:, :, None] * 3 + np.arange(3)[None, None, :]).reshape(-1)
    perm = np.argsort(targets, kind="stable").astype(np.int32)
    seg = targets[perm].astype(np.int32)
    rows = np.nonzero(gmask.reshape(-1) > 0)[0]
    combine = CombinePlan.build(gmap.reshape(-1)[rows], rows, P_ * nG_max,
                                g_nodes.size, device=dev)
    tick("tables")

    # per-part blocks on the device: every element entry (a, b) of part p
    # goes to K_II, K_IG or K_GG of p (the K_GI entries are K_IG's mirror)
    nI3, nG3 = 3 * nI_max, 3 * nG_max
    lnode = np.where(pair_g, nI_p[pp] + loc, loc)[pair]       # [M, k]
    ldof = torch.as_tensor((lnode[:, :, None] * 3 + np.arange(3)
                            ).reshape(M, 3 * k), device=dev)
    part = torch.as_tensor(labels.astype(np.int64), device=dev)
    ni3 = torch.as_tensor(3 * nI_p, device=dev)[part]          # [M]
    la = ldof[:, :, None].expand(M, 3 * k, 3 * k)
    lb = ldof[:, None, :].expand(M, 3 * k, 3 * k)
    ni3 = ni3[:, None, None]
    pe = part[:, None, None]
    a_int, b_int = la < ni3, lb < ni3
    chol = K.new_zeros((P_, nI3, nI3))
    K_IG = K.new_zeros((P_, nI3, nG3))
    K_GG = K.new_zeros((P_, nG3, nG3))
    for dense, sel, key in (
            (chol, a_int & b_int, (pe * nI3 + la) * nI3 + lb),
            (K_IG, a_int & ~b_int, (pe * nI3 + la) * nG3 + lb - ni3),
            (K_GG, ~a_int & ~b_int,
             (pe * nG3 + la - ni3) * nG3 + lb - ni3)):
        _segment_into(dense, key[sel], K[sel])
    del la, lb, a_int, b_int, key, sel
    # the unit diagonal of a fixed node, once: on the lowest part that
    # holds it
    fixed_pairs = np.nonzero(pair_g & fixed_mask_node[nn])[0]
    _, first = np.unique(nn[fixed_pairs], return_index=True)
    fp = fixed_pairs[first]
    if fp.size:
        pidx = torch.as_tensor(np.repeat(pp[fp], 3), device=dev)
        didx = torch.as_tensor((loc[fp][:, None] * 3 + np.arange(3)
                                ).reshape(-1), device=dev)
        K_GG[pidx, didx, didx] = K_GG[pidx, didx, didx] + 1.0
    del K
    tick("assembly")

    # padding and any zero diagonal of K_II get a 1 so Cholesky succeeds
    A_II = chol
    d = torch.diagonal(A_II, dim1=1, dim2=2)
    d += (d == 0).to(WORK_DTYPE)
    chol = torch.linalg.cholesky(A_II).to(fdt)
    if precondition == "jacobi" and not interior_inverse:
        del A_II
    tick("factorization")

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    gmd_np = np.repeat(gmask, 3, axis=1)                      # [P, 3nG]
    gmd = t(gmd_np)
    # interface Jacobi: the assembled K_GG diagonal
    diag_G = combine((torch.diagonal(K_GG, dim1=1, dim2=2) * gmd
                      ).reshape(-1, 3))
    Minv_G = torch.where(diag_G.abs() > 0,
                         1.0 / torch.where(diag_G == 0, 1.0, diag_G),
                         0.0).to(fdt)
    meta = HMeta(P_, N, int(g_nodes.size), nI_max, nG_max)
    placeholder = torch.zeros((P_, 1, 1), dtype=fdt, device=dev)
    sys_ = HybridSystem(
        chol=chol, K_IG=K_IG.to(fdt), K_GG=placeholder, gmap=t(gmap),
        gmask=t(gmask), imap=t(imap), imask=t(imask), g_nodes=t(g_nodes),
        scat_perm=perm, scat_seg=seg, combine=combine, Minv_G=Minv_G,
        meta=meta)
    tick("assembly")
    mf_op = mf_free = None
    if matrix_free_gg:
        from ..ops.partial import PartialAssemblyOperator
        # its geometry from the same float64 coordinates as K, stored in
        # fdt: geometry from coordinates rounded to fdt is another mesh's,
        # and its K_GG action would not cancel against K_GI K_II^-1 K_IG
        mf_op = PartialAssemblyOperator.build(
            coords_np, conn_np, etype, E, nu, dtype=WORK_DTYPE, n_nodes=N,
            device=dev).to(fdt)
        mf_free = t(np.repeat(~fixed_mask_node, 3).reshape(N, 3).astype(
            np_fdt))
        tick("operator")

    def chunks(per_part_bytes):
        ch = max(1, min(P_, CHUNK_BYTES // max(per_part_bytes, 1)))
        return [(p0, min(p0 + ch, P_)) for p0 in range(0, P_, ch)]

    def inverse(A):
        """K_II^-1 from its WORK_DTYPE factor, in the system's dtype."""
        return torch.cholesky_inverse(torch.linalg.cholesky(A)).to(fdt)

    item = 8                                  # WORK_DTYPE's bytes
    if precondition == "jacobi":
        if interior_inverse:
            kinv = torch.cat([inverse(A_II[a:b])
                              for a, b in chunks(3 * nI3 * nI3 * item)])
            del A_II
            sys_ = dataclasses.replace(sys_, chol=placeholder, Kinv=kinv)
        tick("schur")
        if timings is not None:
            timings.update(stages)
        return dataclasses.replace(
            sys_, K_GG=placeholder if slim else K_GG.to(fdt), mf_op=mf_op,
            mf_free=mf_free)

    # ---- Neumann-Neumann (+ coarse) interface preconditioner ----------
    # partition-of-unity weights: 1/multiplicity per interface dof, fixed
    # dofs excluded
    mult = np.zeros(g_nodes.size, np_fdt)
    np.add.at(mult, gmap[gmask > 0], 1.0)
    free_g = (~fixed_mask_node[g_nodes]).astype(np_fdt)
    w_g = np.where(mult > 0, 1.0 / np.maximum(mult, 1.0), 0.0) * free_g
    Dw = np.repeat(w_g[gmap] * gmask, 3, axis=1)               # [P, 3nG]
    gfree = np.repeat(free_g, 3).reshape(-1, 3)
    # rigid-body modes on the interface (free dofs only), six for each
    # face-connected piece of a part, QR-orthonormalised per part; dead
    # columns (fully fixed pieces) dropped.  A part of one piece has
    # tpufem's six; an RCB or Morton cut leaves tets joined to the rest of
    # their part by an edge or a node only, and each such piece floats on
    # its own (tpufem's six modes leave its motion out of the coarse space
    # and its S_p + reg near-singular)
    Zloc, zcols, nb_tables = _coarse_basis(
        conn_np, etype, labels, coords_np, is_iface, g_index, gmap, nG_p,
        free_g, np_fdt)
    Zloc_t = t(Zloc)
    bdd = precondition == "bdd"
    if bdd:
        Ec = K_GG.new_zeros((zcols.size, zcols.size), dtype=WORK_DTYPE)
        Zw = Zloc_t.to(WORK_DTYPE)
    keep_S = not matrix_free_gg
    S_parts, Sinv_parts, Kinv_parts = [], [], []
    tick("schur")
    for p0, p1 in chunks(8 * nG3 * nG3 * item + 3 * nI3 * nG3 * item):
        sl = slice(p0, p1)
        L = torch.linalg.cholesky(A_II[sl])
        kig = K_IG[sl]
        tt = _chol_solve(L, kig)                              # K_II^-1 K_IG
        S_true = K_GG[sl] - torch.bmm(kig.transpose(1, 2), tt)
        del tt, kig
        g_ = gmd[sl].to(WORK_DTYPE)
        diag = torch.diagonal(S_true, dim1=1, dim2=2)
        scale = (diag * g_).sum(1) / torch.clamp(g_.sum(1), min=1.0)
        add = reg * scale[:, None] * g_ + (1.0 - g_)          # pad -> 1
        Zl = Zloc_t[sl].to(WORK_DTYPE)
        S_reg = (S_true + torch.diag_embed(add)
                 + scale[:, None, None] * torch.bmm(Zl, Zl.transpose(1, 2)))
        # S_p + its regularisation is SPD: the explicit inverse from its
        # Cholesky factor
        Sinv_parts.append(torch.cholesky_inverse(
            torch.linalg.cholesky(S_reg)).to(fdt))
        del S_reg
        if interior_inverse:
            Kinv_parts.append(torch.cholesky_inverse(L).to(fdt))
        del L
        tick("schur")
        if bdd:
            # E += Y_q^T S_q Y_q over the coarse columns living on part
            # q's interface (its own pieces' and its neighbours'), one
            # part after another
            for q in range(p0, p1):
                cols, Y = _coarse_rows(Zw, *nb_tables[q])
                ix = (cols[:, None], cols[None, :])
                Ec[ix] = Ec[ix] + Y.T @ (S_true[q - p0] @ Y)
            tick("coarse")
        if keep_S:
            S_parts.append(S_true.to(fdt))
        del S_true
    del A_II
    Kinv = torch.cat(Kinv_parts) if interior_inverse else None
    Echol = None
    if bdd:
        del Zw
        de = torch.diagonal(Ec)
        scale_e = de.sum() / torch.clamp((de > 0).sum(), min=1)
        Ec = Ec + torch.diag(torch.where(de <= 1e-12 * scale_e, scale_e,
                                         1e-10 * scale_e))
        Echol = torch.linalg.cholesky(Ec)
        tick("coarse")
    if timings is not None:
        timings.update(stages)
    return dataclasses.replace(
        sys_, chol=placeholder if interior_inverse else chol,
        K_GG=placeholder if slim else K_GG.to(fdt), Kinv=Kinv,
        Sinv=torch.cat(Sinv_parts), S=torch.cat(S_parts) if keep_S else None,
        Dw=t(Dw), gfree=t(gfree), Zloc=Zloc_t, zcols=t(zcols),
        Echol=Echol, mf_op=mf_op, mf_free=mf_free)


def hybrid_solve(coords, conn, etype, E, nu, f, n_parts, fixed_nodes=None,
                 tol=1e-10, max_iter=500, **kw):
    """One-call hybrid solve; f [N, 3] (the fixed nodes' rows are zeroed)."""
    sys_ = build_hybrid(coords, conn, etype, E, nu, n_parts,
                        fixed_nodes=fixed_nodes, **kw)
    f = sys_._force(f).clone()
    if fixed_nodes is not None:
        f[torch.as_tensor(np.asarray(fixed_nodes).reshape(-1),
                          device=f.device).long()] = 0.0
    return sys_.solve(f, tol=tol, max_iter=max_iter)
