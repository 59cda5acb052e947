"""Distributed operator + PCG: the port of tpufem/parallel/dist.py, and the
part meshes that the four distributed systems of this package run on.

tpufem writes each system as a per-shard body inside ``shard_map`` over a
device mesh.  Here each body is written once, over a leading axis of the
L parts this process holds, against a small mesh object with tpufem's four
collectives:

* ``all_gather(x[L, B, c]) -> [L, P*B, c]``;
* ``reduce_scatter(x[L, P*B, c]) -> [L, B, c]``: the sum over the parts
  in ascending part order;
* ``ppermute(buf[L, H, ...], pairs) -> [L, H, ...]`` over static (src,
  dst) pairs: a part outside the round's pairs receives zeros, as
  ``jax.lax.ppermute`` gives them;
* ``psum(s[L]) -> 0-d``: one reduction of the [P] partial sums.

Two meshes implement them:

* ``PartMesh(n_parts, device=None)``: all P parts in this process, L = P.
  Every collective is an indexing or a fixed-order sum over the leading
  axis; nothing is read on the host, so a CGBlock captures the body as a
  CUDA graph.  ``make_mesh_1d`` and ``make_mesh_2d`` return one.
* ``GroupMesh(group=None, device=None)``: one part per rank of an
  initialised ``torch.distributed`` process group, L = 1; it runs eagerly.
  Its reductions add the parts in the same order as PartMesh's, so the
  two agree bitwise.

No code picks a backend behind the caller's back.

The scheme of DistFEM (tpufem's): elements are partitioned over the parts;
nodes are owned by the lowest-numbered adjacent part and renumbered so
that each part owns one contiguous, equal-size (padded) block of B rows.
An SpMV all-gathers u, runs the local gather / element GEMV / node-binned
sum and reduce-scatters F.  Dot products are per-part sums, then psum.

The PCG of every system runs on solvers.cg.CGBlock (PartCGBlock overrides
its vdot with the per-part sums and psum).  tpufem's loop keeps the
iterate when the residual norm is NaN or inf; CGBlock keeps it when alpha
or beta is, and reports NAN_INF for either.  The two differ only on a
step that produces a NaN or an inf: converged and max-iter solves give
tpufem's iterates and counts.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..solvers.cg import CGBlock, _MaskConstraint


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class _Done:
    """A finished exchange (PartMesh): wait() returns its result."""

    __slots__ = ("out",)

    def __init__(self, out):
        self.out = out

    def wait(self) -> torch.Tensor:
        return self.out


class PartMesh:
    """P parts held as the leading axis of tensors on one device (L = P).

    part_shape=(hosts, chips) records the 2-level hierarchy of
    make_mesh_2d (part p = host * chips + chip); it changes nothing here
    but the partitioning and the round order of the systems built on it."""

    graphable = True      # no host read: a CGBlock may capture the body
    overlaps = False      # an exchange completes when it is started

    def __init__(self, n_parts: int, device=None,
                 part_shape: Optional[Tuple[int, int]] = None,
                 axis="parts"):
        self.n_parts = int(n_parts)
        if self.n_parts < 1:
            raise ValueError(f"n_parts must be >= 1, got {n_parts}")
        if part_shape is not None and \
                part_shape[0] * part_shape[1] != self.n_parts:
            raise ValueError(f"part_shape {part_shape} != {n_parts} parts")
        self.device = resolve_device(device)
        self.part_shape = (tuple(int(s) for s in part_shape)
                           if part_shape is not None else None)
        self.axis = axis
        self.local_parts = tuple(range(self.n_parts))
        self._pairs = {}

    @property
    def L(self) -> int:
        return self.n_parts

    def take(self, x):
        """[P, ...] per-part array -> this process's [L, ...] tensor on
        the mesh's device."""
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        P = self.n_parts
        full = x.reshape((1, P * x.shape[1]) + tuple(x.shape[2:]))
        return full.expand((P,) + tuple(full.shape[1:]))

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        P = self.n_parts
        B = x.shape[1] // P
        y = x.reshape((P, P, B) + tuple(x.shape[2:]))   # [src, dst, B, ...]
        acc = y[0]
        for q in range(1, P):
            acc = acc + y[q]
        return acc

    def _pair_index(self, pairs):
        key = tuple(pairs)
        if key not in self._pairs:
            src = torch.tensor([s for s, _ in key], dtype=torch.long,
                               device=self.device)
            dst = torch.tensor([d for _, d in key], dtype=torch.long,
                               device=self.device)
            self._pairs[key] = (src, dst)
        return self._pairs[key]

    def prepare(self, rounds) -> None:
        """Make the index tensors of these rounds' pairs now (before any
        graph capture, which cannot copy from the host)."""
        for pairs in rounds:
            self._pair_index(pairs)

    def ppermute_start(self, buf: torch.Tensor, pairs) -> _Done:
        out = torch.zeros_like(buf)
        if pairs:
            src, dst = self._pair_index(pairs)
            out[dst] = buf[src]        # distinct destinations: a plain write
        return _Done(out)

    def ppermute(self, buf: torch.Tensor, pairs) -> torch.Tensor:
        return self.ppermute_start(buf, pairs).wait()

    def psum(self, s: torch.Tensor) -> torch.Tensor:
        return torch.sum(s)


class _Pending:
    """Posted point-to-point operations (GroupMesh): wait() completes them
    and returns the received buffer."""

    __slots__ = ("out", "reqs")

    def __init__(self, out, reqs):
        self.out, self.reqs = out, reqs

    def wait(self) -> torch.Tensor:
        for r in self.reqs:
            r.wait()
        self.reqs = []
        return self.out


class GroupMesh:
    """One part per rank of an initialised torch.distributed process group
    (L = 1).  Runs eagerly (no graph capture).  Collectives:
    all_gather_into_tensor; all_to_all_single and then PartMesh's
    ascending-order sum (not reduce_scatter_tensor, whose order of
    addition is the backend's); batch_isend_irecv of a round's P2POps;
    all_gather of the partial dots, then the [P] sum.  A backend that
    cannot run on the tensors' device raises (NCCL needs a CUDA device,
    gloo a CPU one); nothing is copied to the host."""

    graphable = False
    overlaps = True

    def __init__(self, group=None, device=None,
                 part_shape: Optional[Tuple[int, int]] = None,
                 axis="parts"):
        import torch.distributed as tdist

        if not tdist.is_initialized():
            raise RuntimeError("GroupMesh needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.n_parts = tdist.get_world_size(group)
        self.rank = tdist.get_rank(group)
        self.device = resolve_device(device)
        backend = str(tdist.get_backend(group)).lower()
        if backend == "nccl" and self.device.type != "cuda":
            raise RuntimeError("GroupMesh: the nccl backend needs a CUDA "
                               f"device, got {self.device}")
        if backend == "gloo" and self.device.type != "cpu":
            raise RuntimeError("GroupMesh: the gloo backend runs on CPU "
                               f"tensors here, got {self.device}")
        if part_shape is not None and \
                part_shape[0] * part_shape[1] != self.n_parts:
            raise ValueError(f"part_shape {part_shape} != {self.n_parts} "
                             "ranks")
        self.part_shape = (tuple(int(s) for s in part_shape)
                           if part_shape is not None else None)
        self.axis = axis
        self.local_parts = (self.rank,)
        self._dist = tdist
        # all_gather_into_tensor under its newer name where torch has it
        self._gather = (getattr(tdist, "all_gather_single", None)
                        or tdist.all_gather_into_tensor)

    @property
    def L(self) -> int:
        return 1

    def _peer(self, r: int) -> int:
        if self.group is None:
            return r
        return self._dist.get_global_rank(self.group, r)

    def take(self, x):
        x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return x[self.rank:self.rank + 1].to(self.device)

    def prepare(self, rounds) -> None:
        pass

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        P, B = self.n_parts, x.shape[1]
        out = torch.empty((P * B,) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        self._gather(out, x[0].contiguous(), group=self.group)
        return out[None]

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        P = self.n_parts
        B = x.shape[1] // P
        recv = torch.empty_like(x[0])
        self._dist.all_to_all_single(recv, x[0].contiguous(),
                                     group=self.group)
        y = recv.reshape((P, B) + tuple(x.shape[2:]))   # [src, B, ...]
        acc = y[0]
        for q in range(1, P):
            acc = acc + y[q]
        return acc[None]

    def ppermute_start(self, buf: torch.Tensor, pairs) -> _Pending:
        d = self._dist
        out = torch.zeros_like(buf)
        ops = []
        send = buf[0].contiguous()
        for s, t in pairs:
            if s == self.rank:
                ops.append(d.P2POp(d.isend, send, self._peer(t), self.group))
            if t == self.rank:
                ops.append(d.P2POp(d.irecv, out[0], self._peer(s),
                                   self.group))
        reqs = d.batch_isend_irecv(ops) if ops else []
        return _Pending(out, reqs)

    def ppermute(self, buf: torch.Tensor, pairs) -> torch.Tensor:
        return self.ppermute_start(buf, pairs).wait()

    def psum(self, s: torch.Tensor) -> torch.Tensor:
        out = torch.empty((self.n_parts,), dtype=s.dtype, device=s.device)
        self._gather(out, s.reshape(1).contiguous(), group=self.group)
        return torch.sum(out)


def make_mesh_1d(n_devices: Optional[int] = None, axis: str = "parts",
                 device=None) -> PartMesh:
    """A PartMesh of n_devices parts (None: one per visible CUDA device,
    at least one), tpufem's make_mesh_1d."""
    if n_devices is None:
        n_devices = max(1, torch.cuda.device_count()
                        if torch.cuda.is_available() else 1)
    return PartMesh(n_devices, device=device, axis=axis)


def make_mesh_2d(shape: Tuple[int, int],
                 axes: Tuple[str, str] = ("dcn", "ici"),
                 device=None) -> PartMesh:
    """(hosts, chips-per-host) hierarchy: part p = host * chips + chip.
    With parallel.partition.hierarchical_partition this keeps most halo
    pairs inside a host (tpufem's make_mesh_2d)."""
    return PartMesh(shape[0] * shape[1], device=device,
                    part_shape=tuple(shape), axis=tuple(axes))


# ---------------------------------------------------------------------------
# PCG over a mesh
# ---------------------------------------------------------------------------

class PartCGBlock(CGBlock):
    """CGBlock on [L, rows, c] state: each dot product is the per-part sums
    (tpufem's pdot: in dot_dtype) and mesh.psum, cast to the vectors'
    dtype.  Graph-captured on a PartMesh on the card; eager on a
    GroupMesh."""

    def __init__(self, mesh, A, like, **kw):
        self.mesh = mesh
        super().__init__(A, like, **kw)
        if not mesh.graphable:
            self.graphed = False

    def vdot(self, a, c):
        ddt = self.ddt
        s = torch.stack([torch.sum(a[l].to(ddt) * c[l].to(ddt))
                         for l in range(a.shape[0])])
        return self.mesh.psum(s).to(self.dtype)


def inverse_diagonal(diag: torch.Tensor) -> torch.Tensor:
    """1 / diag where diag != 0, else 0 (tpufem's Jacobi rule)."""
    return torch.where(torch.abs(diag) > 0,
                       1.0 / torch.where(diag == 0, 1.0, diag), 0.0)


class PartSystem:
    """What the four systems share: the rows this process holds, spmv and
    pcg around a per-part body `_spmv_body(u [L, rows, width])`.

    Vectors are passed as this process's rows [L * rows, width] (a
    PartMesh holds every part, so these are the global rows), or as the
    global rows [P * rows, width], of which the local parts are taken."""

    rows_per_part: int
    width: int

    def _init_system(self, mesh, free_mask=None, M_inv=None):
        self.mesh = mesh
        self.free_mask = free_mask
        self.M_inv = M_inv
        self._pcg = {}
        self._lidx = torch.arange(mesh.L, device=mesh.device)[:, None]

    @property
    def n_local_rows(self) -> int:
        return self.mesh.L * self.rows_per_part

    def _local(self, x, dtype=None) -> torch.Tensor:
        """This process's [L, rows, width] view of x."""
        m, R, w = self.mesh, self.rows_per_part, self.width
        x = torch.as_tensor(x, device=m.device)
        if dtype is not None:
            x = x.to(dtype)
        if m.L < m.n_parts and x.shape[0] == m.n_parts * R:
            x = x.reshape(m.n_parts, R, w)[list(m.local_parts)]
        return x.reshape(m.L, R, w)

    def local_rows(self, x) -> torch.Tensor:
        """Global [P * rows, width] -> this process's [L * rows, width]."""
        return self._local(x).reshape(self.n_local_rows, self.width)

    def gather(self, x) -> torch.Tensor:
        """This process's rows -> the global [P * rows, width] (an
        all_gather on a GroupMesh)."""
        u = self.mesh.all_gather(self._local(x))
        return u[0].reshape(-1, self.width)

    def _spmv_body(self, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def spmv(self, u) -> torch.Tensor:
        out = self._spmv_body(self._local(u))
        return out.reshape(self.n_local_rows, self.width)

    def _apply_M(self, like):
        """The preconditioner CGBlock takes: None (identity), a tensor
        (scalar Jacobi) or a callable."""
        if self.M_inv is None:
            return None
        return self._local(self.M_inv, like.dtype)

    def _block(self, bl, tol, eps, dot_dtype) -> PartCGBlock:
        """The PartCGBlock of these settings, made at first use (its
        graphs are captured once on a PartMesh on the card)."""
        key = (float(tol), float(eps), str(dot_dtype), bl.dtype)
        blk = self._pcg.get(key)
        if blk is None:
            mask = (self._local(self.free_mask, bl.dtype)
                    if self.free_mask is not None else torch.ones_like(bl))
            # the block holds the body weakly: the system holds the block,
            # and a cycle would keep both (and the graphs' memory pools)
            # alive after the caller drops the system, for the cyclic
            # collector to free later, maybe inside another system's
            # graph capture, which then fails
            body = weakref.WeakMethod(self._spmv_body)
            blk = PartCGBlock(self.mesh, lambda u: body()(u), bl,
                              constraints=_MaskConstraint(mask),
                              M_inv=self._apply_M(bl), tol=tol, eps=eps,
                              dot_dtype=dot_dtype)
            self._pcg[key] = blk
        return blk

    def warm(self, b, tol: float = 1e-8, max_iter: int = 1000,
             eps: float = 1e-30, dot_dtype=None) -> None:
        """Capture the blocks of a pcg with these settings without running
        them (nothing on a GroupMesh or the CPU)."""
        from ..solvers.cg import CHECK_EVERY
        blk = self._block(self._local(b), tol, eps, dot_dtype)
        for n in {min(CHECK_EVERY, max_iter), max_iter % CHECK_EVERY}:
            if n:
                blk.capture(n)

    def pcg(self, b, x0=None, tol: float = 1e-8, max_iter: int = 1000,
            eps: float = 1e-30, dot_dtype=None):
        """Distributed PCG; b [rows, width] in the system's row order.
        Returns (u, SolveInfo) as tpufem's (u: this process's rows).  One
        PartCGBlock per (tol, eps, dot_dtype, dtype) serves every call."""
        bl = self._local(b)
        blk = self._block(bl, tol, eps, dot_dtype)
        x0l = self._local(x0, bl.dtype) if x0 is not None else None
        u, info = blk.solve(bl.contiguous(), x0=x0l, max_iter=max_iter)
        return u.reshape(self.n_local_rows, self.width), info


# ---------------------------------------------------------------------------
# host-side partition builders (shared by the systems)
# ---------------------------------------------------------------------------

def owned_numbering(owner: np.ndarray, n_parts: int):
    """(B, rank, new_from_old, old_from_new): each part owns one block of B
    rows (B = its largest owned count), nodes ranked within their owner by
    old id (tpufem's renumbering)."""
    n_nodes = owner.shape[0]
    counts = np.bincount(owner, minlength=n_parts)
    B = int(counts.max())
    order = np.argsort(owner, kind="stable")
    rank = np.empty(n_nodes, dtype=np.int64)
    offsets = np.zeros(n_parts + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)
    rank[order] = np.arange(n_nodes) - offsets[owner[order]]
    new_from_old = owner * B + rank
    old_from_new = np.full(n_parts * B, -1, dtype=np.int64)
    old_from_new[new_from_old] = np.arange(n_nodes)
    return B, rank, new_from_old, old_from_new


def node_bins(rows: np.ndarray, n_rows: int, W: int, fill: int,
              out: np.ndarray) -> None:
    """out[r, :count] = the positions of rows == r in stable order, the
    rest `fill` (out [n_rows, W], filled in place)."""
    out[...] = fill
    cnt = np.bincount(rows, minlength=n_rows)
    srt = np.argsort(rows, kind="stable")
    starts = np.zeros(n_rows + 1, np.int64)
    starts[1:] = np.cumsum(cnt)
    sn = rows[srt]
    col = np.arange(rows.size) - starts[sn]
    out[sn, col] = srt


def padded_stiffness(K_elem, labels: np.ndarray, n_parts: int, Mp: int):
    """[P, Mp, d, d] element stiffness per part (zero pad rows), on K's
    device (a tensor) or as a CPU tensor (an array)."""
    K = (K_elem if torch.is_tensor(K_elem)
         else torch.from_numpy(np.array(K_elem)))
    d = K.shape[-1]
    out = torch.zeros((n_parts, Mp, d, d), dtype=K.dtype, device=K.device)
    for p in range(n_parts):
        sel = np.nonzero(labels == p)[0]
        out[p, :sel.size] = K[torch.as_tensor(sel, device=K.device)]
    return out


def fixed_mask_new(n_nodes: int, fixed_nodes, new_from_old: np.ndarray,
                   n_rows: int, dtype) -> np.ndarray:
    """[n_rows, 3] 0/1 mask in the new order (0 on fixed nodes' DOFs, 0 on
    padding rows)."""
    mask_old = np.ones((n_nodes, 3), dtype=dtype)
    mask_old[np.asarray(fixed_nodes)] = 0.0
    mask_new = np.zeros((n_rows, 3), dtype=dtype)
    mask_new[new_from_old] = mask_old
    return mask_new


# ---------------------------------------------------------------------------
# DistFEM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _DistMeta:
    n_parts: int
    block_rows: int       # B owned (padded) nodes per part
    n_nodes: int          # original N
    elems_per_part: int   # Mp (padded)
    dof_per_elem: int


class _Reorder:
    """Host-side reorder helpers between the old node order and the new
    padded one (tpufem's to_new / to_old)."""

    def to_new(self, field) -> torch.Tensor:
        """[N, c] old node order -> [P*B, c] padded new order."""
        f = (field if torch.is_tensor(field)
             else torch.as_tensor(np.asarray(field)))
        out = f.new_zeros((self.meta.n_parts * self.meta.block_rows,
                           f.shape[1]))
        out[torch.as_tensor(self.new_from_old, device=f.device).long()] = f
        return out

    def to_old(self, field_new) -> torch.Tensor:
        """[P*B, c] padded new order -> [N, c]."""
        f = (field_new if torch.is_tensor(field_new)
             else torch.as_tensor(np.asarray(field_new)))
        return f[torch.as_tensor(self.new_from_old, device=f.device).long()]


@dataclasses.dataclass(frozen=True)
class DistPartition(_Reorder):
    """Partition plan; leading axis = parts.  The integer tables are host
    numpy (int32, tpufem's); K is a tensor on the element stiffness's
    device."""

    K: torch.Tensor            # [P, Mp, d, d]
    conn: np.ndarray           # [P, Mp, k] int32 (padded new-id node space)
    inc: np.ndarray            # [P, P*B, W] int32 rows into Fe [Mp*k (+1)]
    new_from_old: np.ndarray   # [N] int32 node renumbering
    old_from_new: np.ndarray   # [P*B] int32 (padding rows -> -1)
    meta: _DistMeta

    @staticmethod
    def build(K_elem, conn, n_nodes: int, labels, n_parts: int,
              dof_per_node: int = 3) -> "DistPartition":
        """Host-side construction from element stiffness (a tensor or an
        array [M, d, d]) + partition labels."""
        from .partition import owner_of_nodes

        conn = np.asarray(conn)
        labels = np.asarray(labels)
        M, k = conn.shape
        d = k * dof_per_node
        owner = owner_of_nodes(conn, labels, n_nodes)
        B, _, new_from_old, old_from_new = owned_numbering(owner, n_parts)
        Mp = int(np.bincount(labels, minlength=n_parts).max())
        n_nodes_pad = n_parts * B

        conn_new = new_from_old[conn]
        conn_pad = np.zeros((n_parts, Mp, k), dtype=np.int64)
        part_rows = []
        W = 1
        for p in range(n_parts):
            sel = np.nonzero(labels == p)[0]
            conn_pad[p, :sel.size] = conn_new[sel]
            rows = conn_new[sel].reshape(-1)          # node per (e_local, l)
            W = max(W, int(np.bincount(rows, minlength=n_nodes_pad).max()))
            part_rows.append(rows)
        # per-part node-binned incidence over REAL element rows only
        # (padding elements have zero K and never enter any bin)
        inc = np.empty((n_parts, n_nodes_pad, W), dtype=np.int32)
        for p in range(n_parts):
            node_bins(part_rows[p], n_nodes_pad, W, Mp * k, inc[p])
        return DistPartition(
            K=padded_stiffness(K_elem, labels, n_parts, Mp),
            conn=conn_pad.astype(np.int32), inc=inc,
            new_from_old=new_from_old.astype(np.int32),
            old_from_new=old_from_new.astype(np.int32),
            meta=_DistMeta(n_parts, B, n_nodes, Mp, d))


def gather_rows(x: torch.Tensor, lidx: torch.Tensor, idx: torch.Tensor
                ) -> torch.Tensor:
    """x[l, idx[l]] for every local part l (idx [L, ...] long)."""
    return x[lidx.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def element_gemv(K: torch.Tensor, ue: torch.Tensor) -> torch.Tensor:
    """Fe[l, m] = K[l, m] @ ue[l, m] (tpufem's "mij,mj->mi" per part)."""
    return torch.einsum("lmij,lmj->lmi", K, ue)


def bin_sum(rows: torch.Tensor, lidx: torch.Tensor, inc: torch.Tensor
            ) -> torch.Tensor:
    """Node-binned sums: rows [L, R, c] plus a zero pad row, gathered
    through inc [L, n, W] (pad = R) and summed over W in bin order."""
    L, _, c = rows.shape
    padded = torch.cat([rows, rows.new_zeros((L, 1, c))], dim=1)
    return gather_rows(padded, lidx, inc).sum(dim=2)


class DistFEM(PartSystem):
    """Distributed matrix-free FEM system on a part mesh."""

    width = 3

    def __init__(self, mesh, axis: str, part: DistPartition,
                 free_mask=None, M_inv=None):
        self.axis = axis
        self.part = part
        m = part.meta
        self.rows_per_part = m.block_rows
        self.n_dof_pad = m.n_parts * m.block_rows * 3
        self._init_system(mesh, free_mask, M_inv)
        self.K = mesh.take(part.K)
        self.conn = mesh.take(part.conn).long()
        self.inc = mesh.take(part.inc).long()

    @property
    def dtype(self) -> torch.dtype:
        return self.K.dtype

    def _spmv_body(self, u: torch.Tensor) -> torch.Tensor:
        """u_own [L, B, 3] -> F_own [L, B, 3]: all_gather, the local gather
        / GEMV / node-binned sum, reduce_scatter."""
        m = self.part.meta
        L = u.shape[0]
        u_full = self.mesh.all_gather(u)                       # [L, P*B, 3]
        ue = gather_rows(u_full, self._lidx, self.conn).reshape(
            L, m.elems_per_part, m.dof_per_elem)
        Fe = element_gemv(self.K, ue)
        F_full = bin_sum(Fe.reshape(L, -1, 3), self._lidx, self.inc)
        return self.mesh.reduce_scatter(F_full)

    def jacobi_preconditioner(self) -> torch.Tensor:
        """Owned-row inverse diagonal [L*B, 3] via one distributed pass."""
        L = self.mesh.L
        d = torch.diagonal(self.K, dim1=2, dim2=3).reshape(L, -1, 3)
        diag = self.mesh.reduce_scatter(bin_sum(d, self._lidx, self.inc))
        return inverse_diagonal(diag).reshape(self.n_local_rows, 3)


def build_distributed_fem(coords, conn, etype: str, E: float, nu: float,
                          n_parts: Optional[int] = None, mesh=None,
                          axis: str = "parts", fixed_nodes=None, labels=None,
                          seed: int = 0, dtype=None, precondition: bool = True,
                          device=None) -> Tuple[DistFEM, DistPartition]:
    """One-call setup: partition + element stiffness (the port's
    solid.stiffness: kernel stiffness_fused on the card) + the distributed
    system.  mesh=None: make_mesh_1d(n_parts, device=device)."""
    from ..elements.solid import stiffness
    from .partition import partition_elements

    mesh = mesh or make_mesh_1d(n_parts, axis, device=device)
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
    part = DistPartition.build(K, conn_np, N, labels, n_parts, 3)
    del K
    fem = DistFEM(mesh, axis, part)
    _set_mask_and_jacobi(fem, part, N, fixed_nodes, precondition)
    return fem, part


def _set_mask_and_jacobi(fem, part, N: int, fixed_nodes,
                         precondition) -> None:
    """free_mask from fixed_nodes, then M_inv = Jacobi * free_mask
    (tpufem's build_* tail for DistFEM, HaloFEM, HaloPartialFEM)."""
    m = part.meta
    dt = fem.dtype
    if fixed_nodes is not None:
        mask = fixed_mask_new(N, fixed_nodes, np.asarray(part.new_from_old),
                              m.n_parts * m.block_rows,
                              np.float64 if dt == torch.float64
                              else np.float32)
        fem.free_mask = fem.local_rows(torch.as_tensor(mask))
    if precondition:
        fem.M_inv = fem.jacobi_preconditioner()
        if fem.free_mask is not None:
            fem.M_inv = fem.M_inv * fem.free_mask

