"""Explicit global-matrix assembly: node-block BSR (3x3 / 6x6 blocks) + SpMV.

The port of tpufem/ops/assembly.py.  The structure (the unique node-block
pairs in CSR order, and the stable sort of the element pair stream onto
them) is built once on the host, bitwise tpufem's tables.  The numeric
assembly, the SpMV's row sums and the diagonal are sorted segment sums
(``torch.segment_reduce`` over lengths counted on the host, as
ScatterPlan.scatter_sorted): a fixed order with no atomics, so values are
the same on every run.

Block values are stored component-planar as in tpufem: ``data9[b*i + j]``
is the [nnzb] stream of block entry (i, j).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device


def segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive runs of `values` along dim 0 (run s has
    lengths[s] entries; an empty run sums to 0): a segment reduction in a
    fixed order, no atomics, no host read."""
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


def _lengths(ids: np.ndarray, n: int, device) -> torch.Tensor:
    return torch.as_tensor(np.bincount(np.asarray(ids, np.int64),
                                       minlength=n), device=device)


@dataclasses.dataclass(frozen=True)
class BSRStructure:
    """Symbolic structure + value-assembly plan for a BSR matrix."""

    indptr: torch.Tensor      # [n_block_rows + 1] int32
    col_ids: torch.Tensor     # [nnzb] int32 block-column per stored block
    row_ids: torch.Tensor     # [nnzb] int32 block-row per block (sorted)
    perm: torch.Tensor        # [M*k*k] int32 stable sort of the pair stream
    segments: torch.Tensor    # [M*k*k] int32 target block per stream entry
    seg_lengths: torch.Tensor  # [nnzb] int64 stream entries per block
    row_lengths: torch.Tensor  # [n_block_rows] int64 blocks per block-row
    n_block_rows: int
    block: int

    @property
    def nnzb(self) -> int:
        return int(self.col_ids.shape[0])

    @property
    def nnz(self) -> int:
        return self.nnzb * self.block ** 2

    @property
    def device(self) -> torch.device:
        return self.col_ids.device


@dataclasses.dataclass(frozen=True)
class BSRMatrix:
    """Block values stored component-planar: data9[b*i + j] is the [nnzb]
    stream of block entry (i, j)."""

    structure: BSRStructure
    data9: torch.Tensor       # [block*block, nnzb]

    @property
    def data(self) -> torch.Tensor:
        """[nnzb, block, block] view (scipy export, tests)."""
        b = self.structure.block
        return self.data9.transpose(0, 1).reshape(-1, b, b)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return bsr_matvec(self, x)

    def diagonal(self) -> torch.Tensor:
        """[n_block_rows * block] main diagonal."""
        s = self.structure
        b = s.block
        diag_mask = (s.row_ids == s.col_ids).to(self.data9.dtype)
        d = torch.stack([self.data9[i * b + i] * diag_mask
                         for i in range(b)], dim=1)          # [nnzb, b]
        return segment_sum(d, s.row_lengths).reshape(-1)


def build_bsr_structure(conn, n_nodes: int, block: int = 3,
                        device=None) -> BSRStructure:
    """Host-side: unique (row, col) node-block pairs in CSR order (tables
    bitwise tpufem's); device=None means the CUDA card."""
    from .scatter import _stable_argsort_i32
    from .. import native

    dev = resolve_device(device)
    conn = np.asarray(conn)
    M, k = conn.shape
    rows = np.repeat(conn, k, axis=1).reshape(-1).astype(np.int64)
    cols = np.tile(conn, (1, k)).reshape(-1).astype(np.int64)
    keys = rows * n_nodes + cols
    nat = native.unique_inverse_i64(keys)
    uniq, inv = nat if nat is not None else np.unique(keys,
                                                      return_inverse=True)
    perm = _stable_argsort_i32(inv.astype(np.int32))
    segments = inv[perm].astype(np.int32)
    urow = (uniq // n_nodes).astype(np.int32)
    ucol = (uniq % n_nodes).astype(np.int32)
    indptr = np.zeros(n_nodes + 1, np.int32)
    np.add.at(indptr, urow + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return BSRStructure(
        indptr=t(indptr), col_ids=t(ucol), row_ids=t(urow), perm=t(perm),
        segments=t(segments), seg_lengths=_lengths(inv, uniq.size, dev),
        row_lengths=_lengths(urow, n_nodes, dev),
        n_block_rows=int(n_nodes), block=int(block))


def assemble_bsr(K_elem: torch.Tensor, conn_k: int,
                 structure: BSRStructure) -> BSRMatrix:
    """Numeric assembly of element matrices K_elem [M, k*b, k*b] (on the
    structure's device) into BSR blocks, one sorted segment sum per block
    component."""
    b = structure.block
    M = K_elem.shape[0]
    k = conn_k
    Ke = K_elem.reshape(M, k, b, k, b)
    perm = structure.perm.long()
    planes = []
    for i in range(b):
        for j in range(b):
            stream = Ke[:, :, i, :, j].reshape(M * k * k)[perm]
            planes.append(segment_sum(stream, structure.seg_lengths))
    return BSRMatrix(structure=structure, data9=torch.stack(planes, dim=0))


def bsr_matvec(A: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[N, b] = A @ x[N, b]: a row gather of x, b*b multiply-adds on the
    [nnzb] streams, and a sorted segment sum over the block rows."""
    s = A.structure
    b = s.block
    xg = x.reshape(-1, b)[s.col_ids.long()]                # [nnzb, b]
    cols = []
    for i in range(b):
        acc = None
        for j in range(b):
            t = A.data9[i * b + j] * xg[:, j]
            acc = t if acc is None else acc + t
        cols.append(acc)
    prod = torch.stack(cols, dim=1)                        # [nnzb, b]
    return segment_sum(prod, s.row_lengths).reshape(x.shape)


def to_scipy(A: BSRMatrix):
    """Export to scipy.sparse.bsr_matrix (host, for validation)."""
    import scipy.sparse as sp
    s = A.structure
    b = s.block
    return sp.bsr_matrix(
        (A.data.cpu().numpy(), s.col_ids.cpu().numpy(),
         s.indptr.cpu().numpy()),
        shape=(s.n_block_rows * b, s.n_block_rows * b))


def assemble_dense(K_elem: torch.Tensor, conn, n_nodes: int,
                   block: int = 3) -> torch.Tensor:
    """Small-problem dense assembly [N*b, N*b] on K_elem's device (each
    block pair is written once: the pairs are unique)."""
    conn = np.asarray(conn)
    s = build_bsr_structure(conn, n_nodes, block, device=K_elem.device)
    A = assemble_bsr(K_elem, conn.shape[1], s)
    b = block
    dense = K_elem.new_zeros((n_nodes, b, n_nodes, b))
    dense[s.row_ids.long(), :, s.col_ids.long(), :] = A.data
    return dense.reshape(n_nodes * b, n_nodes * b)
