"""Fused element stiffness (J -> g -> K) for k <= 10 solid types: K6.

`stiffness_fused` is the wrapper: on a CPU tensor it runs the plain
PyTorch version beside it; on a CUDA tensor it launches the hand-written
kernel (csrc/stiffness.cu) or raises.  Both replace tpufem's Pallas
kernel (tpufem/ops/stiffness_kernels.py, `stiffness_fused`) and follow
its operation order, which the plain version writes out on [M]-vectors:

    J = dN^T X per q (zero weights skipped, the first non-zero term starts
    each sum), cofactors, det, inv_det = 1/det, J^-1 = cofactor * inv_det,
    W_q = w_q det, g = J^-1 dN, and summed over q from q = 0:
    K[(k,c),(l,e)] = W_q (lam g_k[c] g_l[e] + mu g_k[e] g_l[c])
                     + [c == e] (g_k . g_l) (mu W_q).

lam, mu, dN and w are rounded to the working type once.  The kernel is
built with -fmad=false and rounds the same way, so the two agree bitwise
on the card.  Both compute the node pairs k <= l, as tpufem does, and
copy each 3x3 block to its transposed place.  tpufem writes K entry-major
and transposes it in XLA, and pads M with copies of element 0; the kernel
builds a block of elements' [3k, 3k] tiles in shared memory, writes them
to K row-major in one coalesced run and takes the ragged edge in its last
block instead.
"""
from __future__ import annotations

import numpy as np
import torch

from . import cuda
from ..core.materials import lame_parameters
from ..elements.tables import element_table

# (k, q) of the kernel's instantiations: c3d4, c3d10, c3d8 (and c3d8i), c3d6
KERNEL_KQ = ((4, 1), (10, 4), (8, 8), (6, 6))

STIFFNESS_FUSED = cuda.CudaKernel(
    "stiffness_fused", "stiffness.cu", "tpufem/ops/stiffness_kernels.py:113",
    {"tpufem_stiffness_fused": [cuda.I32, cuda.I32, cuda.I32, cuda.VP,
                                cuda.VP, cuda.I64, cuda.VP, cuda.VP,
                                cuda.F64, cuda.F64, cuda.VP, cuda.VP],
     "tpufem_stiffness_elems_per_block": [cuda.I32, cuda.I32, cuda.I32]})


def elems_per_block(k: int, q: int, dtype) -> int:
    """Elements per block of the kernel's (k, q) instantiation in dtype
    (loads the kernel's library, so it needs the CUDA toolkit)."""
    eb = STIFFNESS_FUSED.lib().tpufem_stiffness_elems_per_block(
        int(dtype == torch.float64), k, q)
    if eb <= 0:
        raise ValueError(f"stiffness_fused: no instantiation for ({k}, {q})")
    return eb


def _inputs(coords, conn, etype, rule, dtype):
    table = element_table(etype, rule)
    coords = torch.as_tensor(coords)
    dtype = dtype or coords.dtype
    conn = torch.as_tensor(np.asarray(conn) if not isinstance(
        conn, torch.Tensor) else conn, device=coords.device)
    if conn.dim() != 2 or conn.shape[1] != table.n_nodes:
        raise ValueError(f"stiffness_fused: conn {tuple(conn.shape)} for "
                         f"{etype} ({table.n_nodes} nodes)")
    return table, coords, conn, dtype


def stiffness_fused_plain(coords, conn, etype: str, E: float, nu: float,
                          rule: str = "default", dtype=None) -> torch.Tensor:
    """K [M, 3k, 3k] in the kernel's operation order, on [M]-vectors."""
    table, coords, conn, dtype = _inputs(coords, conn, etype, rule, dtype)
    np_dt = np.float64 if dtype == torch.float64 else np.float32

    def rnd(x) -> float:                 # rounded to the working type once
        return float(np_dt(x))

    dN = np.asarray(table.dN, np.float64)
    w = np.asarray(table.weights, np.float64)
    q, k, _ = dN.shape
    lam, mu = (rnd(x) for x in lame_parameters(E, nu))
    Xe = coords.to(dtype)[conn.long()]                       # [M, k, 3]
    M, d = Xe.shape[0], 3 * k
    X = [[Xe[:, kk, b] for b in range(3)] for kk in range(k)]
    zero = Xe.new_zeros(M)
    out = torch.empty((M, d, d), dtype=dtype, device=coords.device)

    def wsum(terms):
        """Sum of (weight, vector) terms, zero weights skipped, the first
        non-zero term starting the sum."""
        s = None
        for c, v in terms:
            if c == 0.0:
                continue
            t = rnd(c) * v
            s = t if s is None else s + t
        return zero if s is None else s

    for qi in range(q):
        J = [[wsum((dN[qi, kk, a], X[kk][b]) for kk in range(k))
              for b in range(3)] for a in range(3)]
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
        c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
        c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
        c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
        c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
        c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20
        inv_det = torch.reciprocal(det)
        Ji = [[c00 * inv_det, c01 * inv_det, c02 * inv_det],
              [c10 * inv_det, c11 * inv_det, c12 * inv_det],
              [c20 * inv_det, c21 * inv_det, c22 * inv_det]]
        Wq = rnd(w[qi]) * det
        muW = mu * Wq
        g = [[wsum((dN[qi, kk, a], Ji[i][a]) for a in range(3))
              for i in range(3)] for kk in range(k)]
        for kk in range(k):
            for ll in range(kk, k):
                gk, gl = g[kk], g[ll]
                dot = (gk[0] * gl[0] + gk[1] * gl[1] + gk[2] * gl[2]) * muW
                for c in range(3):
                    for e in range(3):
                        t = Wq * (lam * (gk[c] * gl[e]) + mu * (gk[e] * gl[c]))
                        if c == e:
                            t = t + dot
                        i, j = 3 * kk + c, 3 * ll + e
                        if qi == 0:
                            out[:, i, j] = t
                        else:
                            out[:, i, j] += t
    # the lower block triangle: the products commute, so the transposed
    # entries are bitwise the ones the kernel computes
    iu, ju = np.triu_indices(d, 1)
    lower = (ju // 3) > (iu // 3)
    iu, ju = torch.as_tensor(iu[lower]), torch.as_tensor(ju[lower])
    out[:, ju, iu] = out[:, iu, ju]
    return out


def stiffness_fused(coords, conn, etype: str, E: float, nu: float,
                    rule: str = "default", dtype=None) -> torch.Tensor:
    """Element stiffness K [M, 3k, 3k] of a k <= 10 solid type.

    coords [N, 3] (a tensor: its device picks the path), conn [M, k]
    (moved to coords' device); dtype float32 or float64 (default: that of
    coords)."""
    table, coords, conn, dtype = _inputs(coords, conn, etype, rule, dtype)
    q, k, _ = table.dN.shape
    if (k, q) not in KERNEL_KQ:
        raise ValueError(f"stiffness_fused: built for (k, q) in {KERNEL_KQ}, "
                         f"got ({k}, {q}) for {etype}/{rule}")
    if coords.device.type == "cpu":
        return stiffness_fused_plain(coords, conn, etype, E, nu, rule, dtype)
    if coords.device.type != "cuda":
        raise RuntimeError(f"stiffness_fused: no kernel for {coords.device}")
    xyz = coords.to(dtype).contiguous()
    cn = conn.to(torch.int32).contiguous()
    if xyz.dim() != 2 or xyz.shape[1] != 3:
        raise ValueError(f"stiffness_fused: coords {tuple(xyz.shape)}")
    cuda.check_cuda_args("stiffness_fused", xyz.device, dtype, floats=(xyz,),
                         ints=(cn,))
    M, d = cn.shape[0], 3 * k
    out = torch.empty((M, d, d), dtype=dtype, device=xyz.device)
    if M == 0:
        return out
    if int(cn.min()) < 0 or int(cn.max()) >= xyz.shape[0]:
        raise ValueError("stiffness_fused: connectivity outside the nodes")
    dn = np.ascontiguousarray(table.dN, np.float64).reshape(-1)
    wt = np.ascontiguousarray(table.weights, np.float64)
    lam, mu = lame_parameters(E, nu)
    STIFFNESS_FUSED.launch(
        "tpufem_stiffness_fused", int(dtype == torch.float64), k, q,
        cuda.ptr(xyz), cuda.ptr(cn), M, dn.ctypes.data_as(cuda.VP),
        wt.ctypes.data_as(cuda.VP), float(lam), float(mu), cuda.ptr(out),
        cuda.stream(xyz))
    return out
