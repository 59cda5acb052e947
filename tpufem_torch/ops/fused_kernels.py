"""fused_yc: the packed operator's cluster stage in one kernel.

Per cluster: hop 1 gathers each of the 128 slots' three components from
rows of X (read by index through win_nodes/wslot/jslot), hop 2 spreads the
slots to element lanes (lconn), the isotropic partial-assembly action runs
at every quadrature point, and each slot sums its element lanes through
the byte-packed incidence cinc.  Output: slot sums Yc [n, 384].

The wrapper ``fused_yc`` runs the plain PyTorch version ``fused_yc_plain``
on a CPU tensor and the CUDA kernel (csrc/fused_yc.cu, built with
-fmad=false) on a CUDA tensor.  The plain version does the kernel's
arithmetic in the kernel's order (that of tpufem's ``_pa_planes``: same
unrolls, same zero-weight skipping), so the two agree bitwise on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import cuda
from .packed_kernels import (BLK, ROW, _check_widths, _emit, _out,
                             compress_chunks_plain, hop1_plain, planar_chunks)

FUSED_YC = cuda.CudaKernel(
    "fused_yc", "fused_yc.cu", "tpufem/ops/fused_kernels.py:222",
    {"tpufem_fused_yc": [
        cuda.I32, cuda.I32, cuda.I32, cuda.VP, cuda.I64, cuda.VP, cuda.I32,
        cuda.I32, cuda.VP, cuda.VP, cuda.VP, cuda.I32, cuda.VP, cuda.I32,
        cuda.VP, cuda.I32, cuda.VP, cuda.I32, cuda.VP, cuda.F64, cuda.F64,
        cuda.VP, cuda.I32, cuda.VP, cuda.I64, cuda.VP],
     "tpufem_fused_yc_occupancy": [cuda.I32] * 7})
# (k, q) the kernel is instantiated for: the default rules of c3d10, c3d4
# and c3d8 (csrc/fused_yc.cu dispatch)
KERNEL_KQ = ((10, 4), (4, 1), (8, 8))
WARPS_PER_BLOCK = BLK // 32         # a block is 128 threads


def occupancy(dtype, k: int, q: int, Wp: int, Rp: int, n_chunks: int,
              E_c: int) -> int:
    """Blocks of the kernel one SM of the card holds at once for these
    table widths and elements per cluster (needs the card)."""
    res = FUSED_YC.lib().tpufem_fused_yc_occupancy(
        int(dtype == torch.float64), k, q, Wp, Rp, n_chunks, E_c)
    if res < 0:
        raise RuntimeError(f"fused_yc occupancy: CUDA error {-res}")
    return res


def warps_per_sm(dtype, k: int, q: int, plan) -> int:
    """Warps of the kernel one SM holds at once on a PackedPlan: the least
    over the cluster buckets it launches for of the blocks an SM, times
    the warps a block; 0 where it launches for none (needs the card)."""
    m = plan.meta
    blocks = [occupancy(dtype, k, q, plan.cinc[gi].shape[1], m.lanes,
                        len(m.cv_widths[gi]), m.elems_per_cluster)
              for gi, (_, n, wk) in enumerate(m.c_groups) if wk and n]
    return WARPS_PER_BLOCK * min(blocks, default=0)


def _pa_planes(ue, Ji, Wq, dN, lam, mu):
    """Partial-assembly action on per-(component, node) planes.

    ue: nested list [3][k] of planes (element nodal values); Ji: nested
    list [qJ][3][3] of planes (J^-1 entries); Wq: list [q] of planes
    (w * detJ); dN: host numpy [q, k, 3].  Returns nested list [3][k] of
    planes (element nodal forces; None = zero).

    The operation order of tpufem's _pa_planes and of csrc/fused_yc.cu:
    the terms of every sum are added left to right, and terms with a zero
    reference weight are skipped."""
    dN = np.asarray(dN)
    q, k, _ = dN.shape
    qJ = len(Ji)
    Fe = [[None] * k for _ in range(3)]
    for qi in range(q):
        J = Ji[min(qi, qJ - 1)]
        Hhat = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for c in range(3):
                acc = None
                for kk in range(k):
                    wgt = float(dN[qi, kk, a])
                    if wgt == 0.0:
                        continue
                    term = wgt * ue[c][kk]
                    acc = term if acc is None else acc + term
                Hhat[a][c] = acc if acc is not None else 0.0
        H = [[J[i][0] * Hhat[0][c] + J[i][1] * Hhat[1][c]
              + J[i][2] * Hhat[2][c] for c in range(3)] for i in range(3)]
        tr = H[0][0] + H[1][1] + H[2][2]
        sig = [[mu * (H[i][c] + H[c][i]) for c in range(3)] for i in range(3)]
        for i in range(3):
            sig[i][i] = sig[i][i] + lam * tr
        Wp = Wq[qi]
        T = [[Wp * (J[0][j] * sig[0][c] + J[1][j] * sig[1][c]
                    + J[2][j] * sig[2][c]) for c in range(3)]
             for j in range(3)]
        for c in range(3):
            for kk in range(k):
                acc = None
                for j in range(3):
                    wgt = float(dN[qi, kk, j])
                    if wgt == 0.0:
                        continue
                    term = wgt * T[j][c]
                    acc = term if acc is None else acc + term
                if acc is None:
                    continue
                prev = Fe[c][kk]
                Fe[c][kk] = acc if prev is None else prev + acc
    return Fe


def fused_yc_plain(X, win_nodes, wslot, jslot, lconn, cinc, jinv, w, dN,
                   lam, mu, v_widths, *, wk: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature)."""
    n = wslot.shape[0]
    q, k, _ = np.asarray(dN).shape
    E_c = w.shape[2]
    qJ = jinv.shape[1] // 9
    uc = hop1_plain(X, win_nodes, wslot, jslot, wk)
    # hop 2: slots -> element planes [n, E_c]
    lc = lconn.long()
    ue = [[torch.gather(uc[c], 1, lc[:, kk * E_c:(kk + 1) * E_c])
           for kk in range(k)] for c in range(3)]
    Ji = [[[jinv[:, qj * 9 + 3 * i + j, :] for j in range(3)]
           for i in range(3)] for qj in range(qJ)]
    Wq = [w[:, qi, :] for qi in range(q)]
    Fe = _pa_planes(ue, Ji, Wq, dN, lam, mu)
    zero = torch.zeros((n, E_c), dtype=X.dtype, device=X.device)
    chunks = planar_chunks(lambda c, kk: Fe[c][kk], k, E_c, len(v_widths),
                           zero)
    return _emit(torch.cat(compress_chunks_plain(chunks, cinc, v_widths),
                           dim=1), out)


def fused_yc(X: torch.Tensor, win_nodes: torch.Tensor, wslot: torch.Tensor,
             jslot: torch.Tensor, lconn: torch.Tensor, cinc: torch.Tensor,
             jinv: torch.Tensor, w: torch.Tensor, dN, lam: float, mu: float,
             v_widths: Sequence[int], *, wk: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One cluster bucket's slot sums Yc [n, 384].

    X: [Nb, 384] the whole packed field (rows read by index; win_nodes ==
    Nb reads zero).  win_nodes [n, Wn], wslot/jslot [n, 128], lconn
    [n, Rp], cinc [n, Wp, 128]: int32 plan rows of the bucket.  jinv
    [n, qJ*9, E_c] and w [n, q, E_c]: cluster-major geometry.  dN: host
    numpy [q, k, 3]; v_widths: the bucket's incidence chunk widths; wk:
    the bucket's window width."""
    dN = np.asarray(dN, np.float64)
    q, k, _ = dN.shape
    n, L = wslot.shape
    E_c = w.shape[2]
    Rp = lconn.shape[1]
    if (X.shape[1] != ROW or L != BLK or jslot.shape != wslot.shape
            or win_nodes.shape[0] != n or lconn.shape[0] != n
            or cinc.shape[0] != n or cinc.shape[2] != BLK
            or jinv.shape[0] != n or jinv.shape[1] % 9 or jinv.shape[2] != E_c
            or w.shape[:2] != (n, q) or not 0 <= wk <= win_nodes.shape[1]
            or BLK % E_c or Rp < k * E_c
            or len(v_widths) != -(-k * E_c // BLK)):
        raise ValueError("fused_yc: inconsistent shapes")
    _check_widths(cinc, v_widths)
    if X.device.type == "cpu":
        return fused_yc_plain(X, win_nodes, wslot, jslot, lconn, cinc, jinv,
                              w, dN, lam, mu, v_widths, wk=wk, out=out)
    if X.device.type != "cuda":
        raise RuntimeError(f"fused_yc: no kernel for {X.device}")
    cuda.check_cuda_args("fused_yc", X.device, X.dtype, floats=(X, jinv, w),
                         ints=(win_nodes, wslot, jslot, lconn, cinc))
    if (k, q) not in KERNEL_KQ:
        raise ValueError(f"fused_yc: the kernel is built for (k, q) in "
                         f"{KERNEL_KQ}, got ({k}, {q})")
    res = _out(out, n, X)
    dn = np.ascontiguousarray(dN.reshape(-1))
    FUSED_YC.launch(
        "tpufem_fused_yc", int(X.dtype == torch.float64), k, q,
        cuda.ptr(X), X.shape[0], cuda.ptr(win_nodes), win_nodes.shape[1],
        wk, cuda.ptr(wslot), cuda.ptr(jslot), cuda.ptr(lconn), Rp,
        cuda.ptr(cinc), cinc.shape[1], cuda.ptr(jinv), jinv.shape[1] // 9,
        cuda.ptr(w), E_c, dn.ctypes.data_as(cuda.VP), float(lam), float(mu),
        cuda.int_array(v_widths), len(v_widths), cuda.ptr(res), n,
        cuda.stream(X))
    return res
