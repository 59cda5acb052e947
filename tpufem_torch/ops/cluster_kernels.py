"""The clustered operator's in-cluster kernels: K7a cluster_expand and
K7b cluster_compress, and cluster_spmv around them.

The counterpart of tpufem/ops/pallas_kernels.py, whose Pallas kernels
contract a one-hot selection built from lconn on the MXU.  Each public
kernel function here is a wrapper: on a CPU tensor it runs the plain
PyTorch version beside it; on a CUDA tensor it launches the hand-written
kernel (csrc/cluster.cu) or raises.  The plain versions gather and sum by
index, the compress in increasing lane order from 0 as the kernel does, so
the two agree bitwise.

lconn [B, R] int32 is ClusterPlan.lconn [B, E_c, k] flattened
element-major (r = e * k + kk), with entries in [0, L).
"""
from __future__ import annotations

import torch

from . import cuda
from .operator import element_gemv

CLUSTER_EXPAND = cuda.CudaKernel(
    "cluster_expand", "cluster.cu", "tpufem/ops/pallas_kernels.py:61",
    {"tpufem_cluster_expand": [cuda.I32, cuda.VP, cuda.VP, cuda.I64, cuda.I32,
                               cuda.I32, cuda.I32, cuda.VP, cuda.VP]})
CLUSTER_COMPRESS = cuda.CudaKernel(
    "cluster_compress", "cluster.cu", "tpufem/ops/pallas_kernels.py:86",
    {"tpufem_cluster_compress": [cuda.I32, cuda.VP, cuda.VP, cuda.I64,
                                 cuda.I32, cuda.I32, cuda.I32, cuda.VP,
                                 cuda.VP]})


def _check(name, lconn, x, B):
    if lconn.dim() != 2 or x.dim() != 3 or lconn.shape[0] != B:
        raise ValueError(f"{name}: lconn {tuple(lconn.shape)}, values "
                         f"{tuple(x.shape)}")


def cluster_expand_plain(lconn: torch.Tensor, Uc: torch.Tensor
                         ) -> torch.Tensor:
    """ue[b, r, :] = Uc[b, lconn[b, r], :]."""
    B = Uc.shape[0]
    bidx = torch.arange(B, device=Uc.device)[:, None]
    return Uc[bidx, lconn.long()]


def cluster_expand(lconn: torch.Tensor, Uc: torch.Tensor) -> torch.Tensor:
    """[B, L, nd] cluster-unique values -> [B, R, nd] element lanes."""
    B, L, nd = Uc.shape
    _check("cluster_expand", lconn, Uc, B)
    if Uc.device.type == "cpu":
        return cluster_expand_plain(lconn, Uc)
    if Uc.device.type != "cuda":
        raise RuntimeError(f"cluster_expand: no kernel for {Uc.device}")
    cuda.check_cuda_args("cluster_expand", Uc.device, Uc.dtype, floats=(Uc,),
                         ints=(lconn,))
    R = lconn.shape[1]
    out = torch.empty((B, R, nd), dtype=Uc.dtype, device=Uc.device)
    CLUSTER_EXPAND.launch("tpufem_cluster_expand",
                          int(Uc.dtype == torch.float64), cuda.ptr(lconn),
                          cuda.ptr(Uc), B, R, L, nd, cuda.ptr(out),
                          cuda.stream(Uc))
    return out


def cluster_compress_plain(lconn: torch.Tensor, Fe: torch.Tensor, L: int
                           ) -> torch.Tensor:
    """Yc[b, l, :] = sum over r ascending with lconn[b, r] == l of
    Fe[b, r, :], from 0 (one indexed read-add-write per lane r: within one
    r every cluster touches one slot, so nothing collides)."""
    B, R, nd = Fe.shape
    out = Fe.new_zeros((B, L, nd))
    bidx = torch.arange(B, device=Fe.device)
    lc = lconn.long()
    for r in range(R):
        slot = lc[:, r]
        out[bidx, slot] = out[bidx, slot] + Fe[:, r]
    return out


def cluster_compress(lconn: torch.Tensor, Fe: torch.Tensor, L: int
                     ) -> torch.Tensor:
    """[B, R, nd] element-lane values -> [B, L, nd] cluster slot sums."""
    B, R, nd = Fe.shape
    _check("cluster_compress", lconn, Fe, B)
    if lconn.shape[1] != R:
        raise ValueError(f"cluster_compress: lconn {tuple(lconn.shape)}, "
                         f"Fe {tuple(Fe.shape)}")
    if Fe.device.type == "cpu":
        return cluster_compress_plain(lconn, Fe, L)
    if Fe.device.type != "cuda":
        raise RuntimeError(f"cluster_compress: no kernel for {Fe.device}")
    cuda.check_cuda_args("cluster_compress", Fe.device, Fe.dtype,
                         floats=(Fe,), ints=(lconn,))
    if nd != 3 or R * (nd * Fe.element_size() + 4) > 48 * 1024:
        raise ValueError(f"cluster_compress: built for 3 values per node and "
                         f"a cluster's lanes within 48 KB of shared memory; "
                         f"got nd {nd}, R {R}")
    out = torch.empty((B, L, nd), dtype=Fe.dtype, device=Fe.device)
    CLUSTER_COMPRESS.launch("tpufem_cluster_compress",
                            int(Fe.dtype == torch.float64), cuda.ptr(lconn),
                            cuda.ptr(Fe), B, R, L, nd, cuda.ptr(out),
                            cuda.stream(Fe))
    return out


def cluster_spmv(K: torch.Tensor, lconn: torch.Tensor, Uc: torch.Tensor
                 ) -> torch.Tensor:
    """The cluster SpMV core: expand (K7a) -> batched element GEMV (torch)
    -> compress (K7b).  K [B, E_c, d, d]; returns Yc [B, L, nd]."""
    B, L, nd = Uc.shape
    _, E_c, d, _ = K.shape
    ue = cluster_expand(lconn, Uc)                         # [B, E_c*k, nd]
    Fe = element_gemv(K, ue.reshape(B, E_c, d))            # [B, E_c, d]
    return cluster_compress(lconn, Fe.reshape(B, -1, nd), L)
