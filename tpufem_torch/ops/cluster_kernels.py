"""The clustered operator's in-cluster kernels: K7a cluster_expand and
K7b cluster_compress, and cluster_spmv around them.

The counterpart of tpufem/ops/pallas_kernels.py, whose Pallas kernels
contract a one-hot selection built from lconn on the MXU.  Each public
kernel function here is a wrapper: on a CPU tensor it runs the plain
PyTorch version beside it; on a CUDA tensor it launches the hand-written
kernel (csrc/cluster.cu) or raises.  The plain versions gather and sum by
index, the compress in increasing lane order from 0 as the kernel does, so
the two agree bitwise.  ``slot_lists`` is the index arithmetic of the
compress kernel (each slot's lanes, r ascending) in plain PyTorch, for the
tests.

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


# one cluster's shared memory in either kernel must fit in a block's
# (csrc/cluster.cu ExpandLayout, CompressLayout); the compress kernel packs
# its lane ranks and slots into 16 bits each; both are instantiated for 1
# to 6 values per node
SMEM_LIMIT = 232448
MAX_LANES, MAX_SLOTS = 32767, 65535
MAX_ND = 6


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def expand_smem_bytes(R: int, L: int, nd: int, itemsize: int) -> int:
    """Shared memory the expand kernel gives one cluster: Uc [L, nd] and
    lconn [R]."""
    return _align16(L * nd * itemsize) + _align16(R * 4)


def compress_smem_bytes(R: int, L: int, nd: int, itemsize: int) -> int:
    """Shared memory the compress kernel gives one cluster: Fe [R, nd],
    lconn [R], the lists [R] and their starts [L + 1]."""
    return (_align16(R * nd * itemsize) + 2 * _align16(R * 4)
            + _align16((L + 1) * 4))


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
    smem = expand_smem_bytes(R, L, nd, Uc.element_size())
    if not 1 <= nd <= MAX_ND or smem > SMEM_LIMIT:
        raise ValueError(
            f"cluster_expand: the kernel takes 1 to {MAX_ND} values per node "
            f"and one cluster's values and lanes within {SMEM_LIMIT} bytes "
            f"of shared memory; got nd {nd}, R {R}, L {L} ({smem} bytes)")
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


def slot_lists(lconn: torch.Tensor, L: int):
    """Each slot's lanes, r ascending, as the compress kernel builds them.

    Over 32-lane chunks of r in order, a lane's rank is its slot's count so
    far plus the number of earlier lanes of its chunk in the same slot
    (__match_any_sync and a popc in the kernel); the starts are the
    exclusive scan of the counts, and lane r goes to its slot's start plus
    its rank.  Returns (start [B, L + 1], lanes [B, R]), int64: slot l's
    lanes are lanes[b, start[b, l]:start[b, l + 1]]."""
    B, R = lconn.shape
    lc = lconn.long()
    dev = lc.device
    cnt = torch.zeros((B, L), dtype=torch.long, device=dev)
    rank = torch.empty((B, R), dtype=torch.long, device=dev)
    for r0 in range(0, R, 32):
        ch = lc[:, r0:r0 + 32]
        w = ch.shape[1]
        below = torch.ones((w, w), dtype=torch.bool, device=dev).tril(-1)
        peers_below = ((ch[:, :, None] == ch[:, None, :]) & below).sum(2)
        rank[:, r0:r0 + w] = cnt.gather(1, ch) + peers_below
        cnt.scatter_add_(1, ch, torch.ones_like(ch))
    start = torch.zeros((B, L + 1), dtype=torch.long, device=dev)
    start[:, 1:] = cnt.cumsum(1)
    lanes = torch.empty((B, R), dtype=torch.long, device=dev)
    lanes.scatter_(1, start.gather(1, lc) + rank,
                   torch.arange(R, device=dev).expand(B, R))
    return start, lanes


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
    smem = compress_smem_bytes(R, L, nd, Fe.element_size())
    if (not 1 <= nd <= MAX_ND or R > MAX_LANES or L > MAX_SLOTS
            or smem > SMEM_LIMIT):
        raise ValueError(
            f"cluster_compress: the kernel takes 1 to {MAX_ND} values per "
            f"node, at most {MAX_LANES} lanes and {MAX_SLOTS} slots per "
            f"cluster, and one cluster's lanes within {SMEM_LIMIT} bytes of "
            f"shared memory; got nd {nd}, R {R}, L {L} ({smem} bytes)")
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
