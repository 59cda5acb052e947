"""The cluster stage three ways, for comparing them on one operator.

The port of tpufem's scripts/probe_fused.py `fused_apply`: one operator
apply whose cluster stage runs as

* "planar": expand_planar (per cluster bucket) writes the element-compute
  layout [3, k, B, E_c] directly, the element math runs once over all
  clusters, compress_planar (per bucket) reads that layout back.  The
  staged apply without its two transposes (lanes_to_planar,
  planar_to_lanes); bitwise equal to it;
* "dense": fused_yc, the one-pass kernel (tpufem's "dense" layout; here
  the only fused kernel);

and the staged pipeline is the operator's own forward with fuse="".
Each is followed by the combine stage.
"""
from __future__ import annotations

import torch

from . import packed_kernels as pk
from .packed import ROW, PackedPartialOperator

MODES = ("planar", "dense")


def expand_planar_stage(op: PackedPartialOperator, X: torch.Tensor,
                        kernel=pk.expand_planar) -> torch.Tensor:
    """X [Nb, 384] -> planar element values ue3 [3, k, B, E_c]: kernel
    once per cluster bucket into its rows (pad-only buckets zero)."""
    p = op.plan
    m = p.meta
    k, E_c = m.nodes_per_elem, m.elems_per_cluster
    ue3 = torch.empty((3, k, m.n_clusters, E_c), dtype=X.dtype,
                      device=X.device)
    for (s, n, wk) in m.c_groups:
        sl = slice(s, s + n)
        if wk == 0 or n == 0:
            ue3[:, :, sl].zero_()
            continue
        kernel(X, p.win_nodes[sl], p.wslot[sl], p.jslot[sl], p.lconn[sl], k,
               E_c, wk=wk, out=ue3[:, :, sl])
    return ue3


def compress_planar_stage(op: PackedPartialOperator, fe3: torch.Tensor,
                          kernel=pk.compress_planar) -> torch.Tensor:
    """Planar element forces fe3 [3, k, B, E_c] -> slot sums Yc [B, 384]:
    kernel once per cluster bucket on its rows."""
    p = op.plan
    m = p.meta
    Yc = torch.empty((m.n_clusters, ROW), dtype=fe3.dtype, device=fe3.device)
    for gi, (s, n, wk) in enumerate(m.c_groups):
        sl = slice(s, s + n)
        if wk == 0 or n == 0:
            Yc[sl].zero_()
            continue
        kernel(fe3[:, :, sl], p.cinc[gi], m.cv_widths[gi], out=Yc[sl])
    return Yc


def planar_stage(op: PackedPartialOperator, X: torch.Tensor) -> torch.Tensor:
    """X [Nb, 384] -> Yc [B, 384] through the planar kernels, the element
    math once over all clusters between them.  Needs 128 % E_c == 0."""
    return compress_planar_stage(
        op, op.element_forces(expand_planar_stage(op, X)))


def fused_apply(op: PackedPartialOperator, X: torch.Tensor, mode: str,
                geometry=None) -> torch.Tensor:
    """One apply X [Nb, 384] -> F [Nb, 384] with the cluster stage of
    `mode` ("planar" or "dense") on any operator; geometry: the
    cluster-major (Jinv, W) for "dense" (default op.cluster_geometry(),
    a copy when op is staged)."""
    if mode == "planar":
        Yc = planar_stage(op, X)
    elif mode == "dense":
        Yc = op.fused_stage(X, geometry=geometry)
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return op.combine_stage(Yc)
