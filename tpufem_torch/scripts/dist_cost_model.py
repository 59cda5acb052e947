"""Communication cost model of the packed halo scheme, from the plan alone.

The port of tpufem's scripts/dist_cost_model.py.  The communication volume
of parallel.packed_dist.PackedHaloFEM is a pure function of the partition
of one window_buckets=0 PackedPlan: per part,

  * ghost X block rows: [128-node, 384-lane] rows of the input vector that
    another part owns and this part's cluster windows read (win_nodes);
  * ghost Yc cluster rows: slot-sum rows that this part's block windows
    read from clusters another part owns (winc);

each 384 * itemsize bytes, exchanged once per apply.  These counts are the
Gx and Gc of PackedDistPartition.build (its tables pad an empty list to
one scratch row).  Model, per part count P:

  t_comp(P) = (M / P) * (3k)^2 / rate         (single-card apply rate)
  t_comm(P) = bytes per apply / link bandwidth (one link, one direction)
  efficiency without overlap = t_comp / (t_comp + t_comm)
  efficiency with overlap    = t_comp / max(t_comp, t_comm)

The default rate is the single-card staged f32 apply's at box_tet10(95)
(the window_buckets=0 plan that PackedHaloFEM slices: PackedPartial-
Operator(fuse="") with kernels expand, compress_gather, combine), measured
by chip_smoke.py phase 15 on an NVIDIA H100 80GB HBM3 at a 700.00 W power
limit.  The default link bandwidth is NVLink 4's published 450 GB/s per
direction for the H100 SXM: a specification, not a measurement.  Speed
across cards was never measured here.

Usage: python -m tpufem_torch.scripts.dist_cost_model [n=95]
           [--rate-gnnz R] [--link-gbs B] [--itemsize 4] [--parts 2,4,8,16]
Prints a markdown table and one JSON line (host only: no device).
"""
from __future__ import annotations

import argparse
import json
from typing import Sequence

import numpy as np

# measured: chip_smoke.py phase 15, box_tet10(95), f32 staged apply
# (NVIDIA H100 80GB HBM3, 700.00 W)
RATE_NNZ_PER_S = 117.03e9
# NVLink 4 (H100 SXM): 450 GB/s per direction, the published specification
LINK_BYTES_PER_S = 450e9


def ghost_counts(plan, n_parts: int):
    """Per part: (ghost X block rows, ghost Yc cluster rows, interior
    clusters), and (Bp, Nbp), for the plan split into n_parts parts as
    PackedDistPartition.build splits it."""
    m = plan.meta
    win_nodes = plan.win_nodes.cpu().numpy()[:, :max(m.c_groups[0][2], 1)]
    winc = plan.winc.cpu().numpy()[:, :max(m.b_groups[0][2], 1)]
    B, Nb = m.n_clusters, m.n_blocks
    Bp = -(-B // (n_parts * 8)) * 8
    Nbp = -(-Nb // (n_parts * 8)) * 8
    out = []
    for p in range(n_parts):
        wn = win_nodes[p * Bp:min((p + 1) * Bp, B)]
        valid = wn < Nb
        owner = np.where(valid, wn // Nbp, p)
        gx = np.unique(wn[valid & (owner != p)]).size
        wc = winc[p * Nbp:min((p + 1) * Nbp, Nb)]
        validc = wc < B
        ownc = np.where(validc, wc // Bp, p)
        gc = np.unique(wc[validc & (ownc != p)]).size
        interior = int((owner == p).all(axis=1).sum())
        out.append((int(gx), int(gc), interior))
    return out, (Bp, Nbp)


def cost_rows(plan, n_elements: int, nodes_per_elem: int,
              parts: Sequence[int] = (2, 4, 8, 16),
              rate: float = RATE_NNZ_PER_S,
              link_bw: float = LINK_BYTES_PER_S, itemsize: int = 4):
    """One dict per part count (the model above)."""
    nnz = n_elements * (3 * nodes_per_elem) ** 2
    row_bytes = 3 * 128 * itemsize
    rows = []
    for P in parts:
        per, (Bp, Nbp) = ghost_counts(plan, P)
        gx_max = max(g[0] for g in per)
        gc_max = max(g[1] for g in per)
        bytes_apply = (gx_max + gc_max) * row_bytes
        t_comp = (nnz / P) / rate
        t_comm = bytes_apply / link_bw
        rows.append({
            "parts": P, "owned_block_rows": Nbp, "clusters_per_part": Bp,
            "ghost_x_rows_max": gx_max, "ghost_yc_rows_max": gc_max,
            "surface_over_volume": (gx_max + gc_max) / Nbp,
            "interior_cluster_frac": min(g[2] for g in per) / Bp,
            "bytes_per_apply": bytes_apply,
            "t_comp_ms": t_comp * 1e3, "t_comm_ms": t_comm * 1e3,
            "efficiency_no_overlap": t_comp / (t_comp + t_comm),
            "efficiency_overlapped": t_comp / max(t_comp, t_comm),
        })
    return rows


def main(argv=None, log=print):
    from tpufem_torch.ops.packed import PackedPlan
    from tpufem_torch.utils import meshgen

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=95)
    ap.add_argument("--rate-gnnz", type=float, default=RATE_NNZ_PER_S / 1e9,
                    help="single-card apply rate, 1e9 stiffness entries/s")
    ap.add_argument("--link-gbs", type=float, default=LINK_BYTES_PER_S / 1e9,
                    help="link bandwidth, GB/s in one direction")
    ap.add_argument("--itemsize", type=int, default=4)
    ap.add_argument("--parts", default="2,4,8,16")
    args = ap.parse_args(argv)
    n = args.n
    coords, conn = meshgen.box_tet10(n, n, n)
    M, k = conn.shape
    N = coords.shape[0]
    plan = PackedPlan.build(coords, conn, N, window_buckets=0, device="cpu")
    rate, bw = args.rate_gnnz * 1e9, args.link_gbs * 1e9
    rows = cost_rows(plan, M, k, [int(p) for p in args.parts.split(",")],
                     rate, bw, args.itemsize)
    log(f"mesh: box_tet10({n}) M={M} N={N} nnz/apply="
        f"{M * (3 * k) ** 2:.3g}; rate={rate / 1e9:.1f} Gnnz/s, "
        f"link={bw / 1e9:.0f} GB/s")
    log("| parts | ghost X rows | ghost Yc rows | surface/volume | "
        "interior frac | MB/apply | t_comp ms | t_comm ms | "
        "eff (no ovl) | eff (ovl) |")
    log("|" + "---|" * 10)
    for r in rows:
        log(f"| {r['parts']} | {r['ghost_x_rows_max']} | "
            f"{r['ghost_yc_rows_max']} | {r['surface_over_volume']:.4f} | "
            f"{r['interior_cluster_frac']:.3f} | "
            f"{r['bytes_per_apply'] / 1e6:.2f} | {r['t_comp_ms']:.2f} | "
            f"{r['t_comm_ms']:.3f} | {r['efficiency_no_overlap']:.3f} | "
            f"{r['efficiency_overlapped']:.3f} |")
    log(json.dumps({"mesh_n": n, "elements": M, "rate_nnz_per_s": rate,
                    "link_bytes_per_s": bw, "rows": rows}))
    return rows


if __name__ == "__main__":
    main()
