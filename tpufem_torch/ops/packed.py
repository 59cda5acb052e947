"""Packed-layout clustered matrix-free operator (PyTorch port).

The port of tpufem/ops/packed.py's main path: the same plan tables, the
same packed layout and the same fixed summation order, so plan tables
compare bitwise with tpufem's and operator results agree to roundoff.

* Every hot vector is a ``[Nb, 384]`` tile: lane c * 128 + n % 128 holds
  component c of node n of the row's 128-node block.
* Elements are Morton-ordered and grouped into clusters of E_c consecutive
  elements with at most 128 unique nodes (slots); nodes are renumbered in
  first-touch cluster order, so each cluster reads few node-block rows
  (window Wn) and each node block receives from few clusters (window Wc).
* Clusters and node blocks are sorted into window buckets; each bucket
  runs its kernels at its own window width.
* One apply, fused (fuse="dense"/"narrow", the default when E_c divides
  128): per cluster bucket, the fused_yc kernel gathers X rows by index,
  applies the partial-assembly action and sums each slot's element lanes
  (Yc [B, 384]).  Staged (fuse="", any E_c): per cluster bucket the
  expand kernel writes the element lanes ue [B, 3, Rp]; the planar
  element math runs once over all clusters in plain PyTorch; the
  compress_gather kernel sums the slots.  Then the combine kernel sums
  each node's cluster slots (F [Nb, 384]), all block buckets in one
  launch.  No window rows (Xw, Ycw) are materialized: the kernels read
  rows of X and Yc by index.
* Block Jacobi: the assembled 3x3 node-block diagonal (block_diagonal),
  inverted in closed form per node (invert_block_planes, BlockJacobi).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.profiling import count, span, spanned
from . import fused_kernels as fk
from . import packed_kernels as pk

L_SLOTS = 128          # slots per cluster
BLK = 128              # nodes per packed row
ROW = 3 * BLK          # lanes per packed row
# cluster and block counts and bucket boundaries align to this many rows
# (tpufem's Pallas tile; kept so that the plan tables compare bitwise)
TILE = 64


# ---------------------------------------------------------------------------
# host-side ordering
# ---------------------------------------------------------------------------

def _spread_bits(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_order(coords: np.ndarray, conn: np.ndarray) -> np.ndarray:
    """Element permutation by 30-bit Morton code of the centroid of the
    first (up to 4) nodes, in float32."""
    kc = min(conn.shape[1], 4)
    cent = coords[conn[:, :kc]].astype(np.float32, copy=False).mean(axis=1)
    mn, mx = cent.min(0), cent.max(0)
    q = ((cent - mn) / np.maximum(mx - mn, 1e-30) * 1023.0).astype(np.uint64)
    key = (_spread_bits(q[:, 0]) | (_spread_bits(q[:, 1]) << 1)
           | (_spread_bits(q[:, 2]) << 2))
    from .. import native
    perm = native.radix_argsort(key.astype(np.int32))  # 30-bit keys fit i32
    if perm is not None:
        return perm
    return np.argsort(key, kind="stable")


def _chunk_unique_counts(conn_rows: np.ndarray) -> np.ndarray:
    """#unique valid (>=0) nodes per row of [n, w]."""
    srt = np.sort(conn_rows, axis=1)
    first = np.ones_like(srt, dtype=bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    first &= srt >= 0
    return first.sum(axis=1)


def _bucket_groups(counts: np.ndarray, max_groups: int = 4,
                   align: int = TILE) -> Tuple[Tuple[int, int, int], ...]:
    """Optimal contiguous grouping of ASCENDING-sorted window counts.

    Returns ((start, size, width), ...) covering [0, len(counts)), width =
    max count in the group, minimizing sum(size * width) over <= max_groups
    groups (DP over the run boundaries of distinct counts).  Interior
    boundaries are aligned down to `align` rows."""
    n = int(counts.size)
    if n == 0:
        return ()
    ends = np.nonzero(np.diff(counts))[0] + 1
    ends = np.concatenate([ends, [n]]).astype(np.int64)  # end of each run
    vals = counts[ends - 1].astype(np.int64)
    V = ends.size
    G = min(max_groups, V)
    INF = float("inf")
    dp = np.full((G + 1, V + 1), INF)
    dp[0, 0] = 0.0
    choice = np.zeros((G + 1, V + 1), np.int64)
    for g in range(1, G + 1):
        for v in range(1, V + 1):
            for p in range(v):           # last group covers runs (p, v]
                if dp[g - 1, p] == INF:
                    continue
                start = 0 if p == 0 else int(ends[p - 1])
                c = dp[g - 1, p] + (int(ends[v - 1]) - start) * int(vals[v - 1])
                if c < dp[g, v]:
                    dp[g, v] = c
                    choice[g, v] = p
    g_best = int(np.argmin(dp[1:, V])) + 1
    bounds = []
    v = V
    for g in range(g_best, 0, -1):
        bounds.append(v)
        v = int(choice[g, v])
    bounds = bounds[::-1]
    groups = []
    prev = 0
    for i, v in enumerate(bounds):
        end = n if i == len(bounds) - 1 else (int(ends[v - 1]) // align) * align
        if end <= prev:
            continue
        groups.append((prev, end - prev, int(counts[end - 1])))
        prev = end
    return tuple(groups)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedMeta:
    n_nodes: int
    n_blocks: int          # Nb (padded to TILE)
    n_clusters: int        # B (padded to TILE)
    elems_per_cluster: int
    nodes_per_elem: int
    lanes: int             # Rp = ceil(k*E_c/128)*128
    win_n: int             # Wn (global max; buckets use their own widths)
    win_c: int             # Wc (global max)
    c_groups: Tuple[Tuple[int, int, int], ...] = ()   # (start, size, width)
    b_groups: Tuple[Tuple[int, int, int], ...] = ()
    # per cluster bucket, per 128-lane chunk: incidence list widths
    cv_widths: Tuple[Tuple[int, ...], ...] = ()


_TABLES = ("win_nodes", "wslot", "jslot", "lconn", "winc", "slotidx",
           "new_from_old", "old_from_new", "esrc")


@dataclasses.dataclass(frozen=True)
class PackedPlan:
    """Cluster/window/permutation tables of the packed operator (int32
    tensors on one device)."""

    win_nodes: torch.Tensor    # [B, Wn] node-block row (pad -> Nb)
    wslot: torch.Tensor        # [B, 128] window index of slot (pad -> Wn)
    jslot: torch.Tensor        # [B, 128] lane within window row
    lconn: torch.Tensor        # [B, Rp] slot of each element lane
    # per-bucket compress incidence [n_g, ceil(sum(cv_widths[g])/4), 128]:
    # 4 byte-packed lane+1 entries per word (0 = unused)
    cinc: Tuple[torch.Tensor, ...]
    winc: torch.Tensor         # [Nb, Wc] cluster (pad -> B)
    # [Nb, ceil(Wc/4), 128]: byte w%4 of word w//4 = slot + 1 of the node
    # in window cluster w (0 = absent)
    slotidx: torch.Tensor
    new_from_old: torch.Tensor  # [N]
    old_from_new: torch.Tensor  # [Nb*128] (-1 pad)
    esrc: torch.Tensor         # [B*E_c] original element id (-1 pad)
    meta: PackedMeta

    @property
    def device(self) -> torch.device:
        return self.lconn.device

    def __post_init__(self):
        # built with the plan, never at first use (which may be inside a
        # CUDA graph capture, where no table can be made)
        object.__setattr__(self, "row_wk", self._row_widths())

    def _row_widths(self) -> torch.Tensor:
        """row_wk, [Nb] int32: the combine window width of each node-block
        row, its block bucket's width cut after its last real window
        (winc < B).  The windows cut are padding, which adds nothing, so
        combine over these widths equals combine bucket by bucket."""
        m = self.meta
        bucket = torch.zeros(m.n_blocks, dtype=torch.long, device=self.device)
        for (s, n, wk) in m.b_groups:
            bucket[s:s + n] = wk
        w = torch.arange(1, self.winc.shape[1] + 1, device=self.device)
        last = torch.where(self.winc < m.n_clusters, w, 0).amax(1)
        return torch.minimum(bucket, last).to(torch.int32).contiguous()

    def to(self, device) -> "PackedPlan":
        dev = torch.device(device)
        fields = {n: getattr(self, n).to(dev) for n in _TABLES}
        return PackedPlan(cinc=tuple(c.to(dev) for c in self.cinc),
                          meta=self.meta, **fields)

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray], meta: dict,
                    device=None) -> "PackedPlan":
        """Plan from tpufem's on-disk tables: `arrays` maps the table names
        (cinc as cinc_0, cinc_1, ...) to int32 arrays, `meta` is the
        meta.json dict that tpufem's PackedPlan.save writes.  device=None
        means the CUDA card."""
        dev = resolve_device(device)
        m = PackedMeta(
            meta["n_nodes"], meta["n_blocks"], meta["n_clusters"],
            meta["elems_per_cluster"], meta["nodes_per_elem"], meta["lanes"],
            meta["win_n"], meta["win_c"],
            tuple(tuple(g) for g in meta["c_groups"]),
            tuple(tuple(g) for g in meta["b_groups"]),
            tuple(tuple(w) for w in meta["cv_widths"]))
        n_cinc = meta.get("n_cinc", len(m.c_groups))
        t = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, dtype=np.int32)).to(dev)
        return PackedPlan(
            cinc=tuple(t(arrays[f"cinc_{i}"]) for i in range(n_cinc)),
            meta=m, **{n: t(arrays[n]) for n in _TABLES})

    @staticmethod
    @spanned("plan.build")
    def build(coords, conn, n_nodes: int, elems_per_cluster: int = 32,
              order: Optional[np.ndarray] = None, window_buckets: int = 8,
              device=None) -> "PackedPlan":
        """Build the plan in host numpy (native engine where available,
        numpy fallbacks otherwise) and move its tables to `device` (None:
        the CUDA card).  Its stages are spans plan.order, plan.clusters,
        plan.numbering, plan.slots, plan.windows, plan.buckets,
        plan.tables and plan.to_device."""
        from .. import native

        with span("plan.order"):
            dev = resolve_device(device)
            conn = np.asarray(conn)
            coords = np.asarray(coords)
            M, k = conn.shape
            E_c = elems_per_cluster
            if order is None:
                order = morton_order(coords, conn)
            conn_m = conn[order].astype(np.int32)

        # clusters: E_c consecutive Morton elements; halve ranges whose
        # unique-node count exceeds the 128-slot budget
        with span("plan.clusters"):
            Mpad0 = -(-M // E_c) * E_c
            conn_u = np.full((Mpad0 // E_c, E_c, k), -1, np.int32)
            conn_u.reshape(-1, k)[:M] = conn_m
            cnt0 = _chunk_unique_counts(conn_u.reshape(-1, E_c * k))
            good = cnt0 <= L_SLOTS
            ranges = []                                # (start, stop) pairs
            for i in np.nonzero(good)[0]:
                ranges.append((int(i) * E_c, min((int(i) + 1) * E_c, M)))
            for i in np.nonzero(~good)[0]:                 # rare over-budget
                stack = [(int(i) * E_c, min((int(i) + 1) * E_c, M))]
                while stack:
                    a, b = stack.pop()
                    if (b - a <= 1 or np.unique(conn_m[a:b]).size <= L_SLOTS):
                        ranges.append((a, b))
                    else:
                        mid = (a + b) // 2
                        stack.extend([(mid, b), (a, mid)])
            ranges.sort()                              # keep Morton locality
            B = len(ranges)
            Bpad = -(-B // TILE) * TILE
            ra = np.full(Bpad, M, np.int64)
            rl = np.zeros(Bpad, np.int64)
            ra[:B] = [a for a, _ in ranges]
            rl[:B] = [b - a for a, b in ranges]
            idx = np.minimum(ra[:, None] + np.arange(E_c), M)   # [Bpad, E_c]
            maskj = np.arange(E_c)[None, :] < rl[:, None]
            conn_pad = np.concatenate([conn_m, np.full((1, k), -1, np.int32)])
            order_pad = np.concatenate([order, [-1]])
            conn_c = np.where(maskj[:, :, None], conn_pad[idx], -1)
            esrc = np.where(maskj, order_pad[idx], -1).astype(np.int32)
            B = Bpad

        # first-touch node numbering (cluster-major)
        with span("plan.numbering"):
            flat = conn_c.reshape(-1)
            nfo = native.first_touch(flat, n_nodes)
            if nfo is not None:
                new_from_old = nfo
                n_ref = int(new_from_old.max()) + 1
            else:
                valid = flat >= 0
                uniq, first_idx = np.unique(flat[valid], return_index=True)
                touch_order = np.argsort(first_idx, kind="stable")
                new_from_old = np.full(n_nodes, -1, np.int32)
                new_from_old[uniq[touch_order]] = np.arange(uniq.size,
                                                            dtype=np.int32)
                n_ref = uniq.size
            # unreferenced nodes go after all referenced ones (stable)
            missing = np.nonzero(new_from_old < 0)[0]
            new_from_old[missing] = n_ref + np.arange(missing.size)
            Nb = -(-n_nodes // BLK)
            Nb = -(-Nb // TILE) * TILE
            Npad = Nb * BLK
            old_from_new = np.full(Npad, -1, np.int64)
            old_from_new[new_from_old] = np.arange(n_nodes)
            gconn = np.where(conn_c >= 0,
                             new_from_old[np.maximum(conn_c, 0)], -1)

        # per-cluster slots: sorted unique new node ids
        with span("plan.slots"):
            rows = gconn.reshape(B, E_c * k)
            _slots = native.cluster_slots(rows)
            if _slots is not None:
                l2g, slot_flat, mx = _slots
                if mx > L_SLOTS:
                    raise ValueError("cluster slot overflow after splitting; "
                                     "lower elems_per_cluster")
            else:
                srt = np.sort(rows, axis=1)
                first = np.ones_like(srt, dtype=bool)
                first[:, 1:] = srt[:, 1:] != srt[:, :-1]
                first &= srt >= 0
                n_slots = first.sum(axis=1)
                if int(n_slots.max()) > L_SLOTS:
                    raise ValueError("cluster slot overflow after splitting; "
                                     "lower elems_per_cluster")
                l2g = np.full((B, L_SLOTS), -1, np.int32)
                bidx = np.broadcast_to(np.arange(B)[:, None], srt.shape)
                slot_of_sorted = np.cumsum(first, axis=1) - 1
                l2g[bidx[first], slot_of_sorted[first]] = srt[first]
                order_in_row = np.argsort(rows, axis=1, kind="stable")
                slot_flat = np.zeros_like(rows)
                slot_sorted = np.maximum(slot_of_sorted, 0)
                np.put_along_axis(slot_flat, order_in_row, slot_sorted, axis=1)
            slot_of_entry = slot_flat.reshape(B, E_c, k)        # [B, E_c, k]

            # element-lane slot table, kk-major: r = kk * E_c + e
            Rp = -(-k * E_c // 128) * 128
            lconn = np.zeros((B, Rp), np.int32)
            lconn[:, : k * E_c] = np.transpose(slot_of_entry, (0, 2, 1)
                                               ).reshape(B, k * E_c)

            # compress incidence widths per (cluster, 128-lane chunk); pad
            # element lanes are excluded, order within a slot is ascending lane
            kEc = k * E_c
            Gch = -(-kEc // 128)
            ev = esrc >= 0                              # [B, E_c]
            wid_bg = native.cinc_widths(lconn, ev, k, E_c, Gch)
            _np_inc = wid_bg is None
            if _np_inc:
                lane_valid = np.tile(ev, (1, k))        # lane r = kk*E_c + e
                vb2, vr2 = np.nonzero(lane_valid)
                sl2 = lconn[:, :kEc][vb2, vr2].astype(np.int64)
                g2 = vr2 // 128
                lp2 = (vr2 % 128).astype(np.int32)
                ckey = ((vb2 * Gch + g2) * 128 + sl2).astype(np.int64)
                cord = np.argsort(ckey, kind="stable")
                ks = ckey[cord]
                newg = np.ones(ks.size, bool)
                newg[1:] = ks[1:] != ks[:-1]
                aidx = np.arange(ks.size, dtype=np.int64)
                start = aidx[newg][np.cumsum(newg) - 1]
                vpos = aidx - start
                gs = (ks // 128) % Gch
                run_starts = aidx[newg]
                run_counts = np.diff(np.append(run_starts, ks.size))
                run_bg = ks[newg] // 128                   # (b * Gch + g)
                bg_new = np.ones(run_bg.size, bool)
                bg_new[1:] = run_bg[1:] != run_bg[:-1]
                bg_starts = np.nonzero(bg_new)[0]
                wid_bg = np.zeros((B, Gch), np.int64)
                if run_counts.size:
                    ub = run_bg[bg_starts]
                    wid_bg[ub // Gch, ub % Gch] = np.maximum.reduceat(
                        run_counts, bg_starts)
                ent_b = vb2[cord]
                ent_slot = (ks % 128).astype(np.int64)
                ent_lane = lp2[cord].astype(np.uint32)

        # node-block windows per cluster + per-slot source coordinates
        with span("plan.windows"):
            _cw = native.cluster_windows(l2g, Nb)
            if _cw is not None:
                win_full, wn_cnt32, wslot, jslot = _cw
                wn_cnt = wn_cnt32.astype(np.int64)
                Wn = max(int(wn_cnt.max()) if B else 1, 1)
                win_nodes = np.ascontiguousarray(win_full[:, :Wn])
                wslot = np.where(wslot == 128, Wn, wslot).astype(np.int32)
                wc_cnt32 = native.block_windows_count(l2g, Nb)
                assert wc_cnt32 is not None
                wc_cnt = wc_cnt32.astype(np.int64)
                Wc = max(int(wc_cnt.max()) if Nb else 1, 1)
                winc = slotidx = None   # filled packed after the bucketing
            else:
                blk = np.where(l2g >= 0, l2g // BLK, -1)
                bsort = np.sort(blk, axis=1)
                bfirst = np.ones_like(bsort, dtype=bool)
                bfirst[:, 1:] = bsort[:, 1:] != bsort[:, :-1]
                bfirst &= bsort >= 0
                wn_cnt = bfirst.sum(axis=1).astype(np.int64)
                Wn = int(wn_cnt.max()) if B else 1
                Wn = max(Wn, 1)
                win_nodes = np.full((B, Wn), Nb, np.int32)  # pad -> zero row
                bidx2 = np.broadcast_to(np.arange(B)[:, None], bsort.shape)
                pair_b = bidx2[bfirst]
                pair_blk = bsort[bfirst]
                pos_in_b = (np.cumsum(bfirst, axis=1) - 1)[bfirst]
                win_nodes[pair_b, pos_in_b] = pair_blk
                wslot = np.full((B, L_SLOTS), Wn, np.int32)
                jslot = np.zeros((B, L_SLOTS), np.int32)
                vb, vs = np.nonzero(l2g >= 0)
                g = l2g[vb, vs]
                win_flat = (win_nodes
                            + np.arange(B, dtype=np.int64)[:, None] * (Nb + 2)
                            ).ravel()
                w = (np.searchsorted(win_flat,
                                     vb * np.int64(Nb + 2) + g // BLK)
                     - vb * Wn)
                wslot[vb, vs] = w
                jslot[vb, vs] = g % BLK

                # cluster windows per node block + slot index of each node
                jblk = g // BLK
                key_all = jblk * np.int64(B + 1) + vb
                nat = (native.unique_inverse_i64(key_all) if key_all.size
                       else None)
                if nat is not None:
                    key, w_of_pair = nat
                else:
                    key, w_of_pair = np.unique(key_all, return_inverse=True)
                up_blk = (key // (B + 1)).astype(np.int64)
                up_cl = (key % (B + 1)).astype(np.int64)
                wc_cnt = np.bincount(up_blk, minlength=Nb).astype(np.int64)
                Wc = int(wc_cnt.max()) if key.size else 1
                Wc = max(Wc, 1)
                winc = np.full((Nb, Wc), B, np.int32)       # pad -> zero row
                srt_blocks, blk_starts = np.unique(up_blk, return_index=True)
                pos = np.arange(key.size) - blk_starts[
                    np.searchsorted(srt_blocks, up_blk)]
                winc[up_blk, pos] = up_cl
                slotidx = np.full((Nb, Wc, BLK), -1, np.int32)
                slotidx[jblk, pos[w_of_pair], g % BLK] = vs

        # window bucketing: clusters sorted by node-window count, blocks by
        # cluster-window count (stable); the block permutation goes into
        # the node numbering, the cluster permutation into the tables
        with span("plan.buckets"):
            if window_buckets == 0:
                cperm = np.arange(B)
                bperm = np.arange(Nb)
                c_groups = ((0, B, int(wn_cnt.max()) if B else 0),)
                b_groups = ((0, Nb, int(wc_cnt.max()) if Nb else 0),)
            else:
                cperm = np.argsort(wn_cnt, kind="stable")
                bperm = np.argsort(wc_cnt, kind="stable")
                c_groups = _bucket_groups(wn_cnt[cperm], window_buckets)
                b_groups = _bucket_groups(wc_cnt[bperm], window_buckets)
            cpos = np.empty(B, np.int64)
            cpos[cperm] = np.arange(B)
            bpos = np.empty(Nb, np.int64)
            bpos[bperm] = np.arange(Nb)
            new_from_old = bpos[new_from_old // BLK] * BLK + new_from_old % BLK
            old_from_new = old_from_new.reshape(Nb, BLK)[bperm].reshape(-1)
            win_nodes = np.where(win_nodes < Nb,
                                 bpos[np.minimum(win_nodes, Nb - 1)], Nb)
            if winc is None:
                winc, slotidx = native.block_windows_fill_packed(
                    l2g, Nb, Wc, bpos, cpos)
            else:
                winc = winc[bperm]
                # byte-pack slotidx 4 windows per int32 word (value =
                # slot + 1), in row chunks to bound the transient
                Wcp4 = max(-(-Wc // 4), 1)
                packed_si = np.empty((Nb, Wcp4, BLK), np.int32)
                CH = 1 << 13
                sv = np.zeros((min(CH, Nb), Wcp4 * 4, BLK), np.uint32)
                for r0 in range(0, Nb, CH):
                    r1 = min(r0 + CH, Nb)
                    svc = sv[:r1 - r0]
                    svc[:, Wc:] = 0
                    svc[:, :Wc] = (slotidx[bperm[r0:r1]].astype(np.int64) + 1
                                   ).astype(np.uint32)
                    packed_si[r0:r1] = (svc[:, 0::4] | (svc[:, 1::4] << 8)
                                        | (svc[:, 2::4] << 16)
                                        | (svc[:, 3::4] << 24)).view(np.int32)
                slotidx = packed_si
                winc = np.where(winc < B, cpos[np.minimum(winc, B - 1)], B)
            win_nodes = win_nodes[cperm]
            wslot = wslot[cperm]
            jslot = jslot[cperm]
            lconn = lconn[cperm]
            esrc = esrc[cperm]

        # per-bucket compress incidence tables, byte-packed 4 per int32
        with span("plan.tables"):
            if _np_inc:
                grp_of = np.zeros(B, np.int64)
                for gi, (s, ng, _) in enumerate(c_groups):
                    grp_of[cperm[s:s + ng]] = gi
                ent_grp = grp_of[ent_b]
            ev_perm = esrc >= 0
            cv_widths = []
            cinc_groups = []
            for gi, (s, ng, _) in enumerate(c_groups):
                wid_g = (wid_bg[cperm[s:s + ng]].astype(np.int64).max(axis=0)
                         if ng else np.zeros(Gch, np.int64))
                cv_widths.append(tuple(int(x) for x in wid_g))
                voff_g = np.zeros(Gch, np.int64)
                voff_g[1:] = np.cumsum(wid_g)[:-1]
                Wp = max(-(-int(wid_g.sum()) // 4), 1)
                if not _np_inc:
                    packed = native.cinc_fill_packed(
                        lconn, ev_perm, np.arange(s, s + ng), k, E_c, Gch,
                        voff_g, Wp)
                    assert packed is not None
                else:
                    vals = np.zeros((ng, Wp * 4, 128), np.uint32)
                    me = ent_grp == gi
                    vals[cpos[ent_b[me]] - s, voff_g[gs[me]] + vpos[me],
                         ent_slot[me]] = ent_lane[me] + 1
                    packed = np.ascontiguousarray(
                        vals[:, 0::4] | (vals[:, 1::4] << 8)
                        | (vals[:, 2::4] << 16)
                        | (vals[:, 3::4] << 24)).view(np.int32)
                cinc_groups.append(packed)

            meta = PackedMeta(n_nodes, Nb, B, E_c, k, Rp, Wn, Wc,
                              c_groups, b_groups, tuple(cv_widths))
            arrays = dict(win_nodes=win_nodes, wslot=wslot, jslot=jslot,
                          lconn=lconn, winc=winc, slotidx=slotidx,
                          new_from_old=new_from_old, old_from_new=old_from_new,
                          esrc=esrc.reshape(-1))
            for i, c in enumerate(cinc_groups):
                arrays[f"cinc_{i}"] = c
        with span("plan.to_device"):
            return PackedPlan.from_arrays(arrays, PackedPlan._meta_dict(meta),
                                          dev)

    # -- disk cache (tpufem's format: .npy tables + meta.json, version 1) ---
    _SAVE_VERSION = 1

    @staticmethod
    def _meta_dict(m: PackedMeta) -> dict:
        return dict(n_nodes=m.n_nodes, n_blocks=m.n_blocks,
                    n_clusters=m.n_clusters,
                    elems_per_cluster=m.elems_per_cluster,
                    nodes_per_elem=m.nodes_per_elem, lanes=m.lanes,
                    win_n=m.win_n, win_c=m.win_c,
                    c_groups=[list(g) for g in m.c_groups],
                    b_groups=[list(g) for g in m.b_groups],
                    cv_widths=[list(w) for w in m.cv_widths])

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        arrays = {n: getattr(self, n) for n in _TABLES}
        for i, c in enumerate(self.cinc):
            arrays[f"cinc_{i}"] = c
        for name, a in arrays.items():
            np.save(os.path.join(path, name + ".npy"), a.cpu().numpy())
        meta = dict(version=self._SAVE_VERSION, n_cinc=len(self.cinc),
                    **self._meta_dict(self.meta))
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load(path: str, device=None) -> "PackedPlan":
        with open(os.path.join(path, "meta.json")) as f:
            md = json.load(f)
        if md.get("version") != PackedPlan._SAVE_VERSION:
            raise ValueError(f"unsupported plan cache version: {md}")
        names = list(_TABLES) + [f"cinc_{i}" for i in range(md["n_cinc"])]
        arrays = {n: np.load(os.path.join(path, n + ".npy")) for n in names}
        return PackedPlan.from_arrays(arrays, md, device)

    # -- packing helpers -----------------------------------------------------
    def pack(self, u: torch.Tensor) -> torch.Tensor:
        """u [N, 3] -> X [Nb, 384] (pad nodes zero)."""
        m = self.meta
        ofn = self.old_from_new.long()
        vals = torch.where((ofn >= 0)[:, None], u[ofn.clamp(min=0)], 0.0)
        X = vals.reshape(m.n_blocks, BLK, 3)
        return X.transpose(1, 2).reshape(m.n_blocks, ROW)

    def unpack(self, X: torch.Tensor) -> torch.Tensor:
        """X [Nb, 384] -> u [N, 3]."""
        m = self.meta
        u = X.reshape(m.n_blocks, 3, BLK).transpose(1, 2)
        return u.reshape(m.n_blocks * BLK, 3)[self.new_from_old.long()]

    def pack_np(self, u: np.ndarray) -> np.ndarray:
        m = self.meta
        out = np.zeros((m.n_blocks * BLK, 3), u.dtype)
        out[self.new_from_old.cpu().numpy()] = u
        out = out.reshape(m.n_blocks, BLK, 3).transpose(0, 2, 1)
        return np.ascontiguousarray(out).reshape(m.n_blocks, ROW)

    def pack_flat(self, uf: torch.Tensor, dtype=None) -> torch.Tensor:
        """Flat [N*3] field -> X [Nb, 384] without an [N, 3] intermediate."""
        m = self.meta
        ofn = self.old_from_new.long()
        src = ofn.clamp(min=0)
        valid = ofn >= 0
        dtype = dtype or uf.dtype
        cols = [torch.where(valid, uf[src * 3 + c], 0.0).to(dtype)
                .reshape(m.n_blocks, BLK) for c in range(3)]
        return torch.cat(cols, dim=1)                    # lanes c*128+j

    def unpack_flat(self, X: torch.Tensor, dtype=None) -> torch.Tensor:
        """X [Nb, 384] -> flat [N*3]."""
        dtype = dtype or X.dtype
        new = self.new_from_old.long()
        rows, lane = new // BLK, new % BLK
        Xf = X.reshape(-1)
        cols = [Xf[rows * ROW + c * BLK + lane].to(dtype) for c in range(3)]
        return torch.stack(cols, dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# planar partial-assembly compute (plain PyTorch element math)
# ---------------------------------------------------------------------------

def pa_apply_planar(ue3, Jinv, W, dN, lam, mu):
    """Partial-assembly action on planes: ue3 [3, k, B, E_c], Jinv
    [qJ, 9, B, E_c], W [q, B, E_c] -> [3, k, B, E_c] element forces.
    The arithmetic and order of fused_kernels._pa_planes."""
    dN = np.asarray(dN)
    q, k, _ = dN.shape
    qJ = Jinv.shape[0]
    Fe = fk._pa_planes(
        [[ue3[c, kk] for kk in range(k)] for c in range(3)],
        [[[Jinv[qj, 3 * i + j] for j in range(3)] for i in range(3)]
         for qj in range(qJ)],
        [W[qi] for qi in range(q)], dN, lam, mu)
    zero = torch.zeros_like(W[0])
    return torch.stack([
        torch.stack([Fe[c][kk] if Fe[c][kk] is not None else zero
                     for kk in range(k)]) for c in range(3)])


def pa_diag_planar(Jinv, W, dN, lam, mu):
    """Assembled-diagonal contributions [3, k, B, E_c]: per quadrature
    point and node, W ((lam + mu) g_a^2 + mu |g|^2) with g = J^-T dNhat."""
    dN = np.asarray(dN)
    q, k, _ = dN.shape
    qJ = Jinv.shape[0]
    out = [[None] * k for _ in range(3)]
    for qi in range(q):
        Wq = W[qi]
        for kk in range(k):
            gvec = [sum(float(dN[qi, kk, j]) * Jinv[min(qi, qJ - 1), 3 * i + j]
                        for j in range(3)) for i in range(3)]
            norm2 = gvec[0] * gvec[0] + gvec[1] * gvec[1] + gvec[2] * gvec[2]
            for a in range(3):
                term = Wq * ((lam + mu) * gvec[a] * gvec[a] + mu * norm2)
                prev = out[a][kk]
                out[a][kk] = term if prev is None else prev + term
    return torch.stack([torch.stack(out[a]) for a in range(3)])


def pa_blockdiag_planar(Jinv, W, dN, lam, mu):
    """Assembled node-block 3x3 diagonal contributions: per quadrature
    point and element node with g = J^-T dNhat, the (k, k) block of the
    element stiffness is W ((lam + mu) g g^T + mu |g|^2 I).  Returns
    (diag [3, k, B, E_c] for components (00, 11, 22), off [3, k, B, E_c]
    for (01, 02, 12)), in tpufem's operation order."""
    dN = np.asarray(dN)
    q, k, _ = dN.shape
    qJ = Jinv.shape[0]
    diag = [[None] * k for _ in range(3)]
    off = [[None] * k for _ in range(3)]
    pairs = ((0, 1), (0, 2), (1, 2))
    for qi in range(q):
        Wq = W[qi]
        for kk in range(k):
            gvec = [sum(float(dN[qi, kk, j]) * Jinv[min(qi, qJ - 1), 3 * i + j]
                        for j in range(3)) for i in range(3)]
            norm2 = gvec[0] * gvec[0] + gvec[1] * gvec[1] + gvec[2] * gvec[2]
            for a in range(3):
                term = Wq * ((lam + mu) * gvec[a] * gvec[a] + mu * norm2)
                prev = diag[a][kk]
                diag[a][kk] = term if prev is None else prev + term
            for idx, (a, c) in enumerate(pairs):
                term = Wq * ((lam + mu) * gvec[a] * gvec[c])
                prev = off[idx][kk]
                off[idx][kk] = term if prev is None else prev + term
    return (torch.stack([torch.stack(r) for r in diag]),
            torch.stack([torch.stack(r) for r in off]))


def lanes_to_planar(ue: torch.Tensor, k: int, E_c: int) -> torch.Tensor:
    """[B, 3, Rp] -> contiguous [3, k, B, E_c] (lanes r = kk * E_c + e)."""
    B = ue.shape[0]
    return ue[:, :, :k * E_c].reshape(B, 3, k, E_c).permute(
        1, 2, 0, 3).contiguous()


def planar_to_lanes(fe3: torch.Tensor, Rp: int) -> torch.Tensor:
    """[3, k, B, E_c] -> contiguous [B, 3, Rp] (pad lanes zero)."""
    _, k, B, E_c = fe3.shape
    Fe = fe3.new_zeros((B, 3, Rp))
    Fe[:, :, :k * E_c] = fe3.permute(2, 0, 1, 3).reshape(B, 3, k * E_c)
    return Fe


# ---------------------------------------------------------------------------
# operator
# ---------------------------------------------------------------------------

FUSE_MODES = ("", "dense", "narrow")


def fuse_mode(fuse: Optional[str], E_c: int, k: int, q: int,
              device: torch.device) -> str:
    """The mode an operator runs.  fuse=None: "dense" when E_c divides 128
    and fused_yc is instantiated for (k, q) (fused_kernels.KERNEL_KQ),
    else "" (staged: expand, the element math, compress_gather), on every
    device, so that the CPU runs the mode the card runs.  An explicit
    "dense" or "narrow" needs E_c to divide 128 and, on a CUDA device,
    (k, q) in KERNEL_KQ."""
    if fuse is None:
        return "dense" if BLK % E_c == 0 and (k, q) in fk.KERNEL_KQ else ""
    if fuse not in FUSE_MODES:
        raise ValueError(f"fuse must be one of {FUSE_MODES}, got {fuse!r}")
    if fuse and BLK % E_c:
        raise ValueError(f"fuse={fuse!r} needs elems_per_cluster to "
                         f"divide 128 (got {E_c}); use fuse=''")
    if fuse and device.type == "cuda" and (k, q) not in fk.KERNEL_KQ:
        raise ValueError(f"fuse={fuse!r}: fused_yc is built for (k, q) in "
                         f"KERNEL_KQ = {fk.KERNEL_KQ}, got ({k}, {q}); use "
                         f"fuse=''")
    return fuse


def _as_float(g, dtype, dev) -> torch.Tensor:
    if not torch.is_tensor(g):     # a copy: another package's array may
        g = np.array(g)              # be read-only
    return torch.as_tensor(g, dtype=dtype, device=dev)


class PackedPartialOperator(torch.nn.Module):
    """X [Nb, 384] -> F [Nb, 384]; geometry-factor element compute.

    Buffers: the plan tables and the geometry J^-1 and W (w * detJ, zero on
    pad elements) in the layout of the mode (tpufem's): cluster-major
    [B, qJ*9, E_c] / [B, q, E_c] for the fused modes ("dense", "narrow":
    kernel fused_yc), planar [qJ, 9, B, E_c] / [q, B, E_c] for the staged
    mode ("": kernels expand and compress_gather around the planar element
    math).  "dense" and "narrow" are two TPU layouts of one function; both
    run fused_yc here."""

    def __init__(self, plan: PackedPlan, Jinv: torch.Tensor, W: torch.Tensor,
                 dN: np.ndarray, lam: float, mu: float,
                 fuse: Optional[str] = None):
        """fuse=None: "dense" for cluster-major (3-D) geometry where
        fuse_mode's rule allows it, else "" (cluster-major geometry is
        then taken to the planar layout)."""
        super().__init__()
        q, k, _ = np.shape(dN)
        E_c = plan.meta.elems_per_cluster
        if fuse is None and Jinv.dim() == 3:
            fuse = fuse_mode(None, E_c, k, q, Jinv.device)
            if not fuse:
                B = plan.meta.n_clusters
                Jinv = Jinv.reshape(B, -1, 9, E_c).permute(1, 2, 0, 3)
                Jinv, W = Jinv.contiguous(), W.permute(1, 0, 2).contiguous()
        fuse = fuse_mode("" if fuse is None else fuse, E_c, k, q,
                         Jinv.device)
        if Jinv.dim() != (3 if fuse else 4):
            raise ValueError(f"fuse={fuse!r} stores Jinv "
                             f"{'[B, qJ*9, E_c]' if fuse else '[qJ, 9, B, E_c]'}"
                             f", got {tuple(Jinv.shape)}")
        self.plan = plan
        self.fuse = fuse
        self.register_buffer("Jinv", Jinv)
        self.register_buffer("W", W)
        self.dN = np.asarray(dN, np.float64)          # host [q, k, 3]
        self.lam_mu = (float(lam), float(mu))
        if fuse and Jinv.device.type == "cuda":
            count("fused_yc.warps_per_sm",
                  fk.warps_per_sm(Jinv.dtype, k, q, plan))

    @staticmethod
    def build(coords, conn, etype: str, E: float, nu: float,
              n_nodes: Optional[int] = None, rule: str = "default",
              plan: Optional[PackedPlan] = None, affine: Optional[bool] = None,
              dtype=torch.float32, elems_per_cluster: int = 32,
              window_buckets: int = 8, fuse: Optional[str] = None,
              geometry: Optional[Tuple] = None,
              device=None) -> "PackedPartialOperator":
        """fuse: None picks fuse_mode's rule, "dense" when
        elems_per_cluster divides 128 and fused_yc is built for the
        element's (k, q), else "" (staged); "dense"/"narrow" need it to
        divide 128 (and, on the card, the (k, q)).  geometry: optional
        (Jinv, W) taken from an operator of either layout (tpufem's or
        the port's, arrays or tensors): cluster-major
        [B, qJ*9, E_c] / [B, q, E_c] or planar [qJ, 9, B, E_c] /
        [q, B, E_c]; skips the geometry pass."""
        from ..core.materials import lame_parameters
        from ..elements.tables import element_table
        from .partial import chunked_geometry

        dev = resolve_device(device)
        conn = np.asarray(conn)
        if n_nodes is None and plan is None:
            raise ValueError("pass n_nodes or a prebuilt plan")
        if plan is None:
            plan = PackedPlan.build(np.asarray(coords), conn, int(n_nodes),
                                    elems_per_cluster,
                                    window_buckets=window_buckets,
                                    device=dev)
        plan = plan.to(dev)
        m = plan.meta
        table = element_table(etype, rule)
        B, E_c = m.n_clusters, m.elems_per_cluster
        q, k, _ = table.dN.shape
        fuse = fuse_mode(fuse, E_c, k, q, dev)
        if geometry is not None:
            Jg, Wg = (_as_float(g, dtype, dev) for g in geometry)
            if (Jg.dim() == 3 and Wg.dim() == 3 and Jg.shape[0] == B
                    and Jg.shape[1] % 9 == 0 and Jg.shape[2] == E_c
                    and Wg.shape[0] == B and Wg.shape[2] == E_c):
                Jpl = Jg.reshape(B, Jg.shape[1] // 9, 9, E_c).permute(
                    1, 2, 0, 3)
                Wpl = Wg.permute(1, 0, 2)
            elif (Jg.dim() == 4 and Wg.dim() == 3 and Jg.shape[1] == 9
                  and Jg.shape[2:] == (B, E_c) and Wg.shape[1:] == (B, E_c)):
                Jpl, Wpl = Jg, Wg
            else:
                raise ValueError(f"geometry layout mismatch: Jinv "
                                 f"{tuple(Jg.shape)}, W {tuple(Wg.shape)}, "
                                 f"B={B}, E_c={E_c}")
        else:
            esrc = plan.esrc.long()
            valid = esrc >= 0
            conn_sel = torch.as_tensor(conn, device=dev)[esrc.clamp(min=0)]
            Jinv, W, affine_meas = chunked_geometry(
                torch.as_tensor(np.asarray(coords), device=dev), conn_sel,
                table, dtype)
            W = W * valid.to(dtype)[:, None]             # zero pad elements
            if affine is None:
                affine = affine_meas
            if affine:
                Jinv = Jinv[:, :1]
            qJ = Jinv.shape[1]
            q = W.shape[1]
            Jpl = Jinv.reshape(B, E_c, qJ, 9).permute(2, 3, 0, 1)
            Wpl = W.reshape(B, E_c, q).permute(2, 0, 1)
        if fuse:
            qJ = Jpl.shape[0]
            Jp = Jpl.permute(2, 0, 1, 3).reshape(B, qJ * 9, E_c).contiguous()
            Wp = Wpl.permute(1, 0, 2).contiguous()
        else:
            Jp, Wp = Jpl.contiguous(), Wpl.contiguous()
        lam, mu = lame_parameters(E, nu)
        return PackedPartialOperator(plan, Jp, Wp, table.dN, lam, mu, fuse)

    def _planar_geom(self):
        """(Jinv [qJ, 9, B, E_c], W [q, B, E_c]): the staged mode's own
        buffers, views of the fused modes' (the diagonals and the staged
        element math read this layout)."""
        if not self.fuse:
            return self.Jinv, self.W
        m = self.plan.meta
        B, E_c = m.n_clusters, m.elems_per_cluster
        qJ = self.Jinv.shape[1] // 9
        Jp = self.Jinv.reshape(B, qJ, 9, E_c).permute(1, 2, 0, 3)
        return Jp, self.W.permute(1, 0, 2)

    def cluster_geometry(self):
        """(Jinv [B, qJ*9, E_c], W [B, q, E_c]), contiguous: the fused
        modes' own buffers, a copy of the staged mode's."""
        if self.fuse:
            return self.Jinv, self.W
        qJ, _, B, E_c = self.Jinv.shape
        return (self.Jinv.permute(2, 0, 1, 3).reshape(B, qJ * 9, E_c)
                .contiguous(), self.W.permute(1, 0, 2).contiguous())

    # Each cluster stage loops over its buckets and calls its kernel(s)
    # once per bucket; the combine stage calls its kernel once for all
    # rows.  The kernel is the wrapper by default; the kernel's plain
    # version has the same signature, so a caller can run a stage through
    # it for comparison.

    def fused_stage(self, X: torch.Tensor, kernel=fk.fused_yc,
                    geometry=None) -> torch.Tensor:
        """X [Nb, 384] -> cluster slot sums Yc [B, 384] through fused_yc
        (per cluster bucket).  geometry: cluster-major (Jinv, W), default
        cluster_geometry()."""
        p = self.plan
        m = p.meta
        lam, mu = self.lam_mu
        jinv, w = geometry if geometry is not None else self.cluster_geometry()
        Yc = torch.empty((m.n_clusters, ROW), dtype=X.dtype, device=X.device)
        for gi, (s, n, wk) in enumerate(m.c_groups):
            if wk == 0 or n == 0:      # pad-only clusters -> zero slot sums
                Yc[s:s + n].zero_()
                continue
            sl = slice(s, s + n)
            kernel(X, p.win_nodes[sl], p.wslot[sl], p.jslot[sl], p.lconn[sl],
                   p.cinc[gi], jinv[sl], w[sl], self.dN, lam, mu,
                   m.cv_widths[gi], wk=wk, out=Yc[sl])
        return Yc

    def expand_stage(self, X: torch.Tensor, kernel=pk.expand
                     ) -> torch.Tensor:
        """X [Nb, 384] -> element-lane values ue [B, 3, Rp] (per cluster
        bucket; pad-only buckets zero)."""
        p = self.plan
        m = p.meta
        ue = torch.empty((m.n_clusters, 3, m.lanes), dtype=X.dtype,
                         device=X.device)
        for (s, n, wk) in m.c_groups:
            if wk == 0 or n == 0:
                ue[s:s + n].zero_()
                continue
            sl = slice(s, s + n)
            kernel(X, p.win_nodes[sl], p.wslot[sl], p.jslot[sl], p.lconn[sl],
                   wk=wk, out=ue[sl])
        return ue

    def element_forces(self, ue3: torch.Tensor) -> torch.Tensor:
        """Planar element values [3, k, B, E_c] -> element forces (the
        partial-assembly action, plain PyTorch, all clusters at once)."""
        Jp, Wp = self._planar_geom()
        return pa_apply_planar(ue3, Jp, Wp, self.dN, *self.lam_mu)

    def staged_stage(self, X: torch.Tensor, expand=pk.expand,
                     compress=pk.compress_gather) -> torch.Tensor:
        """X [Nb, 384] -> Yc [B, 384], tpufem's staged pipeline: expand
        (per bucket) -> lanes_to_planar -> the element math once over all
        clusters (elementwise, so the same as per bucket) ->
        planar_to_lanes -> compress_gather (per bucket).  tpufem's
        row chunking only bounds its materialized Xw and does not change
        any per-cluster sum, so there is none here."""
        m = self.plan.meta
        ue3 = lanes_to_planar(self.expand_stage(X, expand),
                              m.nodes_per_elem, m.elems_per_cluster)
        fe3 = self.element_forces(ue3)
        return self.compress_stage(planar_to_lanes(fe3, m.lanes), compress)

    def combine_stage(self, Yc: torch.Tensor, kernel=pk.combine
                      ) -> torch.Tensor:
        """Slot sums [B, 384] -> node rows [Nb, 384]: one call over all
        block buckets, each row at its own width (PackedPlan.row_wk; rows
        of width 0, which no cluster writes, are zero)."""
        p = self.plan
        return kernel(Yc, p.winc, p.slotidx, p.row_wk)

    def compress_stage(self, Fe: torch.Tensor, kernel=pk.compress_gather
                       ) -> torch.Tensor:
        """Element-lane values Fe [B, 3, Rp] -> slot sums Yc [B, 384] (per
        cluster bucket)."""
        p = self.plan
        m = p.meta
        Yc = torch.empty((m.n_clusters, ROW), dtype=Fe.dtype,
                         device=Fe.device)
        for gi, (s, n, wk) in enumerate(m.c_groups):
            if wk == 0 or n == 0:
                Yc[s:s + n].zero_()
                continue
            kernel(Fe[s:s + n], p.cinc[gi], m.cv_widths[gi], out=Yc[s:s + n])
        return Yc

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        Yc = self.fused_stage(X) if self.fuse else self.staged_stage(X)
        return self.combine_stage(Yc)

    def diagonal(self, compress=pk.compress_gather, combine=pk.combine
                 ) -> torch.Tensor:
        """Assembled diagonal as a packed field [Nb, 384]."""
        Jp, Wp = self._planar_geom()
        d3 = pa_diag_planar(Jp, Wp, self.dN, *self.lam_mu)  # [3, k, B, E_c]
        return self.combine_stage(self.compress_stage(
            planar_to_lanes(d3, self.plan.meta.lanes), compress), combine)

    def block_diagonal(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assembled 3x3 node-block diagonal as two packed fields
        ([Nb, 384] each): diagonal components (00, 11, 22) and off-diagonal
        components (01, 02, 12).  compress_gather twice per cluster bucket,
        then combine twice."""
        Jp, Wp = self._planar_geom()
        Rp = self.plan.meta.lanes
        d3, o3 = pa_blockdiag_planar(Jp, Wp, self.dN, *self.lam_mu)
        Ycs = [self.compress_stage(planar_to_lanes(f3, Rp))
               for f3 in (d3, o3)]
        return self.combine_stage(Ycs[0]), self.combine_stage(Ycs[1])


# ---------------------------------------------------------------------------
# block-Jacobi preconditioner (3x3 node blocks, packed layout)
# ---------------------------------------------------------------------------

def invert_block_planes(D: torch.Tensor, O: torch.Tensor, mask=None):
    """Packed 3x3 node-block planes -> inverse planes.

    D [*, 384] holds (d00, d11, d22), O holds (d01, d02, d12).  Closed-form
    symmetric adjugate/det inverse per node; singular blocks fall back to
    the scalar-Jacobi diagonal.  With `mask` (0/1 packed field), masked
    DOFs are decoupled before inversion (row/col dropped) and the inverse
    rows are zeroed after.  Returns (inv_d, inv_o) in the same layout, in
    tpufem's operation order."""
    a, b, c = D[..., :BLK], D[..., BLK:2 * BLK], D[..., 2 * BLK:]
    d, e, f = O[..., :BLK], O[..., BLK:2 * BLK], O[..., 2 * BLK:]
    if mask is not None:
        m0, m1, m2 = (mask[..., :BLK], mask[..., BLK:2 * BLK],
                      mask[..., 2 * BLK:])
        d = d * m0 * m1
        e = e * m0 * m2
        f = f * m1 * m2
    cof00 = b * c - f * f
    cof01 = e * f - d * c
    cof02 = d * f - b * e
    det = a * cof00 + d * cof01 + e * cof02
    safe = torch.isfinite(det) & (torch.abs(det) > 0)
    inv_det = torch.where(safe, 1.0 / torch.where(safe, det, 1.0), 0.0)

    def scal(x):         # scalar-Jacobi fallback for singular blocks
        return torch.where(torch.abs(x) > 0,
                           1.0 / torch.where(x == 0, 1.0, x), 0.0)

    i00 = torch.where(safe, cof00 * inv_det, scal(a))
    i11 = torch.where(safe, (a * c - e * e) * inv_det, scal(b))
    i22 = torch.where(safe, (a * b - d * d) * inv_det, scal(c))
    i01 = torch.where(safe, cof01 * inv_det, 0.0)
    i02 = torch.where(safe, cof02 * inv_det, 0.0)
    i12 = torch.where(safe, (d * e - a * f) * inv_det, 0.0)
    inv_d = torch.cat([i00, i11, i22], dim=-1)
    inv_o = torch.cat([i01, i02, i12], dim=-1)
    if mask is not None:
        inv_d = inv_d * mask
        inv_o = inv_o * mask
    return inv_d, inv_o


def block_apply(inv_d: torch.Tensor, inv_o: torch.Tensor, r: torch.Tensor
                ) -> torch.Tensor:
    """z = B^-1 r per node on packed planes."""
    r0, r1, r2 = r[..., :BLK], r[..., BLK:2 * BLK], r[..., 2 * BLK:]
    i00, i11, i22 = (inv_d[..., :BLK], inv_d[..., BLK:2 * BLK],
                     inv_d[..., 2 * BLK:])
    i01, i02, i12 = (inv_o[..., :BLK], inv_o[..., BLK:2 * BLK],
                     inv_o[..., 2 * BLK:])
    z0 = i00 * r0 + i01 * r1 + i02 * r2
    z1 = i01 * r0 + i11 * r1 + i12 * r2
    z2 = i02 * r0 + i12 * r1 + i22 * r2
    return torch.cat([z0, z1, z2], dim=-1)


class BlockJacobi:
    """z = B_n^-1 r_n per node: exact 3x3 node-block Jacobi, a callable
    M_inv for solvers.cg.  inv_d [Nb, 384] holds (i00, i11, i22), inv_o
    (i01, i02, i12)."""

    def __init__(self, inv_d: torch.Tensor, inv_o: torch.Tensor):
        self.inv_d = inv_d
        self.inv_o = inv_o

    @staticmethod
    def build(op: PackedPartialOperator, mask=None) -> "BlockJacobi":
        """mask: optional packed [Nb, 384] 0/1 field (fixed DOFs zero),
        decoupled before the inversion."""
        D, O = op.block_diagonal()
        return BlockJacobi(*invert_block_planes(D, O, mask))

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return block_apply(self.inv_d, self.inv_o, r)


# ---------------------------------------------------------------------------
# constraints in the packed layout (SPC values / RBE2 / RBE3)
# ---------------------------------------------------------------------------

class PackedConstraints:
    """SPC / RBE2 / RBE3 enforcement on packed [Nb, 384] fields (tpufem's
    PackedConstraints): a 0/1 mask (padding lanes are constrained by
    construction), the SPC values as a packed field, and the RBE2/RBE3
    tables of a solvers.constraints.Constraints with every DOF translated
    to its packed flat position (row * 384 + c * 128 + node % 128 after
    the plan's renumbering, c the component within the plane).  A plane
    carries the three DOFs [comp, comp + 3) of each node: the translations
    (comp 0) or, in the mixed solid + shell system, the rotations (comp
    3); the rows of the other DOFs are dropped (RBE2/RBE3 couple
    component-wise).  RBE3's segment sum is a padded table summed along
    its rows, a fixed order (solvers.constraints.rbe3_average)."""

    def __init__(self, mask: torch.Tensor):
        self.mask = mask
        # set by build where present: the SPC values (when one is nonzero),
        # the RBE2 pairs, the RBE3 tables (rbe3_slave and rbe3_weights end
        # in one pad entry, DOF 0 with weight 0, that rbe3_table's pad reads)
        self.spc_const = None
        self.rbe2_slave = self.rbe2_master = None
        self.rbe3_slave = self.rbe3_weights = self.rbe3_table = None
        self.rbe3_master = self.rbe3_wsum = None

    @property
    def has_sets(self) -> bool:
        return self.rbe2_slave is not None or self.rbe3_master is not None

    @property
    def free_mask(self) -> torch.Tensor:
        """Flat [Nb * 384] 1.0/0.0 free-DOF mask (the modal solver's
        interface; padding lanes are constrained)."""
        return self.mask.reshape(-1)

    @staticmethod
    def build(cons, plan: PackedPlan, dtype=torch.float32, comp: int = 0
              ) -> "PackedConstraints":
        """From a solvers.constraints.Constraints (3- or 6-DOF tables);
        comp (0 or 3) picks the plane's DOF window [comp, comp + 3)."""
        from ..solvers.constraints import rbe3_table
        nd = cons.dof_per_node
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        new_from_old = plan.new_from_old.cpu().numpy().astype(np.int64)
        dev = plan.device

        def pidx(dofs):
            dofs = np.asarray(dofs, np.int64)
            node, d = dofs // nd, dofs % nd - comp
            nn = new_from_old[node]
            return (nn // BLK) * ROW + d * BLK + nn % BLK

        def keep(dofs):
            d = np.asarray(dofs, np.int64) % nd
            return (d >= comp) & (d < comp + 3)

        def t(a, dt=torch.long):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dt)

        mask_n = np.asarray(cons.mask2d)[:, comp:comp + 3].astype(npdt)
        spc_n = np.asarray(cons.spc_const2d)[:, comp:comp + 3].astype(npdt)
        out = PackedConstraints(t(plan.pack_np(mask_n), dtype))
        if np.any(spc_n):
            out.spc_const = t(plan.pack_np(spc_n), dtype)
        r2s = np.asarray(cons.rbe2_slave_dofs, np.int64)
        k2 = keep(r2s)
        if k2.any():
            out.rbe2_slave = t(pidx(r2s[k2]))
            out.rbe2_master = t(pidx(np.asarray(cons.rbe2_master_dofs)[k2]))
        # the other plane's RBE3 rows are dropped entirely; the constraint
        # ids are renumbered over this plane's masters
        r3m = np.asarray(cons.rbe3_master_dofs, np.int64)
        km = keep(r3m)
        if km.any():
            cid_map = -np.ones(r3m.size, np.int64)
            cid_map[np.nonzero(km)[0]] = np.arange(int(km.sum()))
            r3s = np.asarray(cons.rbe3_slave_dofs, np.int64)
            cid = cid_map[np.asarray(cons.rbe3_cid, np.int64)]
            sel = keep(r3s) & (cid >= 0)
            out.rbe3_slave = t(np.append(pidx(r3s[sel]), 0))
            out.rbe3_weights = t(np.append(
                np.asarray(cons.rbe3_weights)[sel].astype(npdt), 0.0), dtype)
            out.rbe3_table = t(rbe3_table(cid[sel], int(km.sum())))
            out.rbe3_master = t(pidx(r3m[km]))
            out.rbe3_wsum = t(np.asarray(cons.rbe3_weight_sums)[km]
                              .astype(npdt), dtype)
        return out

    @staticmethod
    def fixed(plan: PackedPlan, fixed_nodes, dtype=torch.float32
              ) -> "PackedConstraints":
        from ..solvers.constraints import Constraints
        npdt = torch.empty((), dtype=dtype).numpy().dtype
        cons = Constraints.fixed(plan.meta.n_nodes, fixed_nodes, 3,
                                 dtype=npdt)
        return PackedConstraints.build(cons, plan, dtype)

    def apply_state(self, X: torch.Tensor) -> torch.Tensor:
        from ..solvers.constraints import rbe3_average
        out = X * self.mask.to(X.dtype)
        if self.spc_const is not None:
            out = out + self.spc_const.to(X.dtype)
        if self.has_sets:
            xf = out.reshape(-1)
            if self.rbe2_slave is not None:
                xf[self.rbe2_slave] = xf[self.rbe2_master]
            if self.rbe3_master is not None:
                xf[self.rbe3_master] = rbe3_average(
                    xf, self.rbe3_table, self.rbe3_slave,
                    self.rbe3_weights.to(X.dtype), self.rbe3_wsum.to(X.dtype))
        return out

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        return r * self.mask.to(r.dtype)

    def masks(self):
        """(m_state, m_res) when both projections are the mask alone (no
        SPC value, no RBE2/RBE3 set), else None (solvers.cg_fused)."""
        if self.spc_const is not None or self.has_sets:
            return None
        return self.mask, self.mask


# ---------------------------------------------------------------------------
# packed PCG system
# ---------------------------------------------------------------------------

class PackedSystem:
    """Operator + constraints (fixed nodes, or SPC/RBE2/RBE3 through a
    solvers.constraints.Constraints) + a Jacobi or block-Jacobi
    preconditioner; PCG in the packed [Nb, 384] layout (solvers.cg).

    On the card each (tol, dot_dtype) gets one solvers.cg.CGBlock whose
    32-iteration block (and the shorter last block of a chunk) is captured
    once as a CUDA graph and replayed by every solve; `warm` and
    `warm_chunked` capture it without running anything, as tpufem's AOT
    compile does.  The per-call prologue (r = P(b - A u), the resume) runs
    eagerly.  On the CPU the blocks run eagerly and `warm*` do nothing.
    The rest of tpufem's solver family runs on the same operator and
    constraints: solve_bicgstab, solve_gmres (left Jacobi when the system
    has scalar Jacobi), mass_packed and modal."""

    def __init__(self, op: PackedPartialOperator, fixed_nodes=None,
                 precondition="jacobi", constraints=None):
        """precondition: "jacobi" (scalar diagonal from op.diagonal()),
        "block" (exact 3x3 node-block inverse, BlockJacobi) or
        False/None.  constraints: optional solvers.constraints.Constraints
        (SPC/RBE2/RBE3); fixed_nodes is the all-DOF-pin shortcut."""
        self.op = op
        plan = op.plan
        dtype = op.W.dtype
        if constraints is not None:
            self.pc = PackedConstraints.build(constraints, plan, dtype)
        else:
            self.pc = PackedConstraints.fixed(plan, fixed_nodes, dtype)
        self.mask = self.pc.mask
        self.precondition = precondition
        if precondition == "block":
            self.M_inv = BlockJacobi.build(op, mask=self.mask)
        elif precondition:              # "jacobi" / True
            d = op.diagonal()
            minv = torch.where(torch.abs(d) > 0,
                               1.0 / torch.where(d == 0, 1.0, d), 0.0)
            self.M_inv = minv * self.mask
        else:
            self.M_inv = torch.ones_like(self.mask)
        self._blocks = {}

    @property
    def jacobi(self):
        """The scalar-Jacobi array, or None under block Jacobi or none:
        the M_inv that GMRES and the modal solver take (tpufem's rule)."""
        return (self.M_inv if self.precondition and not callable(self.M_inv)
                else None)

    def _cached(self, key, make):
        """The solver block of `key`, made at first use (on the card its
        graphs are captured once and replayed by every solve)."""
        if key not in self._blocks:
            self._blocks[key] = make()
        return self._blocks[key]

    def _block(self, tol, dot_dtype):
        """The CGBlock of this (tol, dot_dtype)."""
        from ..solvers.cg import CGBlock
        return self._cached((float(tol), str(dot_dtype)), lambda: CGBlock(
            self.op, self.mask, constraints=self.pc, M_inv=self.M_inv,
            tol=tol, dot_dtype=dot_dtype))

    def _capture(self, tol, max_iter, dot_dtype) -> None:
        from ..solvers.cg import CHECK_EVERY
        blk = self._block(tol, dot_dtype)
        for n in {min(CHECK_EVERY, max_iter), max_iter % CHECK_EVERY}:
            if n:
                blk.capture(n)

    def warm(self, b=None, x0=None, tol: float = 1e-8, max_iter: int = 1000,
             dot_dtype=None) -> None:
        """Capture the solve's blocks for this (tol, max_iter, dot_dtype)
        without running them (b and x0, tpufem's arguments, are not
        needed: the graphs read the state's static buffers)."""
        self._capture(tol, max_iter, dot_dtype)

    def warm_chunked(self, b=None, tol: float = 1e-8, every: int = 500,
                     dot_dtype=None) -> None:
        """Capture the chunked solve's blocks (see solve_chunked)."""
        self._capture(tol, every, dot_dtype)

    def _rhs(self, b, x0):
        plan = self.op.plan
        dt, dev = self.mask.dtype, self.mask.device
        bX = plan.pack(torch.as_tensor(b, dtype=dt, device=dev))
        x0X = (plan.pack(torch.as_tensor(x0, dtype=dt, device=dev))
               if x0 is not None else torch.zeros_like(bX))
        return bX, x0X

    def solve(self, b, x0=None, tol: float = 1e-8, max_iter: int = 1000,
              dot_dtype=None):
        """b [N, 3] -> (u [N, 3], SolveInfo)."""
        bX, x0X = self._rhs(b, x0)
        uX, info = self._block(tol, dot_dtype).solve(
            self.pc.project_residual(bX), x0=x0X, max_iter=max_iter)
        return self.op.plan.unpack(uX), info

    def _chunks(self, bX, x0X, tol, max_iter, every, dot_dtype):
        """solvers.cg.cg_chunks on this system.  tpufem's packed chunk loop
        runs whole chunks of `every`, past max_iter when every does not
        divide it: max_iter rounded up to a multiple of every gives those
        chunks."""
        from ..solvers.cg import cg_chunks
        return cg_chunks(self._block(tol, dot_dtype),
                         self.pc.project_residual(bX), x0X,
                         -(-max_iter // every) * every, every)

    def solve_chunked_packed(self, bX: torch.Tensor, tol: float = 1e-8,
                             max_iter: int = 20000, every: int = 500,
                             dot_dtype=None):
        """solve_chunked with a packed [Nb, 384] RHS in and solution out
        (the refinement path's interface)."""
        # one chunk's answer held at a time (a list of them would keep
        # every chunk's u alive)
        for uX, info, done in self._chunks(bX, torch.zeros_like(bX), tol,
                                           max_iter, every, dot_dtype):
            pass
        return uX, info._replace(iterations=torch.tensor(done))

    def solve_chunked(self, b, x0=None, tol: float = 1e-8,
                      max_iter: int = 20000, every: int = 500,
                      dot_dtype=None, progress=None):
        """PCG as a sequence of `every`-iteration chunks with exact
        recurrence continuation (cg resume_state): the same trajectory as
        one solve.  Returns (u [N, 3], SolveInfo) with the concatenated
        residual history and the total iteration count."""
        from ..solvers.cg import chunk_history
        bX, x0X = self._rhs(b, x0)
        uX, info = chunk_history(self._chunks(bX, x0X, tol, max_iter, every,
                                              dot_dtype), progress)
        return self.op.plan.unpack(uX), info

    # -- the rest of the solver family on the packed operator -------------
    # (each keeps its block per configuration in _cached)
    def solve_bicgstab(self, b, x0=None, tol: float = 1e-8,
                       max_iter: int = 1000):
        """BiCGStab in the packed layout (no preconditioner, as in
        tpufem); tol is RELATIVE to ||r0||.  b [N, 3] -> (u [N, 3],
        SolveInfo)."""
        from ..solvers.bicgstab import BiCGStabBlock
        blk = self._cached(("bicgstab", float(tol)), lambda: (
            BiCGStabBlock(self.op, self.mask, constraints=self.pc, tol=tol)))
        bX, x0X = self._rhs(b, x0)
        uX, info = blk.solve(self.pc.project_residual(bX), x0=x0X,
                             max_iter=max_iter)
        return self.op.plan.unpack(uX), info

    def solve_gmres(self, b, x0=None, tol: float = 1e-8,
                    max_iter: int = 1000, restart: int = 50):
        """Restarted GMRES in the packed layout, left-Jacobi when the
        system has the scalar-Jacobi preconditioner (tol and the history
        are then on ||M^-1 r||).  b [N, 3] -> (u [N, 3], SolveInfo)."""
        from ..solvers.gmres import GMRESCycle
        blk = self._cached(
            ("gmres", float(tol), int(restart)), lambda: GMRESCycle(
                self.op, self.mask, constraints=self.pc, M_inv=self.jacobi,
                tol=tol, restart=restart))
        bX, x0X = self._rhs(b, x0)
        uX, info = blk.solve(self.pc.project_residual(bX), x0=x0X,
                             max_iter=max_iter)
        return self.op.plan.unpack(uX), info

    def mass_packed(self, mass_nodal, clamp: float = 1e-12) -> torch.Tensor:
        """Nodal lumped mass [N] or [N, 3] -> packed flat [Nb * 384]
        diagonal (padding lanes clamped positive: they carry no modes, the
        constraint mask zeroes them)."""
        Mn = (mass_nodal.cpu().numpy() if isinstance(mass_nodal, torch.Tensor)
              else np.asarray(mass_nodal))
        if Mn.ndim == 1:
            Mn = np.repeat(Mn[:, None], 3, axis=1)
        npdt = torch.empty((), dtype=self.mask.dtype).numpy().dtype
        X = self.op.plan.pack_np(Mn.astype(npdt))
        return torch.as_tensor(np.maximum(X, clamp).reshape(-1),
                               device=self.mask.device)

    def modal(self, mass_nodal, num_eigs: int = 5, **kw):
        """Smallest modes of K phi = lambda M phi through the packed
        operator (solvers.modal.modal_solver, the scalar-Jacobi inner PCG
        when the system has it).  Returns (eigenvalues [k], modes
        [N, 3, k], ModalInfo)."""
        from ..solvers.modal import modal_solver
        plan = self.op.plan
        nb = plan.meta.n_blocks
        lam, modes, info = modal_solver(
            self.op, self.mass_packed(mass_nodal), (nb, ROW), num_eigs,
            constraints=self.pc, precondition=self.jacobi, **kw)
        out = torch.stack([plan.unpack(modes[:, j].reshape(nb, ROW))
                           for j in range(num_eigs)], dim=-1)
        return lam, out, info
