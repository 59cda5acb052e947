"""Host-side mesh partitioning: dual graph, distant seeds, region growing.

A copy of tpufem/parallel/partition.py (jax-free), on the port's native
module, topology and Morton order; labels are bitwise tpufem's.

Semantics of subdivision.ipynb cells 7-9 (compute_subdivisions,
build_adjacency_matrix, pick_distant_seeds, region_growing_partition),
reimplemented with scipy.sparse BFS on host — run once at setup; the
device never sees dynamic shapes.  Deterministic: seeded RNG + ordered
tie-breaking (the notebook used torch.randint without a fixed seed).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.sparse as sp


def compute_subdivisions(matrix_size: int, memory_gb: float,
                         bytes_per_float: int = 4) -> int:
    """#partitions heuristic from a dense-memory budget
    (subdivision.ipynb cell 7)."""
    max_elems = memory_gb * (1024**3) // bytes_per_float
    max_dim = int(math.floor(math.sqrt(max_elems)))
    return int(math.ceil(matrix_size / max_dim))


def build_adjacency(edge: np.ndarray, n: int) -> sp.csr_matrix:
    """Symmetric boolean adjacency from a [2, E] edge list."""
    e = np.asarray(edge)
    rows = np.concatenate([e[0], e[1]])
    cols = np.concatenate([e[1], e[0]])
    data = np.ones(rows.shape[0], dtype=bool)
    return sp.csr_matrix((data, (rows, cols)), shape=(n, n))


def _bfs_distances(adj: sp.csr_matrix, sources: np.ndarray) -> np.ndarray:
    from .. import native

    nat = native.bfs_distances(adj.indptr.astype(np.int64),
                               adj.indices.astype(np.int32),
                               np.asarray(sources, np.int32))
    if nat is not None:
        nat = nat.copy()
        nat[nat < 0] = np.iinfo(np.int64).max
        return nat
    n = adj.shape[0]
    dist = np.full(n, np.iinfo(np.int64).max)
    frontier = np.zeros(n, dtype=bool)
    frontier[sources] = True
    d = 0
    while frontier.any():
        newly = frontier & (dist == np.iinfo(np.int64).max)
        dist[newly] = d
        frontier = (adj @ frontier) & (dist == np.iinfo(np.int64).max)
        d += 1
    return dist


def pick_distant_seeds(adj: sp.csr_matrix, n_parts: int,
                       seed: int = 0) -> np.ndarray:
    """Greedy farthest-point BFS seeding (subdivision.ipynb cell 9)."""
    rng = np.random.default_rng(seed)
    n = adj.shape[0]
    seeds = [int(rng.integers(n))]
    for _ in range(n_parts - 1):
        dist = _bfs_distances(adj, np.asarray(seeds))
        # unreachable components first, then true farthest (stable argmax)
        seeds.append(int(np.argmax(np.where(dist == np.iinfo(np.int64).max,
                                            -1, dist))))
    return np.asarray(seeds)


def region_growing_partition(edge: np.ndarray, n_parts: int, n_elements: int,
                             seed: int = 0, balanced: bool = False
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-source BFS labels [M] + the seeds (subdivision.ipynb cell 9).

    Ties (element reachable from several fronts in the same sweep) resolve
    to the lowest part id — fixed, reproducible ordering.

    balanced=True caps each part near ceil(M / n_parts) during the growth
    (capped parts stop claiming; the cap relaxes 10% at a time if growth
    stalls) — bounds the nI_max/Mp padding that unconstrained region
    growing leaves (measured 742/7208 min/max part sizes at 32 parts).
    """
    from .. import native

    adj = build_adjacency(edge, n_elements)
    seeds = pick_distant_seeds(adj, n_parts, seed)
    if not balanced:
        nat = native.region_grow(adj.indptr.astype(np.int64),
                                 adj.indices.astype(np.int32),
                                 np.asarray(seeds, np.int32), n_parts)
        if nat is not None:
            return nat, seeds
    cap = (-(-n_elements // n_parts) + 1) if balanced else n_elements + 1
    labels = np.full(n_elements, -1, dtype=np.int64)
    labels[seeds] = np.arange(n_parts)
    frontier = np.zeros((n_parts, n_elements), dtype=bool)
    frontier[np.arange(n_parts), seeds] = True
    while (labels == -1).any():
        sizes = np.bincount(labels[labels >= 0], minlength=n_parts)
        active = sizes < cap
        expanded = np.zeros_like(frontier)
        for p in range(n_parts):
            if active[p]:
                expanded[p] = (adj @ frontier[p]) & (labels == -1)
        if not expanded.any():
            if balanced and (~active).any():
                cap = cap + max(1, cap // 10)     # relax and keep growing
                frontier = np.zeros_like(frontier)
                for p in range(n_parts):
                    frontier[p] = labels == p
                continue
            # disconnected leftovers: assign to the smallest part
            left = np.nonzero(labels == -1)[0]
            labels[left] = int(np.argmin(sizes))
            break
        # lowest part id wins contested elements; respect the cap by
        # claiming at most the remaining budget (stable lowest-index order)
        winner = np.argmax(expanded, axis=0)
        claimed = expanded.any(axis=0)
        if balanced:
            for p in range(n_parts):
                mine = np.nonzero(claimed & (winner == p))[0]
                room = cap - sizes[p]
                if mine.size > room:
                    drop = mine[room:]
                    claimed[drop] = False
        labels[np.nonzero(claimed)[0]] = winner[claimed]
        frontier = expanded & (labels[None, :] == np.arange(n_parts)[:, None])
    return labels, seeds


def partition_elements(conn, etype: str, n_parts: int, seed: int = 0,
                       balanced: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Labels [M] for any solid mesh via its shared-face dual graph."""
    from ..topology.faces import element_dual_graph

    edge = element_dual_graph(np.asarray(conn), etype)
    return region_growing_partition(edge, n_parts, np.asarray(conn).shape[0],
                                    seed, balanced=balanced)


def rcb_partition(coords, conn, n_parts: int) -> np.ndarray:
    """Labels [M]: recursive coordinate bisection of element centroids.

    Splits the element set at the size-proportional quantile along the
    widest axis, recursively — exact (+-1) balance like the Morton curve
    but with COMPACT box-shaped parts, so per-part surfaces (the hybrid
    solver's dense interface blocks scale with their square) are smaller
    and more uniform than Morton chunks.  Handles any n_parts (not just
    powers of two).  O(M log M log P) host time.
    """
    conn = np.asarray(conn)
    coords = np.asarray(coords)
    kc = min(conn.shape[1], 4)
    cent = coords[conn[:, :kc]].astype(np.float32, copy=False).mean(axis=1)
    M = conn.shape[0]
    labels = np.empty(M, np.int64)
    stack = [(np.arange(M), 0, n_parts)]
    while stack:
        idx, base, parts = stack.pop()
        if parts == 1 or idx.size <= 1:
            labels[idx] = base          # n_parts > M: surplus parts empty
            continue
        p1 = parts // 2
        k = (idx.size * p1) // parts
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argpartition(c[:, axis], k)
        stack.append((idx[order[:k]], base, p1))
        stack.append((idx[order[k:]], base + p1, parts - p1))
    return labels


def morton_partition(coords, conn, n_parts: int) -> np.ndarray:
    """Labels [M]: equal contiguous chunks of the Morton curve.

    Space-filling-curve partitioning (the p4est/SFC family): element
    sizes are EXACTLY balanced (+-1) by construction and the curve keeps
    parts spatially compact, at the cost of a somewhat larger interface
    than graph growing.  The right partitioner whenever per-part padding
    costs quadratically (the hybrid Schur solver's dense interior
    factors are padded to the LARGEST part: the balanced region grower
    still left 9x size spread at 1M elements / 128 parts, which OOM'd
    the solve; this is exact).  O(M log M) host time (~1 s at 1M).
    """
    from ..ops.packed import morton_order

    conn = np.asarray(conn)
    M = conn.shape[0]
    perm = morton_order(np.asarray(coords), conn)
    bounds = (np.arange(1, n_parts + 1, dtype=np.int64) * M) // n_parts
    sizes = np.diff(np.concatenate([[0], bounds]))
    labels = np.empty(M, np.int64)
    labels[perm] = np.repeat(np.arange(n_parts, dtype=np.int64), sizes)
    return labels


def hierarchical_partition(conn, etype: str, shape: Tuple[int, int],
                           seed: int = 0, balanced: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Two-level (host x chip) labels for an ICI/DCN device hierarchy.

    First region-grows ``shape[0]`` host groups on the element dual graph,
    then region-grows ``shape[1]`` chip parts inside each host's subgraph,
    so chips of one host hold spatially adjacent subdomains: halo pairs
    concentrate inside hosts (ICI) and only host-surface pairs cross DCN.
    Returns (labels [M] with part id = host * shape[1] + chip,
    host_labels [M]).
    """
    from ..topology.faces import element_dual_graph

    conn = np.asarray(conn)
    M = conn.shape[0]
    n_hosts, per = shape
    edge = element_dual_graph(conn, etype)
    host_labels, _ = region_growing_partition(edge, n_hosts, M, seed,
                                              balanced=balanced)
    labels = np.empty(M, np.int64)
    for h in range(n_hosts):
        sel = np.nonzero(host_labels == h)[0]
        remap = np.full(M, -1, np.int64)
        remap[sel] = np.arange(sel.size)
        keep = (remap[edge[0]] >= 0) & (remap[edge[1]] >= 0)
        sub_edge = np.stack([remap[edge[0, keep]], remap[edge[1, keep]]])
        sub, _ = region_growing_partition(sub_edge, per, sel.size,
                                          seed + 1 + h, balanced=balanced)
        labels[sel] = h * per + sub
    return labels, host_labels


def owner_of_nodes(conn, labels, n_nodes: int) -> np.ndarray:
    """Node -> part ownership: the smallest part id among adjacent elements
    (deterministic; interface nodes get the lower-numbered side)."""
    conn = np.asarray(conn)
    owner = np.full(n_nodes, np.iinfo(np.int64).max)
    lab = np.repeat(np.asarray(labels), conn.shape[1])
    np.minimum.at(owner, conn.reshape(-1), lab)
    # isolated nodes -> part 0
    owner[owner == np.iinfo(np.int64).max] = 0
    return owner
