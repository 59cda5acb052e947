"""ctypes bindings for the native host engine (meshops.cpp): the packed
plan build, face and edge hashing, and the partitioner's BFS passes.

Compiled at first use (``g++ -O3 -shared``) into ``native/_build/``.  Every
entry point returns None when the library is unavailable, and its caller
then runs a numpy fallback that gives the same tables.  ``TPUFEM_NO_NATIVE=1``
disables the library.  At a million elements the plan build needs it: the
numpy fallbacks take minutes where the native passes take seconds.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _tune_malloc() -> None:
    """Keep large numpy temporaries on the reused heap.

    glibc mmap()s every allocation over 32 MB and unmaps it on free, so each
    large temporary of the plan build faults all of its pages again; raising
    M_MMAP_THRESHOLD / M_TRIM_THRESHOLD keeps big buffers on the heap.
    """
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(ctypes.c_int(-3), ctypes.c_int(1 << 30))  # M_MMAP_THRESHOLD
        libc.mallopt(ctypes.c_int(-1), ctypes.c_int(1 << 30))  # M_TRIM_THRESHOLD
    except Exception:
        pass


_tune_malloc()


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TPUFEM_NO_NATIVE"):
        return None
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "meshops.cpp")
    so = os.path.join(_build_dir(), "libmeshops.so")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            # build beside the target and rename: concurrent test workers
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_build_dir())
            os.close(fd)
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", src, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
    except Exception:
        return None

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.extract_faces.restype = ctypes.c_int32
    lib.extract_faces.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                  i32p, ctypes.c_int32, ctypes.c_int32,
                                  i32p, i64p, i32p, i32p, i32p, i64p]
    lib.region_grow.restype = ctypes.c_int32
    lib.region_grow.argtypes = [i64p, i32p, ctypes.c_int64, i32p,
                                ctypes.c_int32, i64p]
    lib.bfs_distances.restype = ctypes.c_int32
    lib.bfs_distances.argtypes = [i64p, i32p, ctypes.c_int64, i32p,
                                  ctypes.c_int64, i64p]
    lib.unique_edges.restype = ctypes.c_int64
    lib.unique_edges.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                 i32p, ctypes.c_int32, i32p]
    lib.radix_argsort_i32.restype = ctypes.c_int32
    lib.radix_argsort_i32.argtypes = [i32p, ctypes.c_int64, i32p]
    lib.sort_unique_inverse_i64.restype = ctypes.c_int64
    lib.sort_unique_inverse_i64.argtypes = [i64p, ctypes.c_int64, i64p, i64p]
    lib.first_touch_i32.restype = ctypes.c_int64
    lib.first_touch_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                    i32p]
    lib.cluster_slots.restype = ctypes.c_int32
    lib.cluster_slots.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                  i32p, i32p]
    lib.cluster_windows.restype = None
    lib.cluster_windows.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32,
                                    ctypes.c_int32, i32p, i32p, i32p, i32p]
    lib.block_windows_count.restype = None
    lib.block_windows_count.argtypes = [i32p, ctypes.c_int64,
                                        ctypes.c_int64, i32p]
    lib.block_windows_fill.restype = None
    lib.block_windows_fill.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int32, i32p, i32p, i32p]
    lib.block_windows_fill_packed.restype = None
    lib.block_windows_fill_packed.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p, i32p, i32p, i32p]
    lib.cinc_widths.restype = None
    lib.cinc_widths.argtypes = [i32p, u8p, ctypes.c_int64, ctypes.c_int32,
                                ctypes.c_int32, ctypes.c_int32,
                                ctypes.c_int32, i32p]
    lib.cinc_fill_packed.restype = None
    lib.cinc_fill_packed.argtypes = [i32p, u8p, i64p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32,
                                     i64p, ctypes.c_int32, i32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _p(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def extract_faces(conn: np.ndarray, face_table: np.ndarray,
                  opposite: Optional[np.ndarray] = None):
    """(boundary_faces, boundary_opposite, shared [S, 2, 2]) through the
    native hash table, in element-major first-visit order; None without
    the library (the caller falls back to numpy)."""
    lib = _load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    face_table = np.ascontiguousarray(face_table, dtype=np.int32)
    M, k = conn.shape
    n_faces, fw = face_table.shape
    boundary = np.empty((M * n_faces, fw), np.int32)
    b_opp = np.empty(M * n_faces, np.int32)
    shared = np.empty((M * n_faces // 2 + 1, 4), np.int32)
    nb = np.zeros(1, np.int64)
    ns = np.zeros(1, np.int64)
    opp = (np.ascontiguousarray(opposite, dtype=np.int32)
           if opposite is not None else None)
    rc = lib.extract_faces(
        _p(conn, ctypes.c_int32), M, k, _p(face_table, ctypes.c_int32),
        n_faces, fw, _p(boundary, ctypes.c_int32), _p(nb, ctypes.c_int64),
        _p(b_opp, ctypes.c_int32) if opp is not None else None,
        _p(opp, ctypes.c_int32) if opp is not None else None,
        _p(shared, ctypes.c_int32), _p(ns, ctypes.c_int64))
    if rc != 0:
        return None
    nb, ns = int(nb[0]), int(ns[0])
    return (boundary[:nb].copy(),
            b_opp[:nb].copy() if opp is not None else None,
            shared[:ns].reshape(ns, 2, 2).copy())


def region_grow(indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray,
                n_parts: int) -> Optional[np.ndarray]:
    """Multi-source BFS labels [n] int64 on a CSR graph (the lowest part
    id wins a contested vertex), or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    seeds = np.ascontiguousarray(seeds, dtype=np.int32)
    n = indptr.shape[0] - 1
    labels = np.empty(n, np.int64)
    rc = lib.region_grow(_p(indptr, ctypes.c_int64),
                         _p(indices, ctypes.c_int32), n,
                         _p(seeds, ctypes.c_int32), n_parts,
                         _p(labels, ctypes.c_int64))
    return labels if rc == 0 else None


def bfs_distances(indptr: np.ndarray, indices: np.ndarray,
                  sources: np.ndarray) -> Optional[np.ndarray]:
    """BFS hop distances [n] int64 from a source set (-1: unreachable),
    or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    n = indptr.shape[0] - 1
    dist = np.empty(n, np.int64)
    rc = lib.bfs_distances(_p(indptr, ctypes.c_int64),
                           _p(indices, ctypes.c_int32), n,
                           _p(sources, ctypes.c_int32), sources.shape[0],
                           _p(dist, ctypes.c_int64))
    return dist if rc == 0 else None


def unique_edges(conn: np.ndarray, edge_table: np.ndarray
                 ) -> Optional[np.ndarray]:
    """Unique undirected edges [E, 2] (smaller node first) in first-visit
    order, or None."""
    lib = _load()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, dtype=np.int32)
    edge_table = np.ascontiguousarray(edge_table, dtype=np.int32)
    M, k = conn.shape
    ne_tbl = edge_table.shape[0]
    out = np.empty((M * ne_tbl, 2), np.int32)
    ne = lib.unique_edges(_p(conn, ctypes.c_int32), M, k,
                          _p(edge_table, ctypes.c_int32), ne_tbl,
                          _p(out, ctypes.c_int32))
    return out[:ne].copy() if ne >= 0 else None


def radix_argsort(keys: np.ndarray) -> Optional[np.ndarray]:
    """Stable argsort of non-negative int32 keys."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int32)
    perm = np.empty(keys.shape[0], np.int32)
    rc = lib.radix_argsort_i32(_p(keys, ctypes.c_int32), keys.shape[0],
                               _p(perm, ctypes.c_int32))
    return perm if rc == 0 else None


def unique_inverse_i64(keys: np.ndarray
                       ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(ascending unique keys, inverse) of a non-negative int64 stream."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    uniq = np.empty(n, np.int64)
    inv = np.empty(n, np.int64)
    nu = lib.sort_unique_inverse_i64(_p(keys, ctypes.c_int64), n,
                                     _p(uniq, ctypes.c_int64),
                                     _p(inv, ctypes.c_int64))
    if nu < 0:
        return None
    return uniq[:nu].copy(), inv


def first_touch(flat: np.ndarray, n_nodes: int) -> Optional[np.ndarray]:
    """new_from_old[n_nodes]: first-appearance rank of each node in `flat`
    (entries < 0 skipped; untouched nodes -1).  One O(n) pass."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    out = np.empty(int(n_nodes), np.int32)
    rc = lib.first_touch_i32(_p(flat, ctypes.c_int32), flat.shape[0],
                             int(n_nodes), _p(out, ctypes.c_int32))
    return out if rc >= 0 else None


def cinc_widths(lconn: np.ndarray, ev: np.ndarray, k: int, E_c: int,
                Gch: int) -> Optional[np.ndarray]:
    """Per-(cluster, lane-chunk) compress-incidence widths [B, Gch] int32."""
    lib = _load()
    if lib is None:
        return None
    lconn = np.ascontiguousarray(lconn, dtype=np.int32)
    ev = np.ascontiguousarray(ev, dtype=np.uint8)
    B, Rp = lconn.shape
    out = np.empty((B, Gch), np.int32)
    lib.cinc_widths(_p(lconn, ctypes.c_int32), _p(ev, ctypes.c_uint8),
                    B, k, E_c, Rp, Gch, _p(out, ctypes.c_int32))
    return out


def cinc_fill_packed(lconn: np.ndarray, ev: np.ndarray,
                     cluster_ids: np.ndarray, k: int, E_c: int, Gch: int,
                     voff: np.ndarray, Wp: int) -> Optional[np.ndarray]:
    """Byte-packed incidence words [ng, Wp, 128] int32 for one bucket."""
    lib = _load()
    if lib is None:
        return None
    lconn = np.ascontiguousarray(lconn, dtype=np.int32)
    ev = np.ascontiguousarray(ev, dtype=np.uint8)
    cluster_ids = np.ascontiguousarray(cluster_ids, dtype=np.int64)
    voff = np.ascontiguousarray(voff, dtype=np.int64)
    B, Rp = lconn.shape
    ng = cluster_ids.shape[0]
    out = np.zeros((ng, max(int(Wp), 1), 128), np.int32)
    lib.cinc_fill_packed(_p(lconn, ctypes.c_int32), _p(ev, ctypes.c_uint8),
                         _p(cluster_ids, ctypes.c_int64), ng, k, E_c, Rp,
                         Gch, _p(voff, ctypes.c_int64), out.shape[1],
                         _p(out, ctypes.c_int32))
    return out


def cluster_slots(gconn: np.ndarray):
    """(l2g [B, 128], slot_of_entry [B, kEc], max_slots) or None."""
    lib = _load()
    if lib is None:
        return None
    gconn = np.ascontiguousarray(gconn, dtype=np.int32)
    B, kEc = gconn.shape
    l2g = np.empty((B, 128), np.int32)
    so = np.empty((B, kEc), np.int32)
    mx = lib.cluster_slots(_p(gconn, ctypes.c_int32), B, kEc,
                           _p(l2g, ctypes.c_int32), _p(so, ctypes.c_int32))
    return l2g, so, int(mx)


def cluster_windows(l2g: np.ndarray, nb: int, wcap: int = 128):
    """(win_full [B, wcap] pad nb, wn_cnt [B], wslot [B, 128] pad wcap,
    jslot [B, 128]) or None."""
    lib = _load()
    if lib is None:
        return None
    l2g = np.ascontiguousarray(l2g, dtype=np.int32)
    B = l2g.shape[0]
    win_full = np.empty((B, wcap), np.int32)
    wn_cnt = np.empty(B, np.int32)
    wslot = np.empty((B, 128), np.int32)
    jslot = np.empty((B, 128), np.int32)
    lib.cluster_windows(_p(l2g, ctypes.c_int32), B, nb, wcap,
                        _p(win_full, ctypes.c_int32),
                        _p(wn_cnt, ctypes.c_int32),
                        _p(wslot, ctypes.c_int32), _p(jslot, ctypes.c_int32))
    return win_full, wn_cnt, wslot, jslot


def block_windows_count(l2g: np.ndarray, nb: int) -> Optional[np.ndarray]:
    """Per-block cluster-window counts [nb] int32, or None."""
    lib = _load()
    if lib is None:
        return None
    l2g = np.ascontiguousarray(l2g, dtype=np.int32)
    wc_cnt = np.empty(nb, np.int32)
    lib.block_windows_count(_p(l2g, ctypes.c_int32), l2g.shape[0], nb,
                            _p(wc_cnt, ctypes.c_int32))
    return wc_cnt


def block_windows(l2g: np.ndarray, nb: int):
    """(winc [nb, Wc] pad B, slotidx [nb, Wc, 128] pad -1, wc_cnt [nb])
    or None.  Deterministic: clusters ascending per block."""
    lib = _load()
    if lib is None:
        return None
    l2g = np.ascontiguousarray(l2g, dtype=np.int32)
    B = l2g.shape[0]
    wc_cnt = np.empty(nb, np.int32)
    lib.block_windows_count(_p(l2g, ctypes.c_int32), B, nb,
                            _p(wc_cnt, ctypes.c_int32))
    wc = max(1, int(wc_cnt.max()) if nb else 1)
    cursor = np.zeros(nb, np.int32)
    winc = np.empty((nb, wc), np.int32)
    slotidx = np.empty((nb, wc, 128), np.int32)
    lib.block_windows_fill(_p(l2g, ctypes.c_int32), B, nb, wc,
                           _p(cursor, ctypes.c_int32),
                           _p(winc, ctypes.c_int32),
                           _p(slotidx, ctypes.c_int32))
    return winc, slotidx, wc_cnt


def block_windows_fill_packed(l2g: np.ndarray, nb: int, wc: int,
                              bpos: np.ndarray, cpos: np.ndarray):
    """(winc [nb, wc] in bucket order with mapped cluster ids, byte-packed
    slotidx [nb, ceil(wc/4), 128] int32) or None.  Entries per block ascend
    in old cluster id (the deterministic combine order)."""
    lib = _load()
    if lib is None:
        return None
    l2g = np.ascontiguousarray(l2g, dtype=np.int32)
    bpos = np.ascontiguousarray(bpos, dtype=np.int32)
    cpos = np.ascontiguousarray(cpos, dtype=np.int32)
    wcp4 = max(-(-int(wc) // 4), 1)
    cursor = np.zeros(nb, np.int32)
    winc = np.empty((nb, wc), np.int32)
    packed = np.zeros((nb, wcp4, 128), np.int32)
    lib.block_windows_fill_packed(
        _p(l2g, ctypes.c_int32), l2g.shape[0], nb, wc, wcp4,
        _p(bpos, ctypes.c_int32), _p(cpos, ctypes.c_int32),
        _p(cursor, ctypes.c_int32), _p(winc, ctypes.c_int32),
        _p(packed, ctypes.c_int32))
    return winc, packed
