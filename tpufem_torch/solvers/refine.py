"""Mixed-precision iterative refinement: f64-verified converged solves.

    u_64 = 0
    repeat:  r_64 = P(b - A_64 u_64)         # f64 TRUE residual
             solve A_32 d ~= r / ||r||       # f32 packed PCG, tol ~5e-3
             u_64 += ||r|| * d
    until ||r_64|| <= tol * ||b||.

Plain f32 PCG stalls near kappa * eps_f32 and then breaks down on large
meshes, so a 1e-6 solve needs the f64 outer loop.  The f64 operator here
is independent of the packed kernels: natural ``[M, k, 3]`` layout, float64
arithmetic (the card has native f64), and a deterministic scatter (a
padded node -> element-lane incidence summed in a fixed order, over node
ranges so that its gather stays small), so two runs print the same outer
history.  Its geometry (J, the adjugate inverse, det, the affine test) and
its incidence (a stable sort, lanes ascending per node) are computed on
the operator's device in f64 with the same formulas as tpufem's
``_PlanarF64Op`` (``_host_geometry`` is the host numpy version, kept as
the plain version the tests hold them against), stored in
``geometry_dtype`` and upcast per use: both packages define the same f64
operator.  ``cache_path`` keeps the stored geometry in an ``.npz`` file.
"""
from __future__ import annotations

import os
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from ..utils.profiling import count, span, spanned


class RefineInfo(NamedTuple):
    converged: bool
    cycles: int
    inner_iterations: int
    residual_norm: float          # f64 true residual, absolute
    rel_residual: float
    outer_history: np.ndarray     # f64 true ||r|| per cycle


def _host_geometry(coords64: np.ndarray, cc: np.ndarray, dN: np.ndarray,
                   w: np.ndarray):
    """(Jinv [Mc, qJ, 3, 3], W [Mc, q]) in f64 numpy (adjugate inverse;
    qJ = 1 where J is constant over the quadrature points)."""
    Xk = coords64[cc]                                   # [Mc, k, 3]
    J = np.einsum("qka,mkb->mqab", dN, Xk)
    c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    c01 = J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2]
    c02 = J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]
    c10 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    c11 = J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0]
    c12 = J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]
    c20 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    c21 = J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1]
    c22 = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    det = J[..., 0, 0] * c00 + J[..., 0, 1] * c10 + J[..., 0, 2] * c20
    inv_det = 1.0 / det
    Jinv = (np.stack([np.stack([c00, c01, c02], -1),
                      np.stack([c10, c11, c12], -1),
                      np.stack([c20, c21, c22], -1)], -2)
            * inv_det[..., None, None])                 # [Mc, q, 3, 3]
    W = w[None, :] * det                                # [Mc, q]
    spreadJ = (np.abs(Jinv - Jinv[:, :1]).max()
               / max(np.abs(Jinv).max(), 1e-300))
    qJ = 1 if spreadJ < 1e-12 else J.shape[1]
    return Jinv[:, :qJ], W


def device_geometry(coords64: torch.Tensor, cc: torch.Tensor,
                    dN: torch.Tensor, w: torch.Tensor):
    """_host_geometry on torch tensors (f64, on any device): the same
    formulas in the same order (J's sum over the nodes left to right, as
    numpy's einsum adds them, then elementwise operations), so the two
    agree bitwise.  Returns (Jinv [Mc, qJ, 3, 3], W [Mc, q])."""
    Xk = coords64[cc]                                   # [Mc, k, 3]
    J = None
    for kk in range(dN.shape[1]):
        term = dN[None, :, kk, :, None] * Xk[:, None, kk, None, :]
        J = term if J is None else J + term             # [Mc, q, 3, 3]
    del Xk, term
    c00 = J[..., 1, 1] * J[..., 2, 2] - J[..., 1, 2] * J[..., 2, 1]
    c01 = J[..., 0, 2] * J[..., 2, 1] - J[..., 0, 1] * J[..., 2, 2]
    c02 = J[..., 0, 1] * J[..., 1, 2] - J[..., 0, 2] * J[..., 1, 1]
    c10 = J[..., 1, 2] * J[..., 2, 0] - J[..., 1, 0] * J[..., 2, 2]
    c11 = J[..., 0, 0] * J[..., 2, 2] - J[..., 0, 2] * J[..., 2, 0]
    c12 = J[..., 0, 2] * J[..., 1, 0] - J[..., 0, 0] * J[..., 1, 2]
    c20 = J[..., 1, 0] * J[..., 2, 1] - J[..., 1, 1] * J[..., 2, 0]
    c21 = J[..., 0, 1] * J[..., 2, 0] - J[..., 0, 0] * J[..., 2, 1]
    c22 = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    det = J[..., 0, 0] * c00 + J[..., 0, 1] * c10 + J[..., 0, 2] * c20
    del J
    inv_det = 1.0 / det
    Jinv = (torch.stack([torch.stack([c00, c01, c02], -1),
                         torch.stack([c10, c11, c12], -1),
                         torch.stack([c20, c21, c22], -1)], -2)
            * inv_det[..., None, None])                 # [Mc, q, 3, 3]
    W = w[None, :] * det                                # [Mc, q]
    spreadJ = float((Jinv - Jinv[:, :1]).abs().max()
                    / max(float(Jinv.abs().max()), 1e-300))
    qJ = 1 if spreadJ < 1e-12 else Jinv.shape[1]
    return Jinv[:, :qJ], W


def incidence(conn: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Node -> element-lane incidence [N, max count] int32 (lane = e * k +
    j of conn [M, k]), lanes ascending per node (a stable sort), padded
    with M * k (a zero row of the lane forces)."""
    flat = conn.reshape(-1).long()
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=n_nodes)
    starts = torch.cumsum(counts, 0) - counts
    node = flat[order]
    pos = torch.arange(flat.numel(), device=flat.device) - starts[node]
    inc = torch.full((n_nodes, max(int(counts.max()), 1)), flat.numel(),
                     dtype=torch.int32, device=flat.device)
    inc[node, pos] = order.to(torch.int32)
    return inc


class F64Operator:
    """Flat [N*3] f64 field -> flat [N*3] f64 forces (geometry-factor
    partial assembly, element chunks of `chunk_elems`, the scatter summed
    over ranges of `node_chunk` nodes, so that its gather holds at most
    node_chunk rows of the incidence at a time)."""

    node_chunk = 1 << 20

    def __init__(self, coords, conn, etype: str, E: float, nu: float,
                 chunk_elems: int = 1_000_000,
                 geometry_dtype=torch.float32, device=None, cache_path=None):
        from ..core.device import resolve_device
        from ..core.materials import lame_parameters
        from ..elements.tables import element_table

        dev = resolve_device(device)
        table = element_table(etype, "default")
        self.lam, self.mu = (float(x) for x in lame_parameters(E, nu))
        conn_t = torch.as_tensor(np.asarray(conn), device=dev).long()
        self.N = int(np.shape(coords)[0])
        M, k = conn_t.shape
        self.M, self.k = M, k
        self.dN = torch.as_tensor(np.asarray(table.dN, np.float64),
                                  device=dev)
        starts = list(range(0, M, chunk_elems))
        geom = _load_geometry(cache_path, chunk_elems, geometry_dtype,
                              [min(chunk_elems, M - c0) for c0 in starts])
        if geom is None:
            coords64 = torch.as_tensor(np.asarray(coords, np.float64),
                                       device=dev)
            w = torch.as_tensor(np.asarray(table.weights, np.float64),
                                device=dev)
            geom = []
            for c0 in starts:
                Jinv, W = device_geometry(
                    coords64, conn_t[c0:c0 + chunk_elems], self.dN, w)
                geom.append((Jinv.to(geometry_dtype), W.to(geometry_dtype)))
            del coords64
            if cache_path:
                _save_geometry(cache_path, chunk_elems, geom)
        self.chunks = [(c0, conn_t[c0:c0 + chunk_elems],
                        torch.as_tensor(J, device=dev),
                        torch.as_tensor(W, device=dev))
                       for c0, (J, W) in zip(starts, geom)]
        self.inc = incidence(conn_t, self.N)

    def __call__(self, u64f: torch.Tensor) -> torch.Tensor:
        u = u64f.reshape(self.N, 3)
        f64 = u64f.dtype
        lam, mu = self.lam, self.mu
        Fe_all = torch.zeros((self.M * self.k + 1, 3), dtype=f64,
                             device=u.device)
        dN = self.dN.to(f64)
        for c0, cc, Jinv, W in self.chunks:
            ue = u[cc]                                      # [Mc, k, 3]
            q = W.shape[1]
            Jq = Jinv.to(f64).expand(-1, q, -1, -1)         # [Mc, q, 3, 3]
            Hh = torch.einsum("qka,mkb->mqab", dN, ue)
            H = torch.einsum("mqij,mqjb->mqib", Jq, Hh)
            tr = H[..., 0, 0] + H[..., 1, 1] + H[..., 2, 2]
            sig = mu * (H + H.transpose(-1, -2))
            sig = sig + (lam * tr)[..., None, None] * torch.eye(
                3, dtype=f64, device=u.device)
            T = W.to(f64)[..., None, None] * torch.einsum(
                "mqij,mqib->mqjb", Jq, sig)
            Fe = torch.einsum("qkj,mqjb->mkb", dN, T)       # [Mc, k, 3]
            Fe_all[c0 * self.k:c0 * self.k + Fe.shape[0] * self.k] = \
                Fe.reshape(-1, 3)
        # each node's lanes summed in order, a range of nodes at a time
        F = torch.empty((self.N, 3), dtype=f64, device=u.device)
        for n0 in range(0, self.N, self.node_chunk):
            n1 = min(n0 + self.node_chunk, self.N)
            F[n0:n1] = Fe_all[self.inc[n0:n1].long()].sum(dim=1)
        return F.reshape(-1)


_CACHE_VERSION = 1


def _load_geometry(path, chunk_elems: int, dtype, sizes):
    """The stored geometry [(Jinv, W) per chunk] as host tensors, or None
    when there is no file, or it does not match (version, chunk_elems,
    dtype, chunk sizes), or it cannot be read: such a file is rebuilt."""
    if not path or not os.path.exists(path):
        return None
    npdt = torch.empty((), dtype=dtype).numpy().dtype
    try:
        with np.load(path) as z:
            if (int(z["version"]) != _CACHE_VERSION
                    or int(z["chunk_elems"]) != chunk_elems
                    or int(z["n_chunks"]) != len(sizes)):
                return None
            geom = []
            for ci, size in enumerate(sizes):
                J, W = z[f"J{ci}"], z[f"W{ci}"]
                if (J.dtype != npdt or W.dtype != npdt or J.ndim != 4
                        or J.shape[0] != size or J.shape[2:] != (3, 3)
                        or W.ndim != 2 or W.shape[0] != size
                        or J.shape[1] not in (1, W.shape[1])
                        or not (np.isfinite(J).all()
                                and np.isfinite(W).all())):
                    return None
                geom.append((torch.from_numpy(J), torch.from_numpy(W)))
            return geom
    except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
        return None                     # a torn or foreign file


def _save_geometry(path, chunk_elems: int, geom) -> None:
    """Write the geometry (atomically: a temporary file, then a rename)."""
    blobs = dict(version=np.asarray(_CACHE_VERSION),
                 chunk_elems=np.asarray(chunk_elems),
                 n_chunks=np.asarray(len(geom)))
    for ci, (J, W) in enumerate(geom):
        blobs[f"J{ci}"] = J.cpu().numpy()
        blobs[f"W{ci}"] = W.cpu().numpy()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)


class RefinedSystem:
    """PackedSystem (f32 inner solves) under an f64 true-residual loop.
    Wide fields are flat [N*3]; the inner solves exchange packed
    [Nb, 384] f32 tiles (PackedPlan.pack_flat / solve_chunked_packed)."""

    def __init__(self, system, coords, conn, etype: str, E: float,
                 nu: float, chunk_elems: int = 1_000_000,
                 geometry_dtype=torch.float32, cache_path=None):
        """cache_path: optional .npz file of the f64 operator's stored
        geometry (read when it matches, else built and written)."""
        self.system = system
        dev = system.mask.device
        self.op64 = F64Operator(coords, conn, etype, E, nu, chunk_elems,
                                geometry_dtype, device=dev,
                                cache_path=cache_path)
        self.plan = system.op.plan
        self._mask = self.plan.unpack_flat(system.pc.mask, torch.float32) > 0

    def _resid(self, u64f, b32f):
        F = self.op64(u64f)
        r = torch.where(self._mask, b32f.to(F.dtype) - F, 0.0)
        rn = torch.linalg.norm(r)
        # the normalized f32 correction RHS, packed
        bX = self.plan.pack_flat(r / rn, torch.float32)
        return rn, bX

    @spanned("refine.solve")
    def solve(self, b, tol_rel: float = 1e-6, inner_tol: float = 5e-3,
              inner_max_iter: int = 1500, every: int = 500,
              max_cycles: int = 10, progress=None):
        """b [N, 3] or flat [N*3] -> (u flat [N*3] f64, RefineInfo).

        Spans: refine.residual (each f64 residual and its read) and
        refine.inner (each inner solve); the rest of refine.solve is the
        refinement's own work."""
        dev = self._mask.device
        b32f = torch.where(self._mask,
                           torch.as_tensor(b, dtype=torch.float32,
                                           device=dev).reshape(-1), 0.0)
        bn = float(torch.linalg.norm(b32f.to(torch.float64)))
        count("host_syncs")
        u64f = torch.zeros(b32f.shape[0], dtype=torch.float64, device=dev)
        hist = []
        inner_total = 0
        cycles = 0
        for cycle in range(max_cycles):
            with span("refine.residual"):
                rn_t, bX = self._resid(u64f, b32f)
                rn = float(rn_t)
            count("host_syncs")
            hist.append(rn)
            if progress is not None:
                progress(cycle, inner_total, rn / bn)
            if rn <= tol_rel * bn or rn == 0.0:
                break
            cycles = cycle + 1
            # unit-norm RHS: the inner (absolute) tolerance is the same
            # in every cycle
            with span("refine.inner"):
                dX, info = self.system.solve_chunked_packed(
                    bX, tol=inner_tol, max_iter=inner_max_iter, every=every)
            inner_total += int(info.iterations)
            u64f = u64f + rn * self.plan.unpack_flat(dX, torch.float64)
        else:
            with span("refine.residual"):
                rn_t, _ = self._resid(u64f, b32f)
                hist.append(float(rn_t))
            count("host_syncs")
        rn = hist[-1]
        return u64f, RefineInfo(bool(rn <= tol_rel * bn), cycles,
                                inner_total, rn, rn / bn, np.asarray(hist))
