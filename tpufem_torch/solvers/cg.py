"""(Preconditioned) conjugate gradients with tpufem's status semantics.

tpufem runs the whole loop as one ``lax.while_loop``.  Here the loop runs
in blocks of ``CHECK_EVERY`` iterations (``CGBlock``) whose state stays on
the device: the status, rz and the norms are device scalars, and a
device-side ``running`` flag freezes the state (and the iteration count)
once the status leaves RUNNING, so the iterate and the count equal the
while_loop's.  The host reads the status only between blocks and at the
end; the iterations run after the stop and before the next read change
nothing.

A block takes and returns device tensors only (it updates a ``CGState`` in
place, and writes its part of the history into a block buffer that the
host copies out after it), so on a CUDA device each block length is
captured once as a CUDA graph and replayed (``ops.cuda.Graph``); on the
CPU the same block function runs eagerly.  A capture that fails raises.
GraphedBlock holds that capture-and-replay machinery for every solver
whose loop body runs this way (cg, bicgstab, gmres).

On the card a CGBlock whose M_inv is a tensor and whose constraints are a
pure mask (``solvers.cg_fused.pure_masks``) runs each iteration as A(p)
and three hand-written kernels (solvers.cg_fused, csrc/cg_update.cu) in
place of the body's torch operations: the same updates and status rules,
the dots summed in the kernels' fixed order.  Every other configuration,
and every block on the CPU, runs the body below.

dot_dtype="compensated" takes each dot product by comp_vdot (Dekker's
two-product and a two-sum cascade over contiguous halves, in b's dtype:
about twice its precision); masked_cg is cg with a 0/1 mask as its
constraints.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.profiling import count, span, spanned

# Status codes (tpufem.solvers.cg)
RUNNING = 0
CONVERGED = 1
MAX_ITER = 2
NOT_SPD = 3
NAN_INF = 4

# iterations between the host's reads of the status: one block
CHECK_EVERY = 32


class SolveInfo(NamedTuple):
    status: torch.Tensor          # int32 code
    iterations: torch.Tensor      # int32
    residual_norm: torch.Tensor   # final ||r||
    history: torch.Tensor         # [max_iter+1] ||r|| per iteration (inf padded)


def _noop(x):
    return x


def dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum(a * c) over all entries, a 0-d tensor (bicgstab's and gmres's
    dot; tpufem's jnp.vdot on real arrays)."""
    return torch.sum(a * c)


def _two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _two_prod(a, b):
    """Error-free product by Dekker's split (no FMA: each product and sum
    is its own torch op, which nothing contracts)."""
    p = a * b
    t = a * 4097.0
    ah = t - (t - a)
    al = a - ah
    t = b * 4097.0
    bh = t - (t - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def comp_vdot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Dot product with about twice the accuracy of the inputs' dtype, in
    that dtype (tpufem's comp_vdot): Dekker's two-product for the
    products, then a pairwise two-sum cascade over contiguous halves that
    carries the rounding errors in a low-order part.  Returns a 0-d
    tensor of a's dtype; the shapes, hence the cascade, are fixed, so a
    CUDA graph can capture it."""
    hi, lo = _two_prod(a.reshape(-1), c.reshape(-1))
    n = hi.shape[0]
    while n > 1:
        if n % 2:
            hi = torch.cat([hi, hi.new_zeros(1)])
            lo = torch.cat([lo, lo.new_zeros(1)])
            n += 1
        h = n // 2
        s, e = _two_sum(hi[:h], hi[h:])
        lo = lo[:h] + lo[h:] + e
        hi = s
        n = h
    return (hi + lo)[0]


class CGState:
    """The loop's state as device tensors that a block updates in place:
    u, r, p (shaped like b), rz, hlast (the last recorded ||r||), status
    and i (int32 scalars), and hblock [CHECK_EVERY], the history of the
    block just run."""

    __slots__ = ("u", "r", "p", "rz", "hlast", "status", "i", "hblock")

    def __init__(self, like: torch.Tensor):
        self.u = torch.empty_like(like)
        self.r = torch.empty_like(like)
        self.p = torch.empty_like(like)
        scal = dict(dtype=like.dtype, device=like.device)
        self.rz = torch.empty((), **scal)
        self.hlast = torch.empty((), **scal)
        self.hblock = torch.empty((CHECK_EVERY,), **scal)
        self.status = torch.empty((), dtype=torch.int32, device=like.device)
        self.i = torch.empty((), dtype=torch.int32, device=like.device)


class GraphedBlock:
    """A solver's loop body over state buffers that it updates in place:
    `run(n)` runs `body(n)`.  On a CUDA device each n is captured once as
    a CUDA graph (the graphs share one memory pool) and replayed;
    `capture(n)` captures without running anything.  A capture that fails
    raises.  CGBlock, solvers.bicgstab.BiCGStabBlock and
    solvers.gmres.GMRESCycle are such bodies.  `advance(n)` is the host's
    one crossing of a block boundary; it reads `status`, the body's int32
    device status, and names its spans after `kind`."""

    kind = ""

    def __init__(self, device: torch.device):
        self.graphed = device.type == "cuda"
        self.graphs = {}

    def body(self, n: int) -> None:
        raise NotImplementedError

    def capture(self, n: int) -> None:
        """Capture the n-step body as a CUDA graph (runs nothing); nothing
        on the CPU."""
        if self.graphed and n not in self.graphs:
            from ..ops.cuda import Graph
            pool = next(iter(self.graphs.values())).pool() \
                if self.graphs else None
            self.graphs[n] = Graph(lambda: self.body(n), pool=pool)

    def run(self, n: int) -> None:
        if not self.graphed:
            self.body(n)
            return
        self.capture(n)
        self.graphs[n].replay()

    def advance(self, n: int) -> bool:
        """Read the status (span <kind>.sync, counted in host_syncs); if it
        is RUNNING, run n steps (span <kind>.launch) and return True, else
        return False."""
        with span(self.kind + ".sync"):
            running = int(self.status) == RUNNING
        count("host_syncs")
        if not running:
            return False
        with span(self.kind + ".launch"):
            self.run(n)
        return True


class CGBlock(GraphedBlock):
    """cg's loop body: `run(n)` advances a CGState by n <= CHECK_EVERY
    iterations.  On a CUDA device each n is captured once as a CUDA graph
    over the state's buffers (the graphs share one memory pool) and
    replayed; `capture(n)` captures without running anything.  Every
    tensor the body reads (the operator's, the preconditioner's, the
    constraints') is held here, so the graphs' addresses stay valid.

    A capture cannot copy from the host, so the constraints' projections
    run once here, eagerly on `like`: whatever device tables they make at
    first use exist before any capture.  The configuration (A, the
    constraints, M_inv, tol, eps, the history, the dot dtype) lives here
    only: `solve` takes the right-hand side and the per-call options."""

    kind = "cg"

    def __init__(self, A: Callable, like: torch.Tensor, *, constraints=None,
                 M_inv=None, tol: float = 1e-10, eps: float = 1e-30,
                 record_history: bool = True, dot_dtype=None):
        self.A = A
        self.constraints = constraints
        self.M_inv = M_inv
        self.tol, self.eps = float(tol), float(eps)
        self.record = bool(record_history)
        self.dtype = like.dtype
        self.ddt = dot_dtype or like.dtype
        super().__init__(like.device)
        self.project = constraints.project_residual if constraints else _noop
        self.set_state = constraints.apply_state if constraints else _noop
        if M_inv is None:
            self.apply_M = _noop
        elif callable(M_inv):
            self.apply_M = M_inv
        else:
            self.apply_M = lambda r: r * M_inv  # noqa: E731
        self.project(like)
        self.set_state(like)
        self.state = CGState(like)
        self.status = self.state.status
        # on the card, a pure-mask configuration takes the fused step
        # (solvers.cg_fused): three kernels an iteration besides A(p)
        self.fused = None
        if self.graphed:
            from .cg_fused import FusedStep, pure_masks
            masks = pure_masks(self)
            if masks is not None:
                self.fused = FusedStep(self, masks)

    def run(self, n: int) -> None:
        count("cg.blocks")
        if self.fused is not None:
            count("cg.fused_blocks")
        super().run(n)

    def vdot(self, a, c):
        if isinstance(self.ddt, str) and self.ddt in ("compensated", "kahan"):
            return comp_vdot(a, c).to(self.dtype)
        return torch.sum(a.to(self.ddt) * c.to(self.ddt)).to(self.dtype)

    def body(self, n: int) -> None:
        """n iterations of the loop on the state, in place."""
        st = self.state
        if self.fused is not None:
            for j in range(n):
                self.fused.step(st, self.A(st.p), j)
            return
        A, project, set_state, apply_M, vdot = (
            self.A, self.project, self.set_state, self.apply_M, self.vdot)
        tol, eps = self.tol, self.eps
        u, r, p, rz, hlast, status, i = (st.u, st.r, st.p, st.rz, st.hlast,
                                         st.status, st.i)
        for j in range(n):
            running = status == RUNNING
            Ap = A(p)
            pAp = vdot(p, Ap)
            bad_curv = (torch.abs(pAp) < eps) | (pAp < 0.0)
            alpha = rz / (pAp + eps)
            bad_alpha = torch.isnan(alpha) | torch.isinf(alpha)

            u1 = set_state(u + alpha * p)
            r1 = project(r - alpha * Ap)
            z1 = apply_M(r1)
            rz1 = vdot(r1, z1)
            rnorm = torch.sqrt(vdot(r1, r1))
            beta = rz1 / (rz + eps)
            bad_beta = torch.isnan(beta) | torch.isinf(beta)
            p1 = project(z1 + beta * p)

            new_status = torch.where(
                bad_curv, NOT_SPD,
                torch.where(bad_alpha | bad_beta, NAN_INF,
                            torch.where(rnorm < tol, CONVERGED, RUNNING))
            ).to(torch.int32)
            # on a bad step keep the previous iterate; once stopped keep all
            take = (new_status != NOT_SPD) & ~bad_alpha
            keep = running & take
            u = torch.where(keep, u1, u)
            r = torch.where(keep, r1, r)
            p = torch.where(keep, p1, p)
            rz = torch.where(keep, rz1, rz)
            if self.record:
                hlast = torch.where(running, torch.where(take, rnorm, hlast),
                                    float("inf"))
                st.hblock[j] = hlast
            status = torch.where(running, new_status, status)
            i = i + running.to(torch.int32)
        for name, val in (("u", u), ("r", r), ("p", p), ("rz", rz),
                          ("hlast", hlast), ("status", status), ("i", i)):
            buf = getattr(st, name)
            if val is not buf:
                buf.copy_(val)

    @spanned("cg.solve")
    def solve(self, b: torch.Tensor, *, x0: Optional[torch.Tensor] = None,
              max_iter: int = 1000, resume_state=None,
              return_state: bool = False):
        """(P)CG on A u = b with this block's A, constraints, M_inv, tol,
        eps, history and dot dtype: the prologue eagerly, then blocks of
        CHECK_EVERY iterations (see cg).  A block kept by its caller serves
        many solves with the same graphs.

        Spans: cg.prologue, then for each block cg.sync (the host's read of
        the status, counted in host_syncs) and cg.launch (the block's graph
        replay; the block itself on the CPU): see GraphedBlock.advance."""
        dtype = b.dtype
        dev = b.device
        if b.shape != self.state.u.shape or dtype != self.dtype:
            raise ValueError(
                f"b {tuple(b.shape)} {dtype} does not match the block's "
                f"state {tuple(self.state.u.shape)} {self.dtype}")
        A, project, set_state, apply_M, vdot = (
            self.A, self.project, self.set_state, self.apply_M, self.vdot)
        tol, record = self.tol, self.record

        with span("cg.prologue"):
            u = set_state(torch.zeros_like(b) if x0 is None
                          else x0.to(dtype))
            r = project(b - A(u))
            z = apply_M(r)
            rz = vdot(r, z)
            if resume_state is None:
                p = z
            else:
                p_prev, rz_prev = resume_state
                rz_prev = torch.as_tensor(rz_prev, dtype=dtype, device=dev)
                p = torch.where(rz_prev > 0, project(p_prev.to(dtype)), z)

            hist = torch.full((max_iter + 1 if record else 1,),
                              float("inf"), dtype=dtype, device=dev)
            r0norm = torch.sqrt(vdot(r, r))
            if record:
                hist[0] = r0norm
            status = torch.where(r0norm < tol, CONVERGED,
                                 RUNNING).to(torch.int32)

            st = self.state
            for name, val in (("u", u), ("r", r), ("p", p), ("rz", rz),
                              ("hlast", r0norm), ("status", status)):
                getattr(st, name).copy_(val)
            st.i.zero_()
        for it in range(0, max_iter, CHECK_EVERY):
            n = min(CHECK_EVERY, max_iter - it)
            if not self.advance(n):
                break
            if record:
                hist[it + 1:it + 1 + n] = st.hblock[:n]

        status = torch.where(st.status == RUNNING, MAX_ITER,
                             st.status).to(torch.int32)
        u, r, p, rz = (st.u.clone(), st.r.clone(), st.p.clone(),
                       st.rz.clone())
        rnorm = torch.sqrt(vdot(r, r))
        info = SolveInfo(status, st.i.clone(), rnorm, hist)
        if return_state:
            return u, info, (p, rz)
        return u, info


def cg(A: Callable, b: torch.Tensor, *, constraints=None, M_inv=None,
       x0: Optional[torch.Tensor] = None, tol: float = 1e-10,
       max_iter: int = 1000, eps: float = 1e-30,
       record_history: bool = True, dot_dtype=None, resume_state=None,
       return_state: bool = False):
    """(P)CG on A u = b with constraint projection inside the loop.

    A: linear operator u -> A(u); constraints: object with apply_state /
    project_residual; M_inv: a Jacobi array broadcastable to b, or a
    callable r -> z; tol: absolute tolerance on ||r||; dot_dtype:
    accumulate the dot products in this dtype (vectors stay in b's).
    "compensated" (or "kahan") takes them by comp_vdot.
    resume_state=(p, rz) continues a previous call's recurrence exactly
    (rz <= 0 means a fresh start, p0 = z0); return_state=True also returns
    (p, rz) for the next call.  One CGBlock serves this call; a caller
    that solves many times keeps a CGBlock and calls its `solve`, so that
    its graphs are captured once.  Returns (u, SolveInfo)."""
    block = CGBlock(A, b, constraints=constraints, M_inv=M_inv, tol=tol,
                    eps=eps, record_history=record_history,
                    dot_dtype=dot_dtype)
    return block.solve(b, x0=x0, max_iter=max_iter,
                       resume_state=resume_state, return_state=return_state)


def cg_chunks(block: CGBlock, b: torch.Tensor, x0: torch.Tensor,
              max_iter: int, every: int):
    """PCG on `block` as chunks of min(every, max_iter - done) iterations,
    each resuming the last one's p and rz (the first starts fresh): one
    solve's trajectory while a chunk's true residual, which it starts
    from, agrees with the recurrence's.  Yields (u, info, done) after
    each chunk, done the iterations so far, and stops after a chunk that
    ended other than MAX_ITER or ran none.  Each chunk's count and status
    are read on the host (host_syncs)."""
    u = x0
    p = torch.zeros_like(b)                 # rz <= 0: a fresh start
    rz = torch.tensor(-1.0, dtype=b.dtype, device=b.device)
    done = 0
    while done < max_iter:
        u, info, (p, rz) = block.solve(
            b, x0=u, max_iter=min(every, max_iter - done),
            resume_state=(p, rz), return_state=True)
        it = int(info.iterations)
        done += it
        count("host_syncs", 2)              # the count and the status
        yield u, info, done
        if int(info.status) != MAX_ITER or it == 0:
            break


def chunk_history(chunks, progress=None):
    """Run cg_chunks' chunks, reading each one's history too (one more host
    read a chunk) and calling progress(done, the last ||r||) if given:
    (u, SolveInfo) with the total count and the chunks' histories
    joined."""
    hists, last = [], 0
    for u, info, done in chunks:
        h = info.history[:done - last + 1].cpu().numpy()
        hists.append(h if not hists else h[1:])
        last = done
        if progress is not None:
            progress(done, float(h[-1]))
        count("host_syncs")
    status = torch.where(info.status == RUNNING, MAX_ITER, info.status)
    return u, SolveInfo(status, torch.tensor(done), info.residual_norm,
                        np.concatenate(hists))


class _MaskConstraint:
    def __init__(self, mask):
        self.mask = mask

    def project_residual(self, r):
        return r * self.mask

    def apply_state(self, u):
        return u * self.mask

    def masks(self):
        """(m_state, m_res): this is a pure mask (solvers.cg_fused)."""
        return self.mask, self.mask


def masked_cg(A: Callable, b: torch.Tensor, mask, **kw):
    """cg with a 0/1 mask (a tensor broadcastable to b) in place of index
    assignment (tpufem's masked_cg): the state and the residual are
    multiplied by it."""
    return cg(A, b, constraints=_MaskConstraint(mask), **kw)
