"""cg's iteration with its vector update fused into three kernels.

CGBlock (solvers/cg.py) runs each iteration as A(p) and then, in place of
its body's ~48 passes of torch operations over the state and its
one-element kernels for the status, three hand-written kernels
(csrc/cg_update.cu), each launched once an iteration inside the captured
block graph:

* ``cg_pap``: pAp = p.Ap, then alpha, bad_curv, bad_alpha and keep;
* ``cg_update_r``: u <- (u + alpha p) m_state, r <- (r - alpha Ap) m_res,
  rz1 = r.(M^-1 r) and r.r, then beta, the status, rz, hlast, hblock[j]
  and i;
* ``cg_update_p``: p <- (M^-1 r + beta p) m_res.

The scalars live on the device (``FusedStep.ctl``, ``.scal``) and follow
the body's where-rules exactly; only the dots' summation order differs
from ``torch.sum``.  That order is fixed: THREADS x ITEMS 16-byte vectors
a block, per-lane sums over the items, the lanes and the threads added by
halving, one partial a block, the partials summed by the last block to
finish (thread t those at t, t + THREADS, ...), the threads by halving.
The plain versions below follow it, so the kernels agree with them
bitwise; they are the CPU path of the wrappers and the kernels' oracle on
the card.

``CGBlock`` takes this step only when ``pure_masks`` finds a pure-mask
configuration and the block runs on the card; everything else keeps the
body.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops import cuda
from .cg import CONVERGED, NAN_INF, NOT_SPD, RUNNING

THREADS = 256       # threads a block (csrc/cg_update.cu kThreads)
ITEMS = 2           # 16-byte vectors a thread (kItems)

# ctl [8] int32: the iteration's flags (written by cg_pap) and the tickets
RUN, KEEP, BAD_CURV, BAD_ALPHA = range(4)
# scal [4] of the working dtype
ALPHA, BETA, PAP = range(3)

_REPLACES = "none: XLA fuses tpufem/solvers/cg.py:165 (the while_loop body)"
CG_PAP = cuda.CudaKernel(
    "cg_pap", "cg_update.cu", _REPLACES,
    {"tpufem_cg_pap": [cuda.I32, cuda.VP, cuda.VP, cuda.I64, cuda.VP,
                       cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.F64,
                       cuda.VP],
     "tpufem_cg_tile": [cuda.I32]})
CG_UPDATE_R = cuda.CudaKernel(
    "cg_update_r", "cg_update.cu", _REPLACES,
    {"tpufem_cg_update_r": [cuda.I32] + [cuda.VP] * 7 + [
        cuda.I64] + [cuda.VP] * 6 + [cuda.I32, cuda.VP, cuda.VP, cuda.F64,
                                     cuda.F64, cuda.I32, cuda.VP]})
CG_UPDATE_P = cuda.CudaKernel(
    "cg_update_p", "cg_update.cu", _REPLACES,
    {"tpufem_cg_update_p": [cuda.I32, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
                            cuda.I64, cuda.VP, cuda.VP, cuda.VP]})


def lanes(dtype) -> int:
    """Values in one 16-byte vector."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def tile(dtype) -> int:
    """Values a block takes."""
    return THREADS * ITEMS * lanes(dtype)


def grid(n: int, dtype) -> int:
    """Blocks of a launch over n values."""
    return -(-n // tile(dtype))


def _halve(x: torch.Tensor) -> torch.Tensor:
    """The last axis (a power of two) summed by halving."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def block_sums(prod: torch.Tensor) -> torch.Tensor:
    """Each block's partial [G] of the products `prod` (any shape, taken
    flat) in the kernels' order: value i of block b, thread t, item k,
    lane c is i = b * tile + (k * THREADS + t) * lanes + c; zeros past
    the end."""
    x = prod.reshape(-1)
    n, V = x.numel(), lanes(x.dtype)
    G = grid(n, x.dtype)
    x = torch.cat([x, x.new_zeros(G * tile(x.dtype) - n)])
    x = x.view(G, ITEMS, THREADS, V)
    a = x.new_zeros((G, THREADS, V))
    for k in range(ITEMS):
        a = a + x[:, k]
    return _halve(_halve(a))


def partials_sum(part: torch.Tensor) -> torch.Tensor:
    """The partials' sum as the last block takes it: thread t adds those
    at t, t + THREADS, ... in order from 0, then the threads by halving."""
    G = part.numel()
    M = -(-G // THREADS)
    x = torch.cat([part, part.new_zeros(M * THREADS - G)]).view(M, THREADS)
    acc = part.new_zeros(THREADS)
    for m in range(M):
        acc = acc + x[m]
    return _halve(acc)


def fused_dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """sum(a * c) in the kernels' order, a 0-d tensor of a's dtype."""
    return partials_sum(block_sums(a * c))


# ---------------------------------------------------------------------------
# plain versions (the kernels' signatures; no host read, so they run on the
# card too).  They leave `part` and the tickets alone.
# ---------------------------------------------------------------------------

def cg_pap_plain(p, Ap, part, ctl, status, rz, scal, eps: float) -> None:
    running = status == RUNNING
    pAp = fused_dot(p, Ap)
    bad_curv = (torch.abs(pAp) < eps) | (pAp < 0.0)
    alpha = rz / (pAp + eps)
    bad_alpha = torch.isnan(alpha) | torch.isinf(alpha)
    scal[PAP] = torch.where(running, pAp, scal[PAP])
    scal[ALPHA] = torch.where(running, alpha, scal[ALPHA])
    ctl[BAD_CURV] = torch.where(running, bad_curv.int(), ctl[BAD_CURV])
    ctl[BAD_ALPHA] = torch.where(running, bad_alpha.int(), ctl[BAD_ALPHA])
    ctl[RUN] = running.int()
    ctl[KEEP] = (running & ~bad_curv & ~bad_alpha).int()


def cg_update_r_plain(u, r, p, Ap, minv, ms, mr, part, ctl, status, rz,
                      hlast, hblock, j: int, i, scal, eps: float, tol: float,
                      record: bool) -> None:
    running, keep = ctl[RUN] != 0, ctl[KEEP] != 0
    alpha = scal[ALPHA]
    u1 = (u + alpha * p) * ms
    r1 = (r - alpha * Ap) * mr
    rz1 = fused_dot(r1, r1 * minv)
    rnorm = torch.sqrt(fused_dot(r1, r1))
    beta = rz1 / (rz + eps)
    bad_beta = torch.isnan(beta) | torch.isinf(beta)
    kept = torch.where(bad_beta, NAN_INF,
                       torch.where(rnorm < tol, CONVERGED, RUNNING))
    dropped = torch.where(ctl[BAD_CURV] != 0, NOT_SPD, NAN_INF)
    u.copy_(torch.where(keep, u1, u))
    r.copy_(torch.where(keep, r1, r))
    scal[BETA] = torch.where(keep, beta, scal[BETA])
    status.copy_(torch.where(keep, kept,
                             torch.where(running, dropped, status)))
    rz.copy_(torch.where(keep, rz1, rz))
    if record:
        hlast.copy_(torch.where(keep, rnorm, torch.where(
            running, hlast, float("inf"))))
        hblock[j] = hlast
    i.copy_(i + running.to(torch.int32))


def cg_update_p_plain(r, p, minv, mr, ctl, scal) -> None:
    p1 = (r * minv + scal[BETA] * p) * mr
    p.copy_(torch.where(ctl[KEEP] != 0, p1, p))


# ---------------------------------------------------------------------------
# wrappers: the plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------

def _check(name, vecs, ctl, ints, scalars, part=None):
    """The kernels' operands: vectors of one size (a positive multiple of
    4), 16-byte aligned and contiguous, of the scalars' dtype; the
    partials room for two sums a block; int32 flags and counters."""
    x = vecs[0]
    dev, dt, n = x.device, x.dtype, x.numel()
    part = () if part is None else (part,)
    cuda.check_cuda_args(name, dev, dt, floats=(*vecs, *part, *scalars),
                         ints=(ctl, *ints))
    for v in vecs:
        if v.numel() != n or v.data_ptr() % 16:
            raise ValueError(f"{name}: vectors of {n} values, 16-byte "
                             f"aligned; got {v.numel()} values, "
                             f"{v.data_ptr() % 16} bytes past alignment")
    if n <= 0 or n % 4:
        raise ValueError(f"{name}: a positive multiple of 4 values, got {n}")
    if (part and part[0].numel() < 2 * grid(n, dt)) or ctl.numel() < 8:
        raise ValueError(f"{name}: part needs {2 * grid(n, dt)} values, "
                         f"ctl 8")
    return int(dt == torch.float64), n


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {x.device}")
    return False


def cg_pap(p, Ap, part, ctl, status, rz, scal, eps: float) -> None:
    """pAp = p.Ap in the fixed order; when the status is RUNNING writes
    scal[PAP], scal[ALPHA] and ctl's flags, else clears ctl[RUN] and
    ctl[KEEP]."""
    if _on_cpu(p, "cg_pap"):
        return cg_pap_plain(p, Ap, part, ctl, status, rz, scal, eps)
    f64, n = _check("cg_pap", (p, Ap), ctl, (status,), (rz, scal), part)
    CG_PAP.launch("tpufem_cg_pap", f64, cuda.ptr(p), cuda.ptr(Ap), n,
                  cuda.ptr(part), cuda.ptr(ctl), cuda.ptr(status),
                  cuda.ptr(rz), cuda.ptr(scal), eps, cuda.stream(p))


def cg_update_r(u, r, p, Ap, minv, ms, mr, part, ctl, status, rz, hlast,
                hblock, j: int, i, scal, eps: float, tol: float,
                record: bool) -> None:
    """The step's u and r (when ctl[KEEP]), r.(M^-1 r) and r.r in the
    fixed order, and the iteration's status, rz, hlast, hblock[j], i and
    scal[BETA]."""
    if _on_cpu(u, "cg_update_r"):
        return cg_update_r_plain(u, r, p, Ap, minv, ms, mr, part, ctl,
                                 status, rz, hlast, hblock, j, i, scal, eps,
                                 tol, record)
    f64, n = _check("cg_update_r", (u, r, p, Ap, minv, ms, mr), ctl,
                    (status, i), (rz, hlast, hblock, scal), part)
    if not 0 <= j < hblock.numel():
        raise ValueError(f"cg_update_r: j {j} outside hblock")
    CG_UPDATE_R.launch(
        "tpufem_cg_update_r", f64, cuda.ptr(u), cuda.ptr(r), cuda.ptr(p),
        cuda.ptr(Ap), cuda.ptr(minv), cuda.ptr(ms), cuda.ptr(mr), n,
        cuda.ptr(part), cuda.ptr(ctl), cuda.ptr(status), cuda.ptr(rz),
        cuda.ptr(hlast), cuda.ptr(hblock), j, cuda.ptr(i), cuda.ptr(scal),
        eps, tol, int(record), cuda.stream(u))


def cg_update_p(r, p, minv, mr, ctl, scal) -> None:
    """p <- (M^-1 r + beta p) m_res when ctl[KEEP]."""
    if _on_cpu(p, "cg_update_p"):
        return cg_update_p_plain(r, p, minv, mr, ctl, scal)
    f64, n = _check("cg_update_p", (r, p, minv, mr), ctl, (), (scal,))
    CG_UPDATE_P.launch("tpufem_cg_update_p", f64, cuda.ptr(r), cuda.ptr(p),
                       cuda.ptr(minv), cuda.ptr(mr), n, cuda.ptr(ctl),
                       cuda.ptr(scal), cuda.stream(p))


# ---------------------------------------------------------------------------
# engagement and the step
# ---------------------------------------------------------------------------

def pure_masks(block) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(m_state, m_res) when `block`'s configuration allows the fused
    step, else None.  It does when: the dtype is float32 or float64; the
    dots are CGBlock's own (not a subclass's, such as parallel.dist's
    PartCGBlock with its per-part psum) in the state's dtype (dot_dtype
    None or that dtype); M_inv is a tensor of the state's shape and dtype;
    the constraints declare themselves pure masks (``masks()`` returns
    the state's and the residual's 0/1 masks: ops.packed.PackedConstraints
    without SPC values or sets, cg's _MaskConstraint), each of the state's
    shape and dtype; M_inv and the masks are contiguous and 16-byte
    aligned (the kernels' loads); and the state has a positive multiple
    of 4 values.
    The device is CGBlock's test (the step runs where the block is
    graphed, on the card)."""
    from .cg import CGBlock
    like = block.state.u

    def same(t):
        return (isinstance(t, torch.Tensor) and t.shape == like.shape
                and t.dtype == like.dtype and t.device == like.device
                and t.is_contiguous() and t.data_ptr() % 16 == 0)

    if (like.dtype not in (torch.float32, torch.float64)
            or type(block).vdot is not CGBlock.vdot
            or block.ddt != like.dtype or not same(block.M_inv)
            or like.numel() == 0 or like.numel() % 4):
        return None
    declare = getattr(block.constraints, "masks", None)
    masks = declare() if declare is not None else None
    if masks is None or not all(same(m) for m in masks):
        return None
    return masks


class FusedStep:
    """One CGBlock's fused iteration: the masks, M_inv and the scratch the
    kernels share (the partials, ctl, scal), held here so that the block's
    graphs keep valid addresses."""

    def __init__(self, block, masks):
        like = block.state.u
        self.minv = block.M_inv
        self.ms, self.mr = masks
        self.eps, self.tol, self.record = block.eps, block.tol, block.record
        dt, dev = like.dtype, like.device
        self.part = torch.zeros(2 * grid(like.numel(), dt), dtype=dt,
                                device=dev)
        self.ctl = torch.zeros(8, dtype=torch.int32, device=dev)
        self.scal = torch.zeros(4, dtype=dt, device=dev)
        if dev.type == "cuda":
            got = CG_PAP.lib().tpufem_cg_tile(int(dt == torch.float64))
            if got != tile(dt):
                raise RuntimeError(f"cg_update.cu: tile {got} (a negative "
                                   f"value is a CUDA error), expected "
                                   f"{tile(dt)}")

    def step(self, st, Ap: torch.Tensor, j: int) -> None:
        """Iteration j of the block on CGState st, given Ap = A(st.p)."""
        cg_pap(st.p, Ap, self.part, self.ctl, st.status, st.rz, self.scal,
               self.eps)
        cg_update_r(st.u, st.r, st.p, Ap, self.minv, self.ms, self.mr,
                    self.part, self.ctl, st.status, st.rz, st.hlast,
                    st.hblock, j, st.i, self.scal, self.eps, self.tol,
                    self.record)
        cg_update_p(st.r, st.p, self.minv, self.mr, self.ctl, self.scal)
