"""cg's fused iteration (solvers.cg_fused) on the CPU, against CGBlock.body.

The three kernels' plain versions run here on a small SPD system (a
diagonally dominant tridiagonal operator on 5,000 values, a 0/1 mask,
Jacobi), where a launch has several blocks and a ragged last tile.  Given
the body's scalars, u, r and p are bitwise the body's; the dots, summed
in the kernels' fixed order, agree with torch.sum within a few rounding
errors; whole solves end with the body's status and iteration count when
they converge inside a block, meet negative curvature or a NaN.  The
engagement rule is held case by case (on the CPU no block engages).
"""
import numpy as np
import pytest
import torch

from tpufem_torch.ops.packed import PackedConstraints
from tpufem_torch.parallel.dist import PartCGBlock, PartMesh
from tpufem_torch.solvers import cg as t_cg
from tpufem_torch.solvers import cg_fused as t_cf

N = 5000
DTYPES = [torch.float32, torch.float64]
# |fused dot - torch.sum| / |torch.sum| on this system (sums of 5,000
# positive products: a few roundings of the dtype)
DOT_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _system(dt, seed=0):
    """(A, b, mask, M_inv): A x = d x - x[i-1] - x[i+1] (d in [2.5, 6.5],
    SPD), about 5% of the values masked out."""
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(2.5 + 4.0 * rng.random(N), dtype=dt)
    mask = torch.as_tensor((rng.random(N) > 0.05).astype(np.float64),
                           dtype=dt)
    b = torch.as_tensor(rng.standard_normal(N), dtype=dt) * mask

    def A(x):
        y = d * x
        y[1:] -= x[:-1]
        y[:-1] -= x[1:]
        return y

    return A, b, mask, 1.0 / d


def _fused(block):
    """The block with the fused step, which only the card engages."""
    assert block.fused is None
    block.fused = t_cf.FusedStep(block, t_cf.pure_masks(block))
    return block


def _rel(a, b):
    return float(abs(a - b) / abs(b))


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_plain_step_bitwise_vs_body(dt):
    """One iteration from a state 7 iterations in: u, r and p bitwise the
    body's given the body's alpha and beta; pAp, rz and ||r|| within
    DOT_RTOL of torch.sum's; status, i and hblock as the body's."""
    A, b, mask, minv = _system(dt)
    cons = t_cg._MaskConstraint(mask)
    blk = t_cg.CGBlock(A, b, constraints=cons, M_inv=minv, tol=1e-30)
    blk.solve(b, max_iter=7)
    st = blk.state
    u, r, p, rz = (st.u.clone(), st.r.clone(), st.p.clone(),
                   st.rz.clone())
    # the body's iteration, written out: its scalars and vectors
    Ap = A(p)
    alpha = rz / (torch.sum(p * Ap) + blk.eps)
    u1 = (u + alpha * p) * mask
    r1 = (r - alpha * Ap) * mask
    z1 = r1 * minv
    rz1 = torch.sum(r1 * z1)
    beta = rz1 / (rz + blk.eps)
    p1 = (z1 + beta * p) * mask
    blk.body(1)
    assert torch.equal(st.u, u1) and torch.equal(st.r, r1)
    assert torch.equal(st.p, p1) and torch.equal(st.rz, rz1)
    want = {k: getattr(st, k).clone() for k in ("hlast", "status", "i")}
    want["h0"] = st.hblock[0].clone()
    # the fused step's kernels one by one, the body's scalars put in
    for k, v in (("u", u), ("r", r), ("p", p), ("rz", rz)):
        getattr(st, k).copy_(v)
    st.i.sub_(1)
    st.status.fill_(t_cg.RUNNING)
    fs = t_cf.FusedStep(blk, (mask, mask))
    t_cf.cg_pap(st.p, Ap, fs.part, fs.ctl, st.status, st.rz, fs.scal,
                blk.eps)
    assert _rel(fs.scal[t_cf.PAP], torch.sum(p * Ap)) <= DOT_RTOL[dt]
    assert _rel(fs.scal[t_cf.ALPHA], alpha) <= DOT_RTOL[dt]
    assert fs.ctl[t_cf.RUN] == 1 and fs.ctl[t_cf.KEEP] == 1
    fs.scal[t_cf.ALPHA] = alpha
    t_cf.cg_update_r(st.u, st.r, st.p, Ap, fs.minv, fs.ms, fs.mr, fs.part,
                     fs.ctl, st.status, st.rz, st.hlast, st.hblock, 0, st.i,
                     fs.scal, blk.eps, blk.tol, True)
    assert torch.equal(st.u, u1) and torch.equal(st.r, r1)
    assert _rel(st.rz, rz1) <= DOT_RTOL[dt]
    assert _rel(st.hlast, want["hlast"]) <= DOT_RTOL[dt]
    assert torch.equal(st.hblock[0], st.hlast)
    assert torch.equal(st.status, want["status"])
    assert torch.equal(st.i, want["i"])
    fs.scal[t_cf.BETA] = beta
    t_cf.cg_update_p(st.r, st.p, fs.minv, fs.mr, fs.ctl, fs.scal)
    assert torch.equal(st.p, p1)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_fused_dot_order(dt):
    """fused_dot is a sum of the products: exact on integers, and within
    DOT_RTOL of torch.sum on random values (several blocks and a ragged
    last tile)."""
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.integers(-8, 9, N).astype(np.float64), dtype=dt)
    c = torch.as_tensor(rng.integers(-8, 9, N).astype(np.float64), dtype=dt)
    assert t_cf.grid(N, dt) > 2 and N % t_cf.tile(dt)
    assert float(t_cf.fused_dot(a, c)) == float(torch.sum(a * c))
    a = torch.as_tensor(rng.random(N), dtype=dt)
    assert _rel(t_cf.fused_dot(a, a), torch.sum(a * a)) <= DOT_RTOL[dt]


class _NanAfter:
    """A with NaN in every apply from the `k`-th on."""

    def __init__(self, A, k):
        self.A, self.k, self.calls = A, k, 0

    def __call__(self, x):
        self.calls += 1
        y = self.A(x)
        return y * float("nan") if self.calls >= self.k else y


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["stop_in_block", "not_spd", "nan"])
def test_fused_solve_status_vs_body(dt, case):
    """Whole solves, the body against the fused step: the same status and
    iteration count, the history within DOT_RTOL (inf past the stop) and
    the answer close; the fused blocks counted."""
    A, b, mask, minv = _system(dt)
    tol = 1e-3 if dt == torch.float32 else 1e-9
    if case != "stop_in_block":
        tol = 0.0                       # only the failure stops the solve
    if case == "not_spd":
        # every 97th diagonal entry negative: indefinite; the curvature
        # goes negative after a few iterations
        d = 1.0 / minv
        d[::97] = -0.5

        def A(x, d=d):
            y = d * x
            y[1:] -= x[:-1]
            y[:-1] -= x[1:]
            return y
        minv = 1.0 / d.abs()

    def make():
        op = _NanAfter(A, 20) if case == "nan" else A
        return t_cg.CGBlock(op, b, constraints=t_cg._MaskConstraint(mask),
                            M_inv=minv, tol=tol)

    kw = dict(max_iter=300, return_state=True)
    want = make().solve(b, **kw)
    fused = _fused(make())
    from tpufem_torch.utils import profiling
    before = profiling.counters().get("cg.fused_blocks", 0)
    got = fused.solve(b, **kw)
    n = int(want[1].iterations)
    assert int(got[1].status) == int(want[1].status)
    assert int(got[1].iterations) == n
    status = {"stop_in_block": t_cg.CONVERGED, "not_spd": t_cg.NOT_SPD,
              "nan": t_cg.NAN_INF}[case]
    assert int(want[1].status) == status and n % t_cg.CHECK_EVERY
    assert (profiling.counters()["cg.fused_blocks"] - before
            == -(-n // t_cg.CHECK_EVERY))
    # a dropped step records the last norm again; inf from the stop on
    hw, hg = want[1].history, got[1].history
    assert torch.isinf(hg[n + 1:]).all() and torch.isinf(hw[n + 1:]).all()
    h_rel = ((hg[:n + 1] - hw[:n + 1]).abs() / hw[:n + 1]).max()
    assert float(h_rel) <= (1e-2 if dt == torch.float32 else 1e-9)
    u_rel = float((got[0] - want[0]).abs().max() / want[0].abs().max())
    assert u_rel <= (1e-2 if dt == torch.float32 else 1e-9)


def _packed_cons(spc=False, sets=False):
    pc = PackedConstraints(torch.ones(4, 384))
    if spc:
        pc.spc_const = torch.zeros(4, 384)
    if sets:
        pc.rbe2_slave = pc.rbe2_master = torch.zeros(1, dtype=torch.long)
    return pc


@pytest.mark.parametrize("case", [
    "packed", "mask", "spc_const", "sets", "callable_minv", "no_minv",
    "compensated", "f64_dots", "part_block", "odd_size"])
def test_engagement_rule(case):
    """pure_masks: a pure-mask PackedConstraints and cg's _MaskConstraint
    engage; SPC values, RBE sets, a callable or absent M^-1, other dots
    (compensated, a wider dtype, PartCGBlock's psum) and a size that is
    not a multiple of 4 do not.  On the CPU no block takes the step."""
    like = torch.zeros(4, 384)
    minv = torch.ones(4, 384)
    kw = dict(constraints=_packed_cons(), M_inv=minv)
    if case == "mask":
        kw["constraints"] = t_cg._MaskConstraint(torch.ones(4, 384))
    elif case in ("spc_const", "sets"):
        kw["constraints"] = _packed_cons(**{
            {"spc_const": "spc", "sets": "sets"}[case]: True})
    elif case == "callable_minv":
        kw["M_inv"] = lambda r: r * minv
    elif case == "no_minv":
        kw["M_inv"] = None
    elif case == "compensated":
        kw["dot_dtype"] = "compensated"
    elif case == "f64_dots":
        kw["dot_dtype"] = torch.float64
    elif case == "odd_size":
        like = torch.zeros(5, 3)
        kw = dict(constraints=t_cg._MaskConstraint(torch.ones(5, 3)),
                  M_inv=torch.ones(5, 3))
    if case == "part_block":
        blk = PartCGBlock(PartMesh(1, device="cpu"), lambda x: x,
                          like[None], constraints=t_cg._MaskConstraint(
                              torch.ones(1, 4, 384)),
                          M_inv=torch.ones(1, 4, 384))
    else:
        blk = t_cg.CGBlock(lambda x: x, like, **kw)
    masks = t_cf.pure_masks(blk)
    assert (masks is not None) == (case in ("packed", "mask"))
    if masks is not None:
        assert masks[0] is masks[1]
    assert blk.fused is None
