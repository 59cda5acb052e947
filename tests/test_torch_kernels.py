"""The port's kernel modules against tpufem's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
those against tpufem's kernels in interpret mode on the same plan tables
and seeded inputs.  combine and compress_gather are pure adds in a fixed
order: bitwise.  fused_yc does the element arithmetic in _pa_planes'
order; XLA's CPU compiler may contract or reorder some of tpufem's
interpret-mode arithmetic, so it agrees to f32 (f64) roundoff, with the
tolerances stated below.  tests/test_torch_cuda.py holds each CUDA kernel
against its plain version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import fused_kernels as jfk
from tpufem.ops import packed as j_packed
from tpufem.ops import packed_kernels as jpk
from tpufem.utils import meshgen

from tpufem_torch.ops import fused_kernels as tfk
from tpufem_torch.ops import packed as t_packed
from tpufem_torch.ops import packed_kernels as tpk

E, NU = 200e9, 0.3
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plans(n):
    coords, conn = meshgen.box_tet10(n, n, n)
    N = coords.shape[0]
    return (coords, conn, j_packed.PackedPlan.build(coords, conn, N),
            t_packed.PackedPlan.build(coords, conn, N, device="cpu"))


@pytest.fixture(scope="module")
def multi():
    """box_tet10(10): four cluster buckets and two block buckets."""
    return _plans(10)


def _widths(n, wk):
    """One bucket's window width for each of its n rows."""
    return torch.full((n,), wk, dtype=torch.int32)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_combine_plain_bitwise(multi, np_dt, t_dt):
    _, _, jp, tp = multi
    m = tp.meta
    assert len(m.b_groups) > 1
    Yc = np.random.default_rng(0).standard_normal(
        (m.n_clusters, 384)).astype(np_dt)
    Ycp = jnp.concatenate([jnp.asarray(Yc), jnp.zeros((1, 384), np_dt)])
    for (s, n, wk) in m.b_groups:
        ycw = Ycp[jp.winc[s:s + n, :wk]]
        want = np.asarray(jpk.combine(ycw, jp.slotidx[s:s + n, :-(-wk // 4)],
                                      wk, interpret=True))
        got = tpk.combine(torch.from_numpy(Yc), tp.winc[s:s + n],
                          tp.slotidx[s:s + n], _widths(n, wk))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_combine_all_rows_bitwise(multi, np_dt, t_dt):
    """combine over all rows at once, each at its own width (the plan's
    row_wk: its bucket's width cut after its last real window), bitwise
    equal to combine bucket by bucket and to tpufem's kernel in interpret
    mode (the windows cut are padding, which adds nothing)."""
    _, _, jp, tp = multi
    m = tp.meta
    Yc = np.random.default_rng(2).standard_normal(
        (m.n_clusters, 384)).astype(np_dt)
    Ycp = jnp.concatenate([jnp.asarray(Yc), jnp.zeros((1, 384), np_dt)])
    want = np.concatenate([np.asarray(jpk.combine(
        Ycp[jp.winc[s:s + n, :wk]], jp.slotidx[s:s + n, :-(-wk // 4)], wk,
        interpret=True)) for (s, n, wk) in m.b_groups])
    bucket = torch.cat([tpk.combine(torch.from_numpy(Yc), tp.winc[s:s + n],
                                    tp.slotidx[s:s + n], _widths(n, wk))
                        for (s, n, wk) in m.b_groups])
    widths = tp.row_wk
    assert widths.dtype == torch.int32 and widths.shape == (m.n_blocks,)
    assert int(widths.sum()) < sum(n * wk for (_, n, wk) in m.b_groups)
    got = tpk.combine(torch.from_numpy(Yc), tp.winc, tp.slotidx, widths)
    assert torch.equal(got, bucket)
    np.testing.assert_array_equal(got.numpy(), want)
    op = t_packed.PackedPartialOperator.build(
        *multi[:2], "c3d10", E, NU, plan=tp, device="cpu")
    assert torch.equal(op.combine_stage(torch.from_numpy(Yc)), got)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_compress_gather_plain_bitwise(multi, np_dt, t_dt):
    _, _, jp, tp = multi
    m = tp.meta
    assert len(m.c_groups) > 1
    rng = np.random.default_rng(1)
    for gi, (s, n, _) in enumerate(m.c_groups):
        fe = rng.standard_normal((n, 3, m.lanes)).astype(np_dt)
        want = np.asarray(jpk.compress_gather(jnp.asarray(fe), jp.cinc[gi],
                                              m.cv_widths[gi],
                                              interpret=True))
        got = tpk.compress_gather(torch.from_numpy(fe), tp.cinc[gi],
                                  m.cv_widths[gi])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def fused_case():
    """One bucket of box_tet10(3) with tpufem's fuse="dense" geometry, a
    seeded X, and tpufem's interpret-mode fused_yc result per dtype."""
    coords, conn, jp, tp = _plans(3)
    N = coords.shape[0]
    out = {}
    for np_dt, t_dt in DTYPES:
        op = j_packed.PackedPartialOperator.build(
            jnp.asarray(coords, np_dt), conn, "c3d10", E, NU, plan=jp,
            interpret=True, fuse="dense", dtype=np_dt)
        X = np.random.default_rng(2).standard_normal(
            (tp.meta.n_blocks, 384)).astype(np_dt)
        s, n, wk = tp.meta.c_groups[0]
        Xp = jnp.concatenate([jnp.asarray(X), jnp.zeros((1, 384), np_dt)])
        lam, mu = op.lam_mu
        want = np.asarray(jfk.fused_yc(
            Xp[jp.win_nodes[s:s + n, :wk]], jp.wslot[s:s + n],
            jp.jslot[s:s + n], jp.lconn[s:s + n], jp.cinc[0],
            op.Jinv[s:s + n], op.W[s:s + n], op.dN.array, lam, mu,
            tp.meta.cv_widths[0], k=10, E_c=32, mode="dense",
            interpret=True))
        out[t_dt] = (X, np.array(op.Jinv), np.array(op.W),
                     np.asarray(op.dN.array), (lam, mu), want)
    return tp, out


# Every Yc entry is a sum of O(100) products of magnitude up to
# lam * |J^-1|^2 * W * |X|; a contracted FMA or reordered sum moves each by
# a few ulp of that scale, so the bound is relative to max|Yc| (measured:
# 6.8e-8 in f32, 2.5e-16 in f64).
@pytest.mark.parametrize("t_dt,tol", [(torch.float32, 1e-6),
                                      (torch.float64, 1e-13)],
                         ids=["f32", "f64"])
def test_fused_yc_plain_matches_tpufem(fused_case, t_dt, tol):
    tp, out = fused_case
    X, Jinv, W, dN, (lam, mu), want = out[t_dt]
    s, n, wk = tp.meta.c_groups[0]
    got = tfk.fused_yc(torch.from_numpy(X), tp.win_nodes[s:s + n],
                       tp.wslot[s:s + n], tp.jslot[s:s + n],
                       tp.lconn[s:s + n], tp.cinc[0],
                       torch.from_numpy(Jinv[s:s + n]),
                       torch.from_numpy(W[s:s + n]), dN, lam, mu,
                       tp.meta.cv_widths[0], wk=wk).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_planar_element_math_matches_tpufem():
    """pa_apply_planar / pa_diag_planar on random planes (f64)."""
    from tpufem.elements.tables import element_table
    dN = element_table("c3d10").dN
    rng = np.random.default_rng(3)
    ue = rng.standard_normal((3, 10, 5, 32))
    J = rng.standard_normal((4, 9, 5, 32))
    W = rng.random((4, 5, 32))
    lam, mu = 1.3, 0.7
    want = np.asarray(j_packed.pa_apply_planar(jnp.asarray(ue),
                                               jnp.asarray(J),
                                               jnp.asarray(W), dN, lam, mu))
    got = t_packed.pa_apply_planar(torch.from_numpy(ue), torch.from_numpy(J),
                                   torch.from_numpy(W), dN, lam, mu).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())
    want = np.asarray(j_packed.pa_diag_planar(jnp.asarray(J), jnp.asarray(W),
                                              dN, lam, mu))
    got = t_packed.pa_diag_planar(torch.from_numpy(J), torch.from_numpy(W),
                                  dN, lam, mu).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-14 * np.abs(want).max())


def test_wrappers_out_and_checks(fused_case):
    tp, out = fused_case
    X, Jinv, W, dN, (lam, mu), _ = out[torch.float32]
    s, n, wk = tp.meta.c_groups[0]
    args = (torch.from_numpy(X), tp.win_nodes[s:s + n], tp.wslot[s:s + n],
            tp.jslot[s:s + n], tp.lconn[s:s + n], tp.cinc[0],
            torch.from_numpy(Jinv[s:s + n]), torch.from_numpy(W[s:s + n]),
            dN, lam, mu, tp.meta.cv_widths[0])
    ref = tfk.fused_yc(*args, wk=wk)
    buf = torch.full((n, 384), float("nan"))
    assert tfk.fused_yc(*args, wk=wk, out=buf) is buf
    assert torch.equal(buf, ref)
    with pytest.raises(ValueError):
        tfk.fused_yc(*args, wk=wk, out=torch.empty((n + 1, 384)))
    with pytest.raises(ValueError):
        tfk.fused_yc(*args, wk=tp.win_nodes.shape[1] + 1)
    # a device with no kernel raises; it never falls back
    meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
    with pytest.raises(RuntimeError):
        tfk.fused_yc(*meta, wk=wk)
    Yc = torch.zeros((tp.meta.n_clusters, 384), device="meta")
    with pytest.raises(RuntimeError):
        tpk.combine(Yc, tp.winc.to("meta"), tp.slotidx.to("meta"),
                    tp.row_wk.to("meta"))
    fe = torch.zeros((n, 3, tp.meta.lanes), device="meta")
    with pytest.raises(RuntimeError):
        tpk.compress_gather(fe, tp.cinc[0].to("meta"), tp.meta.cv_widths[0])
    with pytest.raises(ValueError):
        tpk.compress_gather(torch.zeros((n, 3, 128)), tp.cinc[0],
                            tp.meta.cv_widths[0])
