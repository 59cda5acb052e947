"""The port's staged packed pipeline against tpufem's.

tpufem's staged operator (fuse="": expand -> planar element math ->
compress_gather -> combine, interpret-mode Pallas kernels) is the oracle.
On the CPU each wrapper runs its plain PyTorch version:

* expand, expand_planar and compress_planar are pure gathers and
  fixed-order sums: bitwise against tpufem's kernels, every bucket, f32
  and f64, and compress_planar bitwise against compress_gather on the
  transposed input;
* the plan tables for elems_per_cluster 24 and 48 (element lanes straddle
  the 128-lane chunks) are bitwise equal to tpufem's;
* the staged apply and diagonal agree with tpufem's to 1e-12 relative in
  f64 and 1e-5 in f32 (XLA's CPU compiler contracts tpufem's element
  arithmetic; the port's is uncontracted), for E_c 32, 24 and 48;
* the planar pipeline (ops.probe_fused, "planar") is bitwise equal to the
  staged one;
* c3d4 and c3d8 fused operators (fused_yc's new instantiations) agree
  with tpufem's fuse="dense" operators.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import packed as j_packed
from tpufem.ops import packed_kernels as jpk
from tpufem.utils import meshgen

import tpufem_torch
from tpufem_torch.ops import fused_kernels as tfk
from tpufem_torch.ops import packed as t_packed
from tpufem_torch.ops import packed_kernels as tpk
from tpufem_torch.ops import probe_fused

E, NU = 200e9, 0.3
DTYPES = [(np.float32, torch.float32), (np.float64, torch.float64)]
PLAN_TABLES = ("win_nodes", "wslot", "jslot", "lconn", "winc", "slotidx",
               "new_from_old", "old_from_new", "esrc")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _plans(n, elems_per_cluster=32):
    coords, conn = meshgen.box_tet10(n, n, n)
    N = coords.shape[0]
    return (j_packed.PackedPlan.build(coords, conn, N, elems_per_cluster),
            t_packed.PackedPlan.build(coords, conn, N, elems_per_cluster,
                                      device="cpu"))


@pytest.fixture(scope="module")
def plans():
    """box_tet10(7) at E_c 32 (two cluster buckets) and 24."""
    return {ec: _plans(7, ec) for ec in (32, 24)}


def _window_rows(jp, X, s, n, wk):
    Xp = jnp.concatenate([jnp.asarray(X), jnp.zeros((1, 384), X.dtype)])
    return Xp[jp.win_nodes[s:s + n, :wk]]


@pytest.mark.parametrize("ec", [32, 24])
@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_expand_plain_bitwise(plans, ec, np_dt, t_dt):
    jp, tp = plans[ec]
    m = tp.meta
    if ec == 32:
        assert len(m.c_groups) > 1
    X = np.random.default_rng(0).standard_normal(
        (m.n_blocks, 384)).astype(np_dt)
    for s, n, wk in m.c_groups:
        sl = slice(s, s + n)
        want = np.asarray(jpk.expand(_window_rows(jp, X, s, n, wk),
                                     jp.wslot[sl], jp.jslot[sl],
                                     jp.lconn[sl], interpret=True))
        got = tpk.expand(torch.from_numpy(X), tp.win_nodes[sl], tp.wslot[sl],
                         tp.jslot[sl], tp.lconn[sl], wk=wk)
        assert got.shape == (n, 3, m.lanes)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_planar_kernels_plain_bitwise(plans, np_dt, t_dt):
    jp, tp = plans[32]
    m = tp.meta
    k, E_c = m.nodes_per_elem, m.elems_per_cluster
    rng = np.random.default_rng(1)
    X = rng.standard_normal((m.n_blocks, 384)).astype(np_dt)
    for gi, (s, n, wk) in enumerate(m.c_groups):
        sl = slice(s, s + n)
        want = np.asarray(jpk.expand_planar(
            _window_rows(jp, X, s, n, wk), jp.wslot[sl], jp.jslot[sl],
            jp.lconn[sl], k, E_c, interpret=True))
        got = tpk.expand_planar(torch.from_numpy(X), tp.win_nodes[sl],
                                tp.wslot[sl], tp.jslot[sl], tp.lconn[sl], k,
                                E_c, wk=wk)
        np.testing.assert_array_equal(got.numpy(), want)
        fe3 = rng.standard_normal((3, k, n, E_c)).astype(np_dt)
        want = np.asarray(jpk.compress_planar(jnp.asarray(fe3), jp.cinc[gi],
                                              m.cv_widths[gi],
                                              interpret=True))
        got = tpk.compress_planar(torch.from_numpy(fe3), tp.cinc[gi],
                                  m.cv_widths[gi])
        np.testing.assert_array_equal(got.numpy(), want)
        lanes = t_packed.planar_to_lanes(torch.from_numpy(fe3), m.lanes)
        assert torch.equal(got, tpk.compress_gather(lanes, tp.cinc[gi],
                                                    m.cv_widths[gi]))


@pytest.mark.parametrize("ec", [24, 48])
def test_plan_tables_bitwise(ec):
    jp, tp = _plans(3, ec)
    assert tp.meta.lanes == -(-10 * ec // 128) * 128
    assert tp.meta.c_groups == tuple(tuple(g) for g in jp.meta.c_groups)
    assert tp.meta.cv_widths == tuple(tuple(w) for w in jp.meta.cv_widths)
    assert tp.meta.b_groups == tuple(tuple(g) for g in jp.meta.b_groups)
    for name in PLAN_TABLES:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    for a, b in zip(tp.cinc, jp.cinc, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


STAGED_CASES = {"ec32-f64": (32, np.float64, torch.float64),
                "ec32-f32": (32, np.float32, torch.float32),
                "ec24-f64": (24, np.float64, torch.float64),
                "ec48-f64": (48, np.float64, torch.float64)}


@pytest.fixture(scope="module", params=list(STAGED_CASES))
def staged(request):
    """tpufem's staged operator, one apply and its diagonal (one jitted
    program) on box_tet10(3), and the port's plan for the same mesh."""
    ec, np_dt, t_dt = STAGED_CASES[request.param]
    coords, conn = meshgen.box_tet10(3, 3, 3)
    N = coords.shape[0]
    jp = j_packed.PackedPlan.build(coords, conn, N, ec)
    op = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords, np_dt), conn, "c3d10", E, NU, plan=jp,
        interpret=True, fuse="", dtype=np_dt)
    u = np.random.default_rng(2).standard_normal((N, 3)).astype(np_dt)
    X = np.array(jp.pack(jnp.asarray(u)))
    F, d = jax.jit(lambda o, x: (o(x), o.diagonal()))(op, jnp.asarray(X))
    return dict(coords=coords, conn=conn, ec=ec, t_dt=t_dt, X=X,
                tp=t_packed.PackedPlan.build(coords, conn, N, ec,
                                             device="cpu"),
                geometry=(np.array(op.Jinv), np.array(op.W)),
                F=np.asarray(F), d=np.asarray(d))


def test_staged_operator_matches_tpufem(staged):
    """The staged apply and diagonal against tpufem's: in f64 with the
    port's own geometry, in f32 with tpufem's planar geometry carried
    across (so only the order of the element arithmetic differs)."""
    t_dt = staged["t_dt"]
    f64 = t_dt == torch.float64
    ec = staged["ec"]
    # repair: an E_c that does not divide 128 builds; tpufem's default
    # rule then picks the staged mode, as fuse="" does explicitly
    op = tpufem_torch.PackedPartialOperator.build(
        staged["coords"], staged["conn"], "c3d10", E, NU, plan=staged["tp"],
        fuse=None if 128 % ec else "",
        geometry=None if f64 else staged["geometry"], dtype=t_dt,
        device="cpu")
    assert op.fuse == "" and op.Jinv.dim() == 4
    tol = 1e-12 if f64 else 1e-5
    X = torch.from_numpy(staged["X"])
    F = op(X)
    assert _rel(F.numpy(), staged["F"]) <= tol
    assert _rel(op.diagonal().numpy(), staged["d"]) <= tol
    if 128 % ec == 0:
        # the planar pipeline is the staged one without its transposes
        assert torch.equal(probe_fused.fused_apply(op, X, "planar"), F)


def test_fused_modes_need_e_c_dividing_128():
    coords, conn = meshgen.box_tet10(2, 2, 2)
    N = coords.shape[0]
    with pytest.raises(ValueError, match="divide 128"):
        tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, n_nodes=N, elems_per_cluster=24,
            fuse="dense", device="cpu")
    with pytest.raises(ValueError, match="fuse"):
        tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, n_nodes=N, fuse="wide",
            device="cpu")
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, elems_per_cluster=24,
        device="cpu")
    assert op.fuse == "" and op.plan.meta.lanes == 256
    with pytest.raises(ValueError, match="layout"):
        tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, plan=op.plan,
            geometry=(op.Jinv[0], op.W), device="cpu")


@pytest.mark.parametrize("np_dt,t_dt", DTYPES, ids=["f32", "f64"])
def test_staged_fused_planar_agree(np_dt, t_dt):
    """One plan, three cluster stages: staged, fused (geometry carried
    between the layouts) and planar; the planar one bitwise equal to the
    staged one, the fused one to roundoff."""
    coords, conn = meshgen.box_tet10(3, 3, 4)
    N = coords.shape[0]
    fused = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, dtype=t_dt, device="cpu")
    staged = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=fused.plan, fuse="",
        geometry=(fused.Jinv, fused.W), dtype=t_dt, device="cpu")
    assert fused.fuse == "dense" and staged.fuse == ""
    Jc, Wc = staged.cluster_geometry()
    assert torch.equal(Jc, fused.Jinv) and torch.equal(Wc, fused.W)
    X = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (fused.plan.meta.n_blocks, 384)).astype(np_dt))
    F = staged(X)
    tol = 1e-12 if t_dt == torch.float64 else 1e-5
    assert _rel(fused(X).numpy(), F.numpy()) <= tol
    assert torch.equal(probe_fused.fused_apply(staged, X, "planar"), F)
    assert torch.equal(probe_fused.fused_apply(staged, X, "dense"),
                       fused(X))
    assert torch.equal(staged.diagonal(), fused.diagonal())
    for a, b in zip(staged.block_diagonal(), fused.block_diagonal()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="mode"):
        probe_fused.fused_apply(staged, X, "narrow")


SOLIDS = {"c3d4": ("box_tet", (3, 3, 3)), "c3d8": ("box_hex", (4, 4, 3))}


@pytest.mark.parametrize("etype", list(SOLIDS))
def test_fused_other_solids_match_tpufem(etype):
    """Repair: c3d4 and c3d8 packed operators (fused_yc's (4, 1) and
    (8, 8) instantiations on the card) against tpufem's fuse="dense"
    operator, f64, curved mesh."""
    gen, dims = SOLIDS[etype]
    coords, conn = getattr(meshgen, gen)(*dims)
    coords = coords.copy()
    coords[:, 0] += 0.04 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    N = coords.shape[0]
    jp = j_packed.PackedPlan.build(coords, conn, N)
    op = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords), conn, etype, E, NU, plan=jp, interpret=True,
        fuse="dense")
    X = np.array(jp.pack(jnp.asarray(
        np.random.default_rng(4).standard_normal((N, 3)))))
    F, d = jax.jit(lambda o, x: (o(x), o.diagonal()))(op, jnp.asarray(X))
    top = tpufem_torch.PackedPartialOperator.build(
        coords, conn, etype, E, NU, n_nodes=N, dtype=torch.float64,
        device="cpu")
    q, k, _ = top.dN.shape
    assert (k, q) in tfk.KERNEL_KQ and top.fuse == "dense"
    assert _rel(top(torch.from_numpy(X)).numpy(), np.asarray(F)) <= 1e-12
    assert _rel(top.diagonal().numpy(), np.asarray(d)) <= 1e-12


def test_staged_wrappers_out_and_checks(plans):
    jp, tp = plans[32]
    m = tp.meta
    k, E_c = m.nodes_per_elem, m.elems_per_cluster
    s, n, wk = m.c_groups[0]
    sl = slice(s, s + n)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (m.n_blocks, 384)))
    rows = (tp.win_nodes[sl], tp.wslot[sl], tp.jslot[sl], tp.lconn[sl])
    ref = tpk.expand(X, *rows, wk=wk)
    buf = torch.full((n, 3, m.lanes), float("nan"), dtype=X.dtype)
    assert tpk.expand(X, *rows, wk=wk, out=buf) is buf
    assert torch.equal(buf, ref)
    with pytest.raises(ValueError):
        tpk.expand(X, *rows, wk=wk, out=torch.empty((n, 3, m.lanes)))
    with pytest.raises(ValueError):
        tpk.expand(X, *rows, wk=tp.win_nodes.shape[1] + 1)
    # a bucket's rows of a larger planar array, as input and as out
    full = torch.full((3, k, m.n_clusters, E_c), float("nan"),
                      dtype=X.dtype)
    view = full[:, :, sl]
    assert tpk.expand_planar(X, *rows, k, E_c, wk=wk, out=view) is view
    assert torch.equal(view, tpk.expand_planar(X, *rows, k, E_c, wk=wk))
    Yc = tpk.compress_planar(view, tp.cinc[0], m.cv_widths[0])
    assert torch.equal(Yc, tpk.compress_planar(view.contiguous(),
                                               tp.cinc[0], m.cv_widths[0]))
    with pytest.raises(ValueError):
        tpk.expand_planar(X, *rows, k, 24, wk=wk)
    with pytest.raises(ValueError):
        tpk.expand_planar(X, *rows, k, E_c, wk=wk,
                          out=torch.empty((3, k, E_c, n),
                                          dtype=X.dtype).transpose(2, 3))
    # a device with no kernel raises; it never falls back
    meta = [r.to("meta") for r in rows]
    Xm = X.to("meta")
    with pytest.raises(RuntimeError):
        tpk.expand(Xm, *meta, wk=wk)
    with pytest.raises(RuntimeError):
        tpk.expand_planar(Xm, *meta, k, E_c, wk=wk)
    with pytest.raises(RuntimeError):
        tpk.compress_planar(view.to("meta"), tp.cinc[0].to("meta"),
                            m.cv_widths[0])


def test_default_rule_runs_staged_without_an_instantiation():
    """Repair: the default rule picks the staged mode for an element whose
    (k, q) fused_yc is not built for (c3d6 (6, 6); c3d10 with the "full"
    rule (10, 11)), on every device; the c3d6 operator's apply and
    diagonal agree with tpufem's default (fused, interpret-mode) operator
    to <= 1e-12 relative in f64 (the same element arithmetic in another
    layout)."""
    coords, conn = meshgen.box_wedge(2, 2, 2)
    coords = coords.copy()
    coords[:, 0] += 0.04 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    N = coords.shape[0]
    jp = j_packed.PackedPlan.build(coords, conn, N)
    op = j_packed.PackedPartialOperator.build(
        jnp.asarray(coords), conn, "c3d6", E, NU, plan=jp, interpret=True)
    assert op.flags.fuse == "dense"
    X = np.array(jp.pack(jnp.asarray(
        np.random.default_rng(6).standard_normal((N, 3)))))
    F, d = jax.jit(lambda o, x: (o(x), o.diagonal()))(op, jnp.asarray(X))
    top = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d6", E, NU, n_nodes=N, dtype=torch.float64,
        device="cpu")
    q, k, _ = top.dN.shape
    assert (k, q) not in tfk.KERNEL_KQ and top.fuse == ""
    assert _rel(top(torch.from_numpy(X)).numpy(), np.asarray(F)) <= 1e-12
    assert _rel(top.diagonal().numpy(), np.asarray(d)) <= 1e-12
    # cluster-major geometry given to the constructor with fuse=None is
    # taken to the staged layout by the same rule
    Jc, Wc = top.cluster_geometry()
    again = tpufem_torch.PackedPartialOperator(top.plan, Jc, Wc, top.dN,
                                               *top.lam_mu)
    assert again.fuse == "" and torch.equal(again.Jinv, top.Jinv)
    c10, n10 = meshgen.box_tet10(2, 2, 2)
    full = tpufem_torch.PackedPartialOperator.build(
        c10, n10, "c3d10", E, NU, n_nodes=c10.shape[0], rule="full",
        device="cpu")
    assert full.dN.shape[:2] == (11, 10) and full.fuse == ""
