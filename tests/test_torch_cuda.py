"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked `cuda` and skips without a CUDA device (the
fixture decides, not the import).  The file imports neither jax nor
tpufem, so it runs on a machine that has only PyTorch, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py configures jax, hence --noconftest there.)
"""
import numpy as np
import pytest
import torch

import tpufem_torch
from tpufem_torch.ops import cluster_kernels as tck
from tpufem_torch.ops import fused_kernels as tfk
from tpufem_torch.ops import packed as tpp
from tpufem_torch.ops import packed_kernels as tpk
from tpufem_torch.ops import stiffness_kernels as tsk

E, NU = 200e9, 0.3
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def multi(cuda_device):
    """box_tet10(10): four cluster buckets and two block buckets."""
    coords, conn = tpufem_torch.meshgen.box_tet10(10, 10, 10)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=coords.shape[0],
        dtype=torch.float64, device=cuda_device)
    assert len(op.plan.meta.c_groups) > 1 and len(op.plan.meta.b_groups) > 1
    return coords, conn, op


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_kernels_bitwise_vs_plain(multi, cuda_device, dt):
    """Each kernel against its plain version on every bucket: bitwise (the
    kernels are built with -fmad=false and sum in the plain order)."""
    _, _, op = multi
    tp, m = op.plan, op.plan.meta
    lam, mu = op.lam_mu
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.standard_normal((m.n_blocks, 384)), dtype=dt,
                        device=cuda_device)
    for gi, (s, n, wk) in enumerate(m.c_groups):
        sl = slice(s, s + n)
        args = (X, tp.win_nodes[sl], tp.wslot[sl], tp.jslot[sl],
                tp.lconn[sl], tp.cinc[gi], op.Jinv[sl].to(dt),
                op.W[sl].to(dt), op.dN, lam, mu, m.cv_widths[gi])
        launches = tfk.FUSED_YC.launches
        got = tfk.fused_yc(*args, wk=wk)
        assert tfk.FUSED_YC.launches == launches + 1
        assert torch.equal(got, tfk.fused_yc_plain(*args, wk=wk))
        fe = torch.as_tensor(rng.standard_normal((n, 3, m.lanes)), dtype=dt,
                             device=cuda_device)
        launches = tpk.COMPRESS_GATHER.launches
        got = tpk.compress_gather(fe, tp.cinc[gi], m.cv_widths[gi])
        assert tpk.COMPRESS_GATHER.launches == launches + 1
        assert torch.equal(got, tpk.compress_gather_plain(fe, tp.cinc[gi],
                                                          m.cv_widths[gi]))
    Yc = torch.as_tensor(rng.standard_normal((m.n_clusters, 384)), dtype=dt,
                         device=cuda_device)
    for (s, n, wk) in m.b_groups:
        sl = slice(s, s + n)
        launches = tpk.COMBINE.launches
        wks = torch.full((n,), wk, dtype=torch.int32, device=cuda_device)
        got = tpk.combine(Yc, tp.winc[sl], tp.slotidx[sl], wks)
        assert tpk.COMBINE.launches == launches + 1
        assert torch.equal(got, tpk.combine_plain(Yc, tp.winc[sl],
                                                  tp.slotidx[sl], wks))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_combine_all_rows_and_edge_rows(multi, cuda_device, dt):
    """combine in one launch over all rows at their own widths (the plan's
    row_wk, as combine_stage calls it) bitwise against combine_plain and
    against the plain version bucket by bucket; and on a table with rows
    of width 0 and padded windows (winc == B) in the middle of rows, at
    per-row widths and at one width for all rows."""
    _, _, op = multi
    tp, m = op.plan, op.plan.meta
    rng = np.random.default_rng(8)
    Yc = torch.as_tensor(rng.standard_normal((m.n_clusters, 384)), dtype=dt,
                         device=cuda_device)
    launches = tpk.COMBINE.launches
    got = op.combine_stage(Yc)
    assert tpk.COMBINE.launches == launches + 1
    assert torch.equal(got, tpk.combine_plain(Yc, tp.winc, tp.slotidx,
                                              tp.row_wk))
    assert torch.equal(got, torch.cat([tpk.combine_plain(
        Yc, tp.winc[s:s + n], tp.slotidx[s:s + n], torch.full(
            (n,), wk, dtype=torch.int32, device=cuda_device))
        for (s, n, wk) in m.b_groups]))
    winc = tp.winc.clone()
    winc[::3, 1] = m.n_clusters                   # padded windows
    widths = tp.row_wk.clone()
    widths[::5] = 0                               # rows no cluster writes
    got = tpk.combine(Yc, winc, tp.slotidx, widths)
    assert bool((got[::5] == 0).all())
    assert torch.equal(got, tpk.combine_plain(Yc, winc, tp.slotidx, widths))
    for wk in (0, 1, m.win_c):
        wks = torch.full_like(widths, wk)
        assert torch.equal(tpk.combine(Yc, winc, tp.slotidx, wks),
                           tpk.combine_plain(Yc, winc, tp.slotidx, wks))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_c3d6_default_operator_on_card(cuda_device):
    """Repair: a default-built c3d6 operator runs the staged mode on the
    card (fused_yc has no (6, 6) instantiation) and equals its CPU path;
    an explicit fused mode for it raises at build."""
    coords, conn = tpufem_torch.meshgen.box_wedge(6, 5, 4)
    coords = coords.copy()
    coords[:, 0] += 0.04 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    N = coords.shape[0]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d6", E, NU, n_nodes=N, dtype=torch.float64,
        device=cuda_device)
    assert op.fuse == ""
    X = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (op.plan.meta.n_blocks, 384)), device=cuda_device)
    launches = tpk.EXPAND.launches
    F = op(X)
    assert tpk.EXPAND.launches > launches
    cpu = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d6", E, NU, plan=op.plan.to("cpu"),
        geometry=(op.Jinv.cpu(), op.W.cpu()), dtype=torch.float64,
        device="cpu")
    assert torch.equal(F.cpu(), cpu(X.cpu()))
    assert torch.equal(op.diagonal().cpu(), cpu.diagonal())
    for fuse in ("dense", "narrow"):
        with pytest.raises(ValueError, match="KERNEL_KQ"):
            tpufem_torch.PackedPartialOperator.build(
                coords, conn, "c3d6", E, NU, plan=op.plan, fuse=fuse,
                device=cuda_device)


@pytest.mark.cuda
def test_operator_on_card_matches_cpu(multi, cuda_device):
    """One f64 apply and the diagonal on the card (kernels) equal the CPU
    path (plain versions) on the same plan and geometry."""
    coords, conn, op = multi
    cpu = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=op.plan.to("cpu"),
        geometry=(op.Jinv.cpu().numpy(), op.W.cpu().numpy()),
        dtype=torch.float64, device="cpu")
    X = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (op.plan.meta.n_blocks, 384)))
    assert torch.equal(op(X.to(cuda_device)).cpu(), cpu(X))
    assert torch.equal(op.diagonal().cpu(), cpu.diagonal())


@pytest.mark.cuda
def test_default_device_is_the_card(cuda_device):
    coords, conn = tpufem_torch.meshgen.box_tet10(2, 2, 2)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=coords.shape[0])
    assert op.W.device.type == "cuda" and op.plan.device.type == "cuda"


STIFFNESS_MESHES = {"c3d4": ("box_tet", (5, 4, 3)),
                    "c3d10": ("box_tet10", (4, 3, 3)),
                    "c3d8": ("box_hex", (5, 4, 3)),
                    "c3d6": ("box_wedge", (5, 4, 3))}


@pytest.mark.cuda
@pytest.mark.parametrize("etype", list(STIFFNESS_MESHES))
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_stiffness_kernel_bitwise_vs_plain(cuda_device, etype, dt):
    """Each instantiation of K6 on a curved mesh whose element count is not
    a multiple of the kernel's elements per block (the ragged edge)."""
    gen, dims = STIFFNESS_MESHES[etype]
    coords, conn = getattr(tpufem_torch.meshgen, gen)(*dims)
    c = coords.copy()
    c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
    ct = torch.as_tensor(c, dtype=dt, device=cuda_device)
    launches = tsk.STIFFNESS_FUSED.launches
    got = tsk.stiffness_fused(ct, conn, etype, E, NU)
    assert tsk.STIFFNESS_FUSED.launches == launches + 1
    assert torch.equal(got, tpufem_torch.solid.stiffness(ct, conn, etype, E,
                                                         NU))
    want = tsk.stiffness_fused_plain(ct, conn, etype, E, NU)
    torch.cuda.synchronize()
    assert got.shape == (conn.shape[0], 3 * conn.shape[1], 3 * conn.shape[1])
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("etype", list(STIFFNESS_MESHES))
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_stiffness_kernel_edge_counts(cuda_device, etype, dt):
    """K6 at M = 1, at M one past a multiple of its elements per block, and
    at M = 0 (no launch); one launch per call otherwise."""
    gen, dims = STIFFNESS_MESHES[etype]
    coords, conn = getattr(tpufem_torch.meshgen, gen)(*dims)
    c = coords.copy()
    c[:, 0] += 0.04 * np.sin(2.0 * c[:, 1]) * c[:, 2]
    ct = torch.as_tensor(c, dtype=dt, device=cuda_device)
    k = conn.shape[1]
    q = tpufem_torch.element_table(etype).dN.shape[0]
    eb = tsk.elems_per_block(k, q, dt)
    ragged = (conn.shape[0] - 1) // eb * eb + 1
    assert eb < ragged <= conn.shape[0]
    for m in (1, ragged):
        launches = tsk.STIFFNESS_FUSED.launches
        got = tsk.stiffness_fused(ct, conn[:m], etype, E, NU)
        assert tsk.STIFFNESS_FUSED.launches == launches + 1
        want = tsk.stiffness_fused_plain(ct, conn[:m], etype, E, NU)
        torch.cuda.synchronize()
        assert got.shape == (m, 3 * k, 3 * k)
        assert torch.equal(got, want)
    launches = tsk.STIFFNESS_FUSED.launches
    got = tsk.stiffness_fused(ct, conn[:0], etype, E, NU)
    assert tsk.STIFFNESS_FUSED.launches == launches
    assert got.shape == (0, 3 * k, 3 * k) and got.device == ct.device


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_cluster_kernels_bitwise_vs_plain(cuda_device, dt):
    coords, conn = tpufem_torch.meshgen.box_tet10(6, 5, 4)
    plan = tpufem_torch.ClusterPlan.build(conn, coords.shape[0], 3,
                                          device=cuda_device)
    B, L = plan.n_clusters, plan.l_max
    lc = plan.lconn.reshape(B, -1)
    rng = np.random.default_rng(6)
    Uc = torch.as_tensor(rng.standard_normal((B, L, 3)), dtype=dt,
                         device=cuda_device)
    Fe = torch.as_tensor(rng.standard_normal((B, lc.shape[1], 3)), dtype=dt,
                         device=cuda_device)
    launches = tck.CLUSTER_EXPAND.launches
    got = tck.cluster_expand(lc, Uc)
    assert tck.CLUSTER_EXPAND.launches == launches + 1
    assert torch.equal(got, tck.cluster_expand_plain(lc, Uc))
    launches = tck.CLUSTER_COMPRESS.launches
    got = tck.cluster_compress(lc, Fe, L)
    assert tck.CLUSTER_COMPRESS.launches == launches + 1
    assert torch.equal(got, tck.cluster_compress_plain(lc, Fe, L))
    torch.cuda.synchronize()


# (B, R, L, lconn maker): edge cases of the in-cluster kernels; "wide" has
# more lanes than the first compress design's 48 KB of shared memory took
# in f64, "empty" no cluster at all
K7_CASES = {
    "one-slot": (6, 320, 128, lambda rng, B, R, L: np.full((B, R), 7)),
    "empty-slots": (9, 320, 128,
                    lambda rng, B, R, L: rng.integers(0, 30, (B, R)) * 4),
    "L40": (8, 320, 40, lambda rng, B, R, L: rng.integers(0, L, (B, R))),
    "R45": (5, 45, 128, lambda rng, B, R, L: rng.integers(0, L, (B, R))),
    "B1": (1, 320, 128, lambda rng, B, R, L: rng.integers(0, L, (B, R))),
    "B7": (7, 320, 128, lambda rng, B, R, L: rng.integers(0, L, (B, R))),
    "wide": (5, 4000, 128, lambda rng, B, R, L: rng.integers(0, L, (B, R))),
    "empty": (0, 320, 128, lambda rng, B, R, L: np.zeros((B, R))),
}
K7_ND = [1, 2, 3, 6]


def _k7_inputs(case, device, seed):
    B, R, L, make = K7_CASES[case]
    rng = np.random.default_rng(seed)
    lc = torch.as_tensor(make(rng, B, R, L).astype(np.int32), device=device)
    return B, R, L, lc, rng


@pytest.mark.cuda
@pytest.mark.parametrize("nd", K7_ND)
@pytest.mark.parametrize("case", list(K7_CASES))
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_cluster_compress_edge_cases(cuda_device, case, dt, nd):
    """The compress kernel's per-slot lists on edge cases, bitwise, for 1,
    2, 3 and 6 values per node: every lane in one slot, most slots empty,
    L < 128, R not a multiple of 32, B = 1, B not a multiple of the four
    clusters per block, R = 4000, no cluster."""
    B, R, L, lc, rng = _k7_inputs(case, cuda_device, 13)
    Fe = torch.as_tensor(rng.standard_normal((B, R, nd)), dtype=dt,
                         device=cuda_device)
    launches = tck.CLUSTER_COMPRESS.launches
    got = tck.cluster_compress(lc, Fe, L)
    assert tck.CLUSTER_COMPRESS.launches == launches + 1
    assert got.shape == (B, L, nd)
    assert torch.equal(got, tck.cluster_compress_plain(lc, Fe, L))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("nd", K7_ND)
@pytest.mark.parametrize("case", list(K7_CASES) + ["out-of-range"])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_cluster_expand_edge_cases(cuda_device, case, dt, nd):
    """The expand kernel on the same edge cases, bitwise, for 1, 2, 3 and
    6 values per node; "out-of-range" has lconn entries below 0 and at or
    above L, which read zero."""
    if case == "out-of-range":
        B, R, L = 7, 45, 40
        rng = np.random.default_rng(15)
        lc = torch.as_tensor(rng.integers(-3, L + 3, (B, R)).astype(
            np.int32), device=cuda_device)
    else:
        B, R, L, lc, rng = _k7_inputs(case, cuda_device, 15)
    Uc = torch.as_tensor(rng.standard_normal((B, L, nd)), dtype=dt,
                         device=cuda_device)
    launches = tck.CLUSTER_EXPAND.launches
    got = tck.cluster_expand(lc, Uc)
    assert tck.CLUSTER_EXPAND.launches == launches + 1
    assert got.shape == (B, R, nd)
    if case == "out-of-range":
        lcl = lc.long()
        ok = (lcl >= 0) & (lcl < L)
        want = torch.where(ok[..., None], tck.cluster_expand_plain(
            lcl.clamp(0, L - 1).int(), Uc), 0.0)
        assert bool((got[~ok] == 0).all())
    else:
        want = tck.cluster_expand_plain(lc, Uc)
    assert torch.equal(got, want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cluster_compress_limit_raises(cuda_device):
    """A cluster whose lanes exceed a block's shared memory raises, and so
    do more than 6 values per node (both kernels)."""
    lc = torch.zeros((1, 20000), dtype=torch.int32, device=cuda_device)
    Fe = torch.zeros((1, 20000, 3), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        tck.cluster_compress(lc, Fe, 128)
    lc = torch.zeros((2, 30), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="1 to 6 values per node"):
        tck.cluster_compress(lc, torch.zeros((2, 30, 7), device=cuda_device),
                             8)
    with pytest.raises(ValueError, match="1 to 6 values per node"):
        tck.cluster_expand(lc, torch.zeros((2, 8, 7), device=cuda_device))


K1_EDGE_MESHES = {"c3d10": ("box_tet10", (6, 5, 4)),
                  "c3d4": ("box_tet", (6, 5, 4)),
                  "c3d8": ("box_hex", (10, 8, 6))}


@pytest.mark.cuda
@pytest.mark.parametrize("etype", list(K1_EDGE_MESHES))
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("E_c", [32, 8], ids=["ec32", "ec8"])
def test_fused_yc_edge_buckets(cuda_device, etype, dt, E_c):
    """fused_yc on parts of the largest bucket, bitwise against its plain
    version: its last cluster, its last five and last three (an odd count:
    the last block holds fewer clusters than a block takes) and all but
    the first (the bucket starts with clusters that hold only padding);
    with window rows padded (== Nb) and slots emptied (wslot >= wk) by
    hand, and the second half of the first cluster's elements padded by
    hand (W = 0 at every point); all three (k, q), at 32 elements a
    cluster and at 8 (c3d4's 32 lanes, c3d8's 64 and c3d10's 80 end inside
    a 128-lane chunk; c3d10's 320 at 32 too; a warp then spans points and
    node halves)."""
    gen, dims = K1_EDGE_MESHES[etype]
    coords, conn = getattr(tpufem_torch.meshgen, gen)(*dims)
    coords = coords.copy()
    coords[:, 0] += 0.04 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, etype, E, NU, n_nodes=coords.shape[0], dtype=dt,
        elems_per_cluster=E_c, device=cuda_device)
    tp, m = op.plan, op.plan.meta
    jinv, w = op.cluster_geometry()
    lam, mu = op.lam_mu
    # the largest bucket of clusters over more than one window row (at 8
    # elements a cluster c3d4's largest bucket has one)
    wide = [g for g, (_, _, wk) in enumerate(m.c_groups) if wk > 1]
    gi = max(wide or range(len(m.c_groups)), key=lambda g: m.c_groups[g][1])
    s, n, wk = m.c_groups[gi]
    assert n >= 6 and wk > 1
    X = torch.as_tensor(np.random.default_rng(14).standard_normal(
        (m.n_blocks, 384)), dtype=dt, device=cuda_device)
    for lo, hi in ((n - 1, n), (n - 5, n), (n - 3, n), (1, n)):
        sl = slice(s + lo, s + hi)
        win, wsl = tp.win_nodes[sl].clone(), tp.wslot[sl].clone()
        win[:, wk - 1] = m.n_blocks              # a padded window row
        wsl[:, ::7] = wk                         # empty slots
        wp = w[sl].clone()
        wp[0, :, E_c // 2:] = 0                  # padded elements
        args = (X, win, wsl, tp.jslot[sl], tp.lconn[sl],
                tp.cinc[gi][lo:hi], jinv[sl], wp, op.dN, lam, mu,
                m.cv_widths[gi])
        launches = tfk.FUSED_YC.launches
        got = tfk.fused_yc(*args, wk=wk)
        assert tfk.FUSED_YC.launches == launches + 1
        assert got[-1].abs().max() > 0
        assert torch.equal(got, tfk.fused_yc_plain(*args, wk=wk))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_build_records_fused_yc_warps_per_sm(cuda_device, dt):
    """The operator's build on the card records fused_yc.warps_per_sm:
    the least over its cluster buckets of the blocks an SM times the warps
    a block; above the 12 warps (3 blocks) that c3d10 took in f32 when
    one thread held a whole element."""
    from tpufem_torch.utils import profiling
    coords, conn = tpufem_torch.meshgen.box_tet10(6, 5, 4)
    with profiling.recording() as rec:
        op = tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, n_nodes=coords.shape[0],
            dtype=dt, device=cuda_device)
    warps = rec.counts["fused_yc.warps_per_sm"]
    assert warps == tfk.warps_per_sm(dt, 10, 4, op.plan)
    assert warps % tfk.WARPS_PER_BLOCK == 0
    assert warps > (12 if dt == torch.float32 else 8)


@pytest.mark.cuda
def test_static_solve_on_card_matches_cpu(cuda_device):
    """The clustered static solve on the card (K6, K7a, K7b) against the
    CPU path (their plain versions): the same status, iterations within 3%
    and u to 1e-8 relative (the element GEMV sums in another order)."""
    coords, conn = tpufem_torch.meshgen.box_tet10(3, 3, 3)
    N = coords.shape[0]
    fixed = tpufem_torch.meshgen.boundary_nodes(coords, 2, 0.0)
    force = np.zeros((N, 6))
    force[tpufem_torch.meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    kw = dict(material={"E": E, "nu": NU}, c3d10=conn, operator="clustered",
              precondition=True, tol=1e-8 * float(np.linalg.norm(force)),
              max_iter=2000, dtype=torch.float64)
    counts = [K.launches for K in tpufem_torch.STATIC_KERNELS]
    ug, ig = tpufem_torch.static_structure_solver(coords, force, fixed,
                                                  device=cuda_device, **kw)
    assert all(K.launches > c for K, c in
               zip(tpufem_torch.STATIC_KERNELS, counts))
    uc, ic = tpufem_torch.static_structure_solver(coords, force, fixed,
                                                  device="cpu", **kw)
    assert int(ig.status) == int(ic.status) == 1
    assert abs(int(ig.iterations) - int(ic.iterations)) <= 0.03 * int(
        ic.iterations)
    assert float((ug.cpu() - uc).abs().max() / uc.abs().max()) <= 1e-8


@pytest.mark.cuda
def test_assembled_operator_and_stress_on_card(cuda_device):
    """MatrixFreeOperator, its diagonal and node_vm_stress on the card
    give the same result twice (no atomics) and agree with the CPU path to
    1e-12 relative in f64 (the GEMV and the sums run in another order)."""
    coords, conn = tpufem_torch.meshgen.box_tet10(4, 4, 4)
    N = coords.shape[0]
    rng = np.random.default_rng(8)
    u = torch.as_tensor(rng.standard_normal((N, 3)))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        ct = torch.as_tensor(coords, device=dev)
        K = tpufem_torch.solid.stiffness(ct, conn, "c3d10", E, NU)
        op = tpufem_torch.MatrixFreeOperator(
            K, tpufem_torch.ScatterPlan.build(conn, N, 3, device=dev))
        ud = u.to(dev)
        _, vm = tpufem_torch.solid.element_stress(
            ct, torch.as_tensor(conn, device=dev), ud * 1e-3, "c3d10", E, NU)
        res = (op(ud), op.diagonal(),
               tpufem_torch.solid.node_vm_stress(N, conn, vm))
        again = (op(ud), op.diagonal(),
                 tpufem_torch.solid.node_vm_stress(N, conn, vm))
        assert all(torch.equal(a, b) for a, b in zip(res, again))
        out[dev.type] = [r.cpu() for r in res]
    for g, c in zip(out["cuda"], out["cpu"]):
        assert float((g - c).abs().max() / c.abs().max()) <= 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_staged_kernels_bitwise_vs_plain(multi, cuda_device, dt):
    """expand, expand_planar and compress_planar against their plain
    versions on every bucket (planar arrays as row slices of one
    [3, k, B, E_c] array, as the planar pipeline passes them)."""
    _, _, op = multi
    tp, m = op.plan, op.plan.meta
    k, E_c = m.nodes_per_elem, m.elems_per_cluster
    rng = np.random.default_rng(9)
    X = torch.as_tensor(rng.standard_normal((m.n_blocks, 384)), dtype=dt,
                        device=cuda_device)
    fe3 = torch.as_tensor(rng.standard_normal((3, k, m.n_clusters, E_c)),
                          dtype=dt, device=cuda_device)
    ue3 = torch.zeros_like(fe3)
    for gi, (s, n, wk) in enumerate(m.c_groups):
        sl = slice(s, s + n)
        rows = (tp.win_nodes[sl], tp.wslot[sl], tp.jslot[sl], tp.lconn[sl])
        launches = tpk.EXPAND.launches
        got = tpk.expand(X, *rows, wk=wk)
        assert tpk.EXPAND.launches == launches + 1
        assert torch.equal(got, tpk.expand_plain(X, *rows, wk=wk))
        launches = tpk.EXPAND_PLANAR.launches
        tpk.expand_planar(X, *rows, k, E_c, wk=wk, out=ue3[:, :, sl])
        assert tpk.EXPAND_PLANAR.launches == launches + 1
        assert torch.equal(ue3[:, :, sl], tpk.expand_planar_plain(
            X, *rows, k, E_c, wk=wk))
        launches = tpk.COMPRESS_PLANAR.launches
        got = tpk.compress_planar(fe3[:, :, sl], tp.cinc[gi],
                                  m.cv_widths[gi])
        assert tpk.COMPRESS_PLANAR.launches == launches + 1
        assert torch.equal(got, tpk.compress_planar_plain(
            fe3[:, :, sl], tp.cinc[gi], m.cv_widths[gi]))
        lanes = tpp.planar_to_lanes(
            fe3[:, :, sl].contiguous(), m.lanes)
        assert torch.equal(got, tpk.compress_gather(lanes, tp.cinc[gi],
                                                    m.cv_widths[gi]))
    torch.cuda.synchronize()


def _random_bucket(rng, n, k, E_c, widths=None):
    """A random incidence table for n clusters of k * E_c element lanes:
    chunk g of the lanes gets a width (drawn from 0..6 unless given), and
    each of its n x 128 x width entries a byte 0 (unused) .. 128 (lane
    g * 128 + byte - 1; a lane past k * E_c reads 0), four bytes a word."""
    n_chunks = -(-k * E_c // 128)
    if widths is None:
        widths = [int(w) for w in rng.integers(0, 7, n_chunks)]
    total = sum(widths)
    Wp = -(-total // 4)
    b = np.zeros((n, 4 * Wp, 128), np.uint32)
    b[:, :total] = rng.integers(0, 129, (n, total, 128))
    words = b[:, 0::4] | b[:, 1::4] << 8 | b[:, 2::4] << 16 | b[:, 3::4] << 24
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32)), widths


def _check_compress_planar(fe3, cinc, widths):
    """K5b on fe3 (a planar array or a row slice of one) against its plain
    version and against K3 on the lane-major transpose: bitwise, one
    launch."""
    n = fe3.shape[2]
    launches = tpk.COMPRESS_PLANAR.launches
    got = tpk.compress_planar(fe3, cinc, widths)
    assert tpk.COMPRESS_PLANAR.launches == launches + 1
    assert torch.equal(got, tpk.compress_planar_plain(fe3, cinc, widths))
    lanes = tpp.planar_to_lanes(fe3.contiguous(), 128 * max(len(widths), 1))
    assert torch.equal(got, tpk.compress_gather(lanes, cinc, widths))
    torch.cuda.synchronize()
    assert got.shape == (n, 384)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("k", [4, 8, 10])
@pytest.mark.parametrize("E_c", [8, 16, 32])
def test_compress_planar_shapes(cuda_device, E_c, k, dt):
    """K5b for E_c in {8, 16, 32} and k in {4, 8, 10} on random tables, on
    a whole planar array and on a row slice of a larger one (n = 37: the
    last block holds one cluster)."""
    rng = np.random.default_rng(100 * E_c + k)
    n, B, s = 37, 61, 13
    cinc, widths = _random_bucket(rng, n, k, E_c)
    cinc = cinc.to(cuda_device)
    big = torch.as_tensor(rng.standard_normal((3, k, B, E_c)), dtype=dt,
                          device=cuda_device)
    sliced = _check_compress_planar(big[:, :, s:s + n], cinc, widths)
    whole = _check_compress_planar(big[:, :, s:s + n].contiguous(), cinc,
                                   widths)
    assert torch.equal(sliced, whole)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_compress_planar_edge_cases(cuda_device, dt):
    """K5b on a bucket whose chunks all have width 0 (zeros out), with a
    chunk of width 0 between others, with E_c = 2 and 1 (copies narrower
    than 16 bytes) on an odd row slice, and with one cluster."""
    rng = np.random.default_rng(11)
    dev = cuda_device
    fe3 = torch.as_tensor(rng.standard_normal((3, 10, 70, 32)), dtype=dt,
                          device=dev)
    cinc, widths = _random_bucket(rng, 9, 10, 32, widths=[0, 0, 0])
    assert cinc.shape[1] == 0
    got = _check_compress_planar(fe3[:, :, 5:14], cinc.to(dev), widths)
    assert not got.any()
    cinc, widths = _random_bucket(rng, 9, 10, 32, widths=[5, 0, 3])
    _check_compress_planar(fe3[:, :, 5:14], cinc.to(dev), widths)
    for E_c in (2, 1):
        fe = torch.as_tensor(rng.standard_normal((3, 10, 41, E_c)), dtype=dt,
                             device=dev)
        cinc, widths = _random_bucket(rng, 23, 10, E_c, widths=[6])
        _check_compress_planar(fe[:, :, 3:26], cinc.to(dev), widths)
    cinc, widths = _random_bucket(rng, 1, 10, 32)
    _check_compress_planar(fe3[:, :, 69:], cinc.to(dev), widths)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_expand_straddling_lanes(cuda_device, dt):
    """expand on an E_c = 24 plan (element lanes straddle the 128-lane
    chunks) and the staged operator on it against the CPU path."""
    coords, conn = tpufem_torch.meshgen.box_tet10(6, 5, 4)
    N = coords.shape[0]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, elems_per_cluster=24,
        dtype=dt, device=cuda_device)
    tp, m = op.plan, op.plan.meta
    assert op.fuse == "" and m.lanes == 256
    X = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (m.n_blocks, 384)), dtype=dt, device=cuda_device)
    assert torch.equal(op.expand_stage(X),
                       op.expand_stage(X, kernel=tpk.expand_plain))
    cpu = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, plan=tp.to("cpu"),
        geometry=(op.Jinv.cpu(), op.W.cpu()), dtype=dt, device="cpu")
    assert torch.equal(op(X).cpu(), cpu(X.cpu()))


K1_MESHES = {"c3d4": ("box_tet", (6, 5, 4)), "c3d8": ("box_hex", (6, 5, 4)),
             "c3d10": ("box_tet10", (4, 4, 3))}


@pytest.mark.cuda
@pytest.mark.parametrize("etype", list(K1_MESHES))
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("E_c", [32, 8], ids=["ec32", "ec8"])
def test_fused_yc_other_solids_bitwise(cuda_device, etype, dt, E_c):
    """fused_yc's (4, 1), (8, 8) and (10, 4) instantiations on curved
    meshes, every bucket, at 32 and 8 elements a cluster (at 8 each
    element's lanes end inside a 128-lane chunk)."""
    gen, dims = K1_MESHES[etype]
    coords, conn = getattr(tpufem_torch.meshgen, gen)(*dims)
    coords = coords.copy()
    coords[:, 0] += 0.04 * np.sin(2.0 * coords[:, 1]) * coords[:, 2]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, etype, E, NU, n_nodes=coords.shape[0], dtype=dt,
        elems_per_cluster=E_c, device=cuda_device)
    assert op.fuse == "dense"
    X = torch.as_tensor(np.random.default_rng(11).standard_normal(
        (op.plan.meta.n_blocks, 384)), dtype=dt, device=cuda_device)
    launches = tfk.FUSED_YC.launches
    got = op.fused_stage(X)
    assert tfk.FUSED_YC.launches > launches
    assert torch.equal(got, op.fused_stage(X, kernel=tfk.fused_yc_plain))


@pytest.mark.cuda
def test_staged_block_solve_on_card_matches_cpu(cuda_device):
    """The staged operator under block-Jacobi PCG on the card (expand,
    compress_gather, combine) against the CPU path (their plain versions):
    the same status, iterations within 3% and u to 1e-8 relative."""
    coords, conn = tpufem_torch.meshgen.box_tet10(3, 3, 3)
    N = coords.shape[0]
    fixed = tpufem_torch.meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[tpufem_torch.meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e3
    b /= np.linalg.norm(b)
    res = {}
    for dev in (cuda_device, torch.device("cpu")):
        op = tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, n_nodes=N, fuse="",
            dtype=torch.float64, device=dev)
        counts = [K.launches for K in (tpk.EXPAND, tpk.COMPRESS_GATHER,
                                       tpk.COMBINE)]
        system = tpufem_torch.PackedSystem(op, fixed_nodes=fixed,
                                           precondition="block")
        u, info = system.solve(b, tol=1e-9, max_iter=2000)
        if dev.type == "cuda":
            assert all(K.launches > c for K, c in zip(
                (tpk.EXPAND, tpk.COMPRESS_GATHER, tpk.COMBINE), counts))
        res[dev.type] = (u.cpu(), int(info.status), int(info.iterations))
    (ug, sg, ig), (uc, sc, ic) = res["cuda"], res["cpu"]
    assert sg == sc == 1 and abs(ig - ic) <= max(1, 0.03 * ic)
    assert float((ug - uc).abs().max() / uc.abs().max()) <= 1e-8


@pytest.mark.cuda
def test_probe_kernels_bitwise_vs_plain(cuda_device):
    """The five probe kernels against their plain versions: every relayout
    variant on a ragged tile count, row_accumulate with out-of-order and
    repeated indices, the planar write and read for three layouts (the
    padding lanes of the read zeroed)."""
    from tpufem_torch.ops import probe_kernels as pk

    rng = np.random.default_rng(12)
    f32 = dict(dtype=torch.float32, device=cuda_device)
    x = torch.as_tensor(rng.standard_normal((37, 64, 32)), **f32)
    for v in pk.FWD_VARIANTS:
        launches = pk.RELAYOUT_FWD.launches
        y = pk.relayout_fwd(x, v)
        assert pk.RELAYOUT_FWD.launches == launches + 1
        assert torch.equal(y, pk.relayout_fwd_plain(x, v))
        assert torch.equal(y, x.reshape(37, 16, 128))
    for v in pk.INV_VARIANTS:
        launches = pk.RELAYOUT_INV.launches
        got = pk.relayout_inv(x.reshape(37, 16, 128), v)
        assert pk.RELAYOUT_INV.launches == launches + 1
        assert torch.equal(got, pk.relayout_inv_plain(x.reshape(37, 16, 128),
                                                      v))
        assert torch.equal(got, x)
    src = torch.as_tensor(rng.standard_normal((3000, 384)), **f32)
    idx = torch.as_tensor(rng.integers(0, 3000, 128 * 19).astype(np.int32),
                          device=cuda_device)
    launches = pk.ROW_ACCUMULATE.launches
    got = pk.row_accumulate(src, idx)
    assert pk.ROW_ACCUMULATE.launches == launches + 1
    assert torch.equal(got, pk.row_accumulate_plain(src, idx))
    for k, E_c, B in ((10, 32, 77), (4, 32, 9), (10, 16, 50)):
        Rp = pk.planar_lanes(k, E_c)
        v = torch.as_tensor(rng.standard_normal((B, 3, Rp)), **f32)
        launches = (pk.PLANAR_WRITE.launches, pk.PLANAR_READ.launches)
        p = pk.planar_write(v, k, E_c)
        back = pk.planar_read(p)
        assert (pk.PLANAR_WRITE.launches, pk.PLANAR_READ.launches) == (
            launches[0] + 1, launches[1] + 1)
        assert torch.equal(p, pk.planar_write_plain(v, k, E_c))
        assert torch.equal(back, pk.planar_read_plain(p))
        assert torch.equal(back[:, :, :k * E_c], v[:, :, :k * E_c])
        assert not back[:, :, k * E_c:].any()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_probe_mains_on_card(cuda_device):
    """The three probes at small size on the card: every relayout candidate
    right, the row kernel equal to its plain version, the planar errors 0."""
    from tpufem_torch.ops import probe_planar_io, probe_reshape, probe_rowdma

    assert all(probe_reshape.main().values())
    assert probe_rowdma.main(5000, 128 * 64)["kernel_ms"] > 0
    res = probe_planar_io.main()
    assert res["write_err"] == res["read_err"] == 0.0
    assert set(res["ms"]) == {5, 45}


# ---------------------------------------------------------------------------
# the PCG blocks as CUDA graphs; the f64 refinement operator on the card
# ---------------------------------------------------------------------------

def _graph_system(dev, dt, precond="jacobi", sets=False):
    """box_tet10(4): the base fixed, or tpufem's constrained workload (SPC
    with a value, an RBE2 and an RBE3 set on the top face); a unit-norm
    packed load on the top face."""
    mg = tpufem_torch.meshgen
    coords, conn = mg.box_tet10(4, 4, 4)
    N = coords.shape[0]
    base = mg.boundary_nodes(coords, 2, 0.0)
    top = mg.boundary_nodes(coords, 2, 1.0)
    if sets:
        spc = [{"node": int(n), "dofs": [0, 1, 2], "value": 0.0}
               for n in base[:-2]]
        spc += [{"node": int(base[-2]), "dofs": [2], "value": 1e-4}]
        cons = tpufem_torch.Constraints.build(
            N, 3, spc,
            [{"master": int(top[0]), "slaves": [int(t) for t in top[1:4]],
              "dofs": [0, 1, 2]}],
            [{"master": int(top[-1]), "slaves": [int(t) for t in top[4:8]],
              "dofs": [0, 1, 2], "weights": [1.0, 2.0, 1.0, 0.5]}])
    else:
        cons = tpufem_torch.Constraints.fixed(N, base, 3)
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, dtype=dt, device=dev)
    system = tpufem_torch.PackedSystem(op, constraints=cons,
                                       precondition=precond)
    b = np.zeros((N, 3))
    b[top, 0], b[top, 2] = 2e3, -1e3
    bX = system.pc.project_residual(op.plan.pack(torch.as_tensor(
        b / np.linalg.norm(b), dtype=dt, device=dev)))
    return system, bX


def _same_cg(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    assert torch.equal(a[2][0], b[2][0]) and torch.equal(a[2][1], b[2][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("precond", ["jacobi", "block"])
@pytest.mark.parametrize("sets", [False, True], ids=["fixed", "sets"])
def test_graph_replay_bitwise_vs_eager(cuda_device, dt, precond, sets):
    """70 PCG iterations (two 32-iteration graphs and one of 6) replayed
    against the same block run eagerly: iterate, history, status, count
    and resume state bitwise; a second call replays the same graphs."""
    from tpufem_torch.solvers.cg import CGBlock
    system, bX = _graph_system(cuda_device, dt, precond, sets)
    mk = dict(constraints=system.pc, M_inv=system.M_inv, tol=0.0)
    kw = dict(max_iter=70, return_state=True)
    eager = CGBlock(system.op, bX, **mk)
    eager.graphed = False
    want = eager.solve(bX, **kw)
    blk = CGBlock(system.op, bX, **mk)
    assert blk.graphed
    _same_cg(blk.solve(bX, **kw), want)
    assert set(blk.graphs) == {32, 6}
    _same_cg(blk.solve(bX, **kw), want)
    assert bool(torch.isfinite(want[1].history).all())


@pytest.mark.cuda
def test_graph_launch_counts(cuda_device):
    """A capture launches nothing and keeps the counts; each replay adds
    the capture's launches (32 applies: K1 per cluster bucket, K2 once)."""
    from tpufem_torch.ops import cuda as tcu
    system, bX = _graph_system(cuda_device, torch.float32)
    c_buckets = sum(1 for (_, n, wk) in system.op.plan.meta.c_groups
                    if n and wk)
    blk = system._block(0.0, None)
    for t in (blk.state.u, blk.state.r, blk.state.p):
        t.copy_(bX)
    blk.state.rz.fill_(1.0)
    blk.state.status.zero_()
    before = [K.launches for K in tcu.REGISTRY]
    blk.capture(32)
    assert [K.launches for K in tcu.REGISTRY] == before
    counts = {K.name: n for K, n in blk.graphs[32].counts}
    assert counts == {"fused_yc": 32 * c_buckets, "combine": 32,
                      "cg_pap": 32, "cg_update_r": 32, "cg_update_p": 32}
    for reps in (1, 2, 3):
        k1, k2 = tfk.FUSED_YC.launches, tpk.COMBINE.launches
        r1 = tfk.FUSED_YC.replayed
        for _ in range(reps):
            blk.run(32)
        torch.cuda.synchronize()
        assert tfk.FUSED_YC.launches - k1 == reps * counts["fused_yc"]
        assert tfk.FUSED_YC.replayed - r1 == reps * counts["fused_yc"]
        assert tpk.COMBINE.launches - k2 == reps * 32


def _cg_operands(dev, dt, n, seed):
    """Random vectors [n] and the fused step's scalars on dev: u, r, p, w
    (Ap = w p), M^-1, the two masks, part, ctl, status, rz, hlast,
    hblock, i, scal."""
    from tpufem_torch.solvers import cg_fused as tcf
    g = torch.Generator().manual_seed(seed)

    def vec():
        return torch.randn(n, generator=g, dtype=dt).to(dev)

    def mask():
        return (torch.rand(n, generator=g) > 0.1).to(dt).to(dev)

    u, r, p = vec(), vec(), vec()
    w = 1.0 + torch.rand(n, generator=g, dtype=dt).to(dev)
    minv = torch.rand(n, generator=g, dtype=dt).to(dev)
    ms, mr = mask(), mask()
    sc = dict(dtype=dt, device=dev)
    return dict(u=u, r=r, p=p, w=w, Ap=p * w, minv=minv, ms=ms, mr=mr,
                part=torch.zeros(2 * tcf.grid(n, dt), **sc),
                ctl=torch.zeros(8, dtype=torch.int32, device=dev),
                status=torch.zeros((), dtype=torch.int32, device=dev),
                rz=torch.tensor(float(n), **sc),
                hlast=torch.tensor(7.0, **sc),
                hblock=torch.full((32,), -1.0, **sc),
                i=torch.full((), 5, dtype=torch.int32, device=dev),
                scal=torch.zeros(4, **sc))


def _cg_step(o, fns, j, record, one_mask):
    cg_pap, cg_update_r, cg_update_p = fns
    mr = o["ms"] if one_mask else o["mr"]
    o["Ap"] = o["p"] * o["w"]
    cg_pap(o["p"], o["Ap"], o["part"], o["ctl"], o["status"], o["rz"],
           o["scal"], 1e-30)
    cg_update_r(o["u"], o["r"], o["p"], o["Ap"], o["minv"], o["ms"], mr,
                o["part"], o["ctl"], o["status"], o["rz"], o["hlast"],
                o["hblock"], j, o["i"], o["scal"], 1e-30, 1e-3, record)
    cg_update_p(o["r"], o["p"], o["minv"], mr, o["ctl"], o["scal"])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("case", ["running", "two_masks", "no_record",
                                  "not_spd", "stopped", "converges"])
def test_cg_update_kernels_bitwise_vs_plain(cuda_device, dt, case):
    """cg_pap, cg_update_r and cg_update_p against their plain versions on
    the card, kernel by kernel and over three iterations: every vector,
    scalar, flag and history entry bitwise, on a ragged size (the last
    tile part full): a running step (one mask tensor or two, with and
    without the history), a step with negative curvature (dropped:
    NOT_SPD), a stopped block (nothing moves but hlast and hblock) and a
    step that converges."""
    from tpufem_torch.solvers import cg_fused as tcf
    n = 384 * 37 + 4
    kern = (tcf.cg_pap, tcf.cg_update_r, tcf.cg_update_p)
    plain = (tcf.cg_pap_plain, tcf.cg_update_r_plain, tcf.cg_update_p_plain)
    got, want = (_cg_operands(cuda_device, dt, n, 7) for _ in range(2))
    for o in (got, want):
        if case == "not_spd":
            o["w"].neg_()
        if case == "stopped":
            o["status"].fill_(1)
        if case == "converges":
            o["r"].mul_(1e-6)
            o["rz"].fill_(1e-14)
    launches = [K.launches for K in tpufem_torch.SOLVER_KERNELS]
    for j in range(3):
        kw = dict(j=j, record=case != "no_record",
                  one_mask=case != "two_masks")
        _cg_step(got, kern, **kw)
        _cg_step(want, plain, **kw)
        torch.cuda.synchronize()
        for k in got:
            if k != "part":
                assert torch.equal(got[k], want[k]), (j, k)
    assert [K.launches for K in tpufem_torch.SOLVER_KERNELS] == [
        x + 3 for x in launches]
    status = int(got["status"])
    assert status == {"not_spd": 3, "stopped": 1, "converges": 1}.get(
        case, 0)
    assert int(got["i"]) == 5 + {"stopped": 0, "not_spd": 1,
                                 "converges": 1}.get(case, 3)


def _fused_pair(dev, dt, tol):
    """box_tet10(8) f32 or f64, the base fixed, Jacobi: the system's
    (fused) CGBlock and an unfused one (the same M^-1 as a callable), and
    a unit-norm load."""
    from tpufem_torch.solvers.cg import CGBlock
    mg = tpufem_torch.meshgen
    coords, conn = mg.box_tet10(8, 8, 8)
    N = coords.shape[0]
    op = tpufem_torch.PackedPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, dtype=dt, device=dev)
    system = tpufem_torch.PackedSystem(
        op, fixed_nodes=mg.boundary_nodes(coords, 2, 0.0))
    b = np.zeros((N, 3))
    top = mg.boundary_nodes(coords, 2, 1.0)
    b[top, 0], b[top, 2] = 2e3, -1e3
    bX = system.pc.project_residual(op.plan.pack(torch.as_tensor(
        b / np.linalg.norm(b), dtype=dt, device=dev)))
    fused = system._block(tol, None)
    minv = system.M_inv
    plain = CGBlock(op, bX, constraints=system.pc,
                    M_inv=lambda r: r * minv, tol=tol)
    return fused, plain, bX


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_fused_solve_vs_body_on_card(cuda_device, dt):
    """The graphed fused solve against the unfused body on box_tet10(8):
    the same status, iterations within 1%, the first 50 history entries
    and the answer within 1e-10 relative in f64 (1e-3 in f32, where the
    dots' other order moves the recurrence more); a second fused solve
    repeats the first bitwise; the fused blocks counted, the unfused
    block's not."""
    from tpufem_torch.solvers import cg_fused as tcf
    from tpufem_torch.utils import profiling
    tol = 1e-4 if dt == torch.float32 else 1e-9
    fused, plain, bX = _fused_pair(cuda_device, dt, tol)
    assert fused.fused is not None and plain.fused is None
    c0 = profiling.counters()
    a = fused.solve(bX, max_iter=4000, return_state=True)
    c1 = profiling.counters()
    b = fused.solve(bX, max_iter=4000, return_state=True)
    want = plain.solve(bX, max_iter=4000)
    c2 = profiling.counters()
    _same_cg(a, b)
    n, nw = int(a[1].iterations), int(want[1].iterations)
    assert int(a[1].status) == int(want[1].status) == 1
    assert abs(n - nw) <= max(1, 0.01 * nw), (n, nw)
    blocks = -(-n // 32)
    assert c1["cg.fused_blocks"] - c0.get("cg.fused_blocks", 0) == blocks
    assert c2["cg.fused_blocks"] == c1["cg.fused_blocks"] + blocks
    for K in tpufem_torch.SOLVER_KERNELS:
        assert c1[f"launches.{K.name}"] - c0[f"launches.{K.name}"] == \
            32 * blocks
    rtol = 1e-10 if dt == torch.float64 else 1e-3
    h, hw = a[1].history[:50], want[1].history[:50]
    assert float(((h - hw).abs() / hw).max()) <= rtol
    u, uw = a[0], want[0]
    assert float((u - uw).abs().max() / uw.abs().max()) <= rtol


@pytest.mark.cuda
def test_warm_chunked_runs_no_kernel(cuda_device):
    """warm_chunked captures the chunk's blocks (32 and every % 32) and
    launches nothing; the chunked solve then equals an unwarmed system's
    bitwise."""
    from tpufem_torch.ops import cuda as tcu
    system, bX = _graph_system(cuda_device, torch.float32)
    before = [K.launches for K in tcu.REGISTRY]
    system.warm_chunked(None, tol=1e-4, every=50)
    torch.cuda.synchronize()
    assert [K.launches for K in tcu.REGISTRY] == before
    assert set(system._blocks[(1e-4, "None")].graphs) == {32, 18}
    u, info = system.solve_chunked_packed(bX, tol=1e-4, every=50,
                                          max_iter=2000)
    other, _ = _graph_system(cuda_device, torch.float32)
    u2, info2 = other.solve_chunked_packed(bX, tol=1e-4, every=50,
                                           max_iter=2000)
    assert int(info.status) == int(info2.status) == 1
    assert int(info.iterations) == int(info2.iterations) > 50
    assert torch.equal(u, u2)


@pytest.mark.cuda
def test_refine_geometry_on_card(cuda_device):
    """F64Operator's geometry and incidence computed on the card against
    the host numpy version (1e-14 relative, 1 ulp after rounding to f32;
    the incidence equal), its node-range sum bitwise equal to the single
    gather, and its apply against the CPU's to 1e-12."""
    from tpufem_torch.elements.tables import element_table
    from tpufem_torch.solvers import refine as trf
    coords, conn = tpufem_torch.meshgen.box_tet10(6, 6, 6)
    coords = coords + 0.02 * np.sin(3.0 * coords[:, [1, 2, 0]])
    N = coords.shape[0]
    table = element_table("c3d10", "default")
    dN = np.asarray(table.dN, np.float64)
    w = np.asarray(table.weights, np.float64)
    Jh, Wh = trf._host_geometry(coords, conn, dN, w)
    Jd, Wd = trf.device_geometry(
        torch.as_tensor(coords, device=cuda_device),
        torch.as_tensor(conn, device=cuda_device).long(),
        torch.as_tensor(dN, device=cuda_device),
        torch.as_tensor(w, device=cuda_device))
    for d, h in ((Jd.cpu().numpy(), Jh), (Wd.cpu().numpy(), Wh)):
        assert d.shape == h.shape
        assert np.abs(d - h).max() <= 1e-14 * np.abs(h).max()
        d32, h32 = d.astype(np.float32), h.astype(np.float32)
        assert np.abs(d32.view(np.int32).astype(np.int64)
                      - h32.view(np.int32).astype(np.int64)).max() <= 1
    inc_d = trf.incidence(torch.as_tensor(conn, device=cuda_device), N)
    inc_c = trf.incidence(torch.as_tensor(conn), N)
    assert inc_d.dtype == torch.int32 and torch.equal(inc_d.cpu(), inc_c)
    u = torch.as_tensor(np.random.default_rng(9).standard_normal(3 * N))
    kw = dict(chunk_elems=500)
    op = trf.F64Operator(coords, conn, "c3d10", E, NU, device=cuda_device,
                         **kw)
    op.node_chunk = N
    F = op(u.to(cuda_device))
    op.node_chunk = 1000
    assert torch.equal(op(u.to(cuda_device)), F)
    Fc = trf.F64Operator(coords, conn, "c3d10", E, NU, device="cpu", **kw)(u)
    assert float((F.cpu() - Fc).abs().max()) <= 1e-12 * float(Fc.abs().max())


# ---------------------------------------------------------------------------
# the rest of the solver family and the mixed system as CUDA graphs
# ---------------------------------------------------------------------------

def _same_info(a, b):
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_bicgstab_graph_bitwise_vs_eager(cuda_device, dt):
    """70 BiCGStab iterations (blocks of 32, 32 and 6) replayed as CUDA
    graphs against the same block run eagerly: iterate, history, status
    and count bitwise; a second solve replays the same graphs."""
    from tpufem_torch.solvers.bicgstab import BiCGStabBlock
    system, bX = _graph_system(cuda_device, dt)
    eager = BiCGStabBlock(system.op, bX, constraints=system.pc, tol=0.0)
    eager.graphed = False
    want = eager.solve(bX, max_iter=70)
    blk = BiCGStabBlock(system.op, bX, constraints=system.pc, tol=0.0)
    assert blk.graphed
    _same_info(blk.solve(bX, max_iter=70), want)
    assert set(blk.graphs) == {32, 6}
    _same_info(blk.solve(bX, max_iter=70), want)
    assert bool(torch.isfinite(want[1].history).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_gmres_cycle_graph_bitwise_vs_eager(cuda_device, dt):
    """Two GMRES(20) cycles, left-Jacobi, each cycle one CUDA graph
    replay, against the same cycles run eagerly: bitwise."""
    from tpufem_torch.solvers.gmres import GMRESCycle
    system, bX = _graph_system(cuda_device, dt)
    kw = dict(constraints=system.pc, M_inv=system.jacobi, tol=0.0,
              restart=20)
    eager = GMRESCycle(system.op, bX, **kw)
    eager.graphed = False
    want = eager.solve(bX, max_iter=40)
    cyc = GMRESCycle(system.op, bX, **kw)
    assert cyc.graphed
    _same_info(cyc.solve(bX, max_iter=40), want)
    assert set(cyc.graphs) == {20}
    _same_info(cyc.solve(bX, max_iter=40), want)
    assert int(want[1].iterations) == 40
    assert bool(torch.isfinite(want[1].history).all())


def _mixed_system(dev):
    """BASELINE config 3 at n = 3 on the card: the tets packed (K1-K3),
    the wedges (K6) and an s4 skin bridged; f64."""
    mg = tpufem_torch.meshgen
    n = 3
    coords, tets_all = mg.box_tet(n, n, n)
    _, wedges_all = mg.box_wedge(n, n, n)
    top = mg.boundary_nodes(coords, 2, 1.0)
    grid = top[np.lexsort((coords[top, 1], coords[top, 0]))].reshape(
        n + 1, n + 1)
    quads = np.asarray([[grid[i, j], grid[i + 1, j], grid[i + 1, j + 1],
                         grid[i, j + 1]]
                        for i in range(n) for j in range(n)], np.int32)
    blocks = dict(c3d4=tets_all[coords[tets_all].mean(axis=1)[:, 2] < 0.5],
                  c3d6=wedges_all[coords[wedges_all].mean(axis=1)[:, 2]
                                  > 0.5], s4=quads)
    mat = {"E": 200.0, "nu": NU, "membrane": (200.0, NU, 0.05),
           "bending": (200.0, NU, 0.05)}
    force = np.zeros((coords.shape[0], 6))
    force[top, 0], force[top, 2] = 0.01, -0.02
    return coords, blocks, mat, force, mg.boundary_nodes(coords, 2, 0.0)


@pytest.mark.cuda
def test_mixed_cgblock_graph_bitwise_vs_eager(cuda_device):
    """The mixed system's PCG block (packed primary, K6 wedges and the
    shell skin bridged through [N, 3] / [N, 6]) captured and replayed:
    bitwise equal to the eager block; and the solve on the card against
    the CPU's (1e-8 relative at a tolerance of 1e-12 ||b||)."""
    from tpufem_torch.solvers.cg import CGBlock
    coords, blocks, mat, force, fixed = _mixed_system(cuda_device)
    system = tpufem_torch.PackedMixedSystem(
        coords, blocks, mat, fixed_nodes=fixed, dtype=torch.float64,
        device=cuda_device)
    bX = system.pc.project_residual(system.pack6(force))
    mk = dict(constraints=system.pc, M_inv=system.M_inv, tol=0.0)
    kw = dict(max_iter=70, return_state=True)
    eager = CGBlock(system.op, bX, **mk)
    eager.graphed = False
    want = eager.solve(bX, **kw)
    blk = CGBlock(system.op, bX, **mk)
    k6 = tsk.STIFFNESS_FUSED.launches
    _same_cg(blk.solve(bX, **kw), want)
    assert tsk.STIFFNESS_FUSED.launches == k6      # K is built once
    counts = {K.name: n for K, n in blk.graphs[32].counts}
    assert counts["fused_yc"] > 0 and counts["combine"] > 0
    tol = 1e-12 * float(np.linalg.norm(force))
    ug, ig = system.solve(force, tol=tol, max_iter=3000)
    cpu = tpufem_torch.PackedMixedSystem(
        coords, blocks, mat, fixed_nodes=fixed, dtype=torch.float64,
        device="cpu")
    uc, ic = cpu.solve(force, tol=tol, max_iter=3000)
    assert int(ig.status) == int(ic.status) == 1
    assert float((ug.cpu() - uc).abs().max() / uc.abs().max()) <= 1e-8


@pytest.mark.cuda
def test_packed_constraints_comp3_on_card(cuda_device):
    """PackedConstraints.build(comp=0|3) on a plan on the card equals the
    build on the CPU, table by table, and enforces the same values (to
    1e-14: RBE3's row sums run in the card's reduction order)."""
    mg = tpufem_torch.meshgen
    coords, conn = mg.box_tet(3, 3, 3)
    N = coords.shape[0]
    top = mg.boundary_nodes(coords, 2, 1.0)
    cons = tpufem_torch.Constraints.build(
        N, 6, [{"node": 0, "dofs": [0, 4], "value": 0.5},
               {"node": 1, "dofs": [3, 4, 5], "value": 0.0}],
        [{"master": int(top[0]), "slaves": [int(t) for t in top[1:3]],
          "dofs": [1, 3, 5]}],
        [{"master": int(top[-1]), "slaves": [int(t) for t in top[3:6]],
          "dofs": [2, 4], "weights": [1.0, 2.0, 0.5]}])
    plans = {d: tpp.PackedPlan.build(coords, conn, N, device=d)
             for d in ("cpu", cuda_device)}
    u6 = torch.as_tensor(np.random.default_rng(6).standard_normal((N, 6)))
    for comp in (0, 3):
        pcs = {d: tpp.PackedConstraints.build(cons, plans[d], torch.float64,
                                              comp=comp) for d in plans}
        for name in ("mask", "spc_const", "rbe2_slave", "rbe2_master",
                     "rbe3_slave", "rbe3_weights", "rbe3_table",
                     "rbe3_master", "rbe3_wsum"):
            a, b = getattr(pcs["cpu"], name), getattr(pcs[cuda_device], name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert b.device.type == "cuda" and torch.equal(a, b.cpu())
        got = {d: plans[d].unpack(pcs[d].apply_state(plans[d].pack(
            u6[:, comp:comp + 3].to(d)))) for d in plans}
        assert torch.allclose(got[cuda_device].cpu(), got["cpu"],
                              rtol=1e-14, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_clustered_partial_on_card_bitwise_vs_plain(cuda_device, dt):
    """ClusteredPartialOperator on the card (K7a, K7b) against the same
    pipeline with the kernels' plain versions on the same tensors:
    bitwise, apply and diagonal."""
    from tpufem_torch.ops.partial import pa_apply_components
    coords, conn = tpufem_torch.meshgen.box_tet10(4, 4, 4)
    coords = coords + 0.01 * np.random.default_rng(7).standard_normal(
        coords.shape)
    N = coords.shape[0]
    op = tpufem_torch.ClusteredPartialOperator.build(
        coords, conn, "c3d10", E, NU, n_nodes=N, dtype=dt,
        device=cuda_device)
    p = op.plan
    B, L, E_c = p.n_clusters, p.l_max, p.elems_per_cluster
    lc = p.lconn.reshape(B, -1)
    u = torch.as_tensor(np.random.default_rng(8).standard_normal((N, 3)),
                        dtype=dt, device=cuda_device)
    ex, cp = tck.CLUSTER_EXPAND.launches, tck.CLUSTER_COMPRESS.launches
    got = op(u)
    assert tck.CLUSTER_EXPAND.launches == ex + 1
    assert tck.CLUSTER_COMPRESS.launches == cp + 1
    ue = tck.cluster_expand_plain(lc, u[p.l2g.long()])
    cols = pa_apply_components(
        tuple(ue[..., c].reshape(B * E_c, -1) for c in range(3)), op.Jinv,
        op.W, op.dN, *op.lam_mu)
    Fe = torch.stack([f.reshape(B, -1) for f in cols], dim=-1)
    want = p.combine(tck.cluster_compress_plain(lc, Fe, L).reshape(B * L, 3))
    assert torch.equal(got, want)
    d = op.diagonal()
    op.use_pallas = True
    assert torch.equal(d, op.diagonal())


def _hybrid_problem(device, dtype, **kw):
    mg = tpufem_torch.meshgen
    coords, conn = mg.box_tet(4, 4, 4)
    N = coords.shape[0]
    fixed = mg.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[mg.boundary_nodes(coords, 2, 1.0), 0] = 1e3
    b[fixed] = 0.0
    system = tpufem_torch.build_hybrid(coords, conn, "c3d4", E, NU, 6,
                                       fixed_nodes=fixed, dtype=dtype,
                                       device=device, **kw)
    return system, b


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, dict(precondition="bdd", slim=True,
                                         interior_inverse=True,
                                         matrix_free_gg=True)],
                         ids=["jacobi", "bdd_slim"])
def test_build_hybrid_on_card_vs_cpu(cuda_device, kw):
    """build_hybrid on the card (element stiffness by K6) against the same
    build on the CPU, f64: the tables equal, the blocks within 1e-12
    relative, the solves' displacements within 1e-10."""
    K6 = tsk.STIFFNESS_FUSED.launches
    sc, b = _hybrid_problem(cuda_device, torch.float64, **kw)
    assert tsk.STIFFNESS_FUSED.launches > K6
    sh, _ = _hybrid_problem("cpu", torch.float64, **kw)
    for name in ("gmap", "imap", "g_nodes"):
        assert torch.equal(getattr(sc, name).cpu(), getattr(sh, name))
    for name in ("scat_perm", "scat_seg"):
        assert np.array_equal(getattr(sc, name), getattr(sh, name))
    for name in ("chol", "K_IG", "K_GG", "Kinv", "Sinv", "Echol", "Minv_G"):
        a, c = getattr(sc, name), getattr(sh, name)
        assert (a is None) == (c is None), name
        if a is not None:
            assert float((a.cpu() - c).abs().max()
                         / c.abs().max().clamp(min=1e-300)) <= 1e-12, name
    uc, ic = sc.solve(b, tol=1e-6, max_iter=500)
    uh, ih = sh.solve(b, tol=1e-6, max_iter=500)
    assert int(ic.status) == int(ih.status) == 1
    assert float((uc.cpu() - uh).abs().max() / uh.abs().max()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_hybrid_interface_pcg_graph_bitwise_vs_eager(cuda_device, dt):
    """The interface PCG's block (the CGBlock that solve and solve_chunked
    share) replayed as CUDA graphs against the same block run eagerly: the
    histories and the interface solutions bitwise equal, and solve's
    history that of the graphed block."""
    from tpufem_torch.solvers.cg import CGBlock
    system, b = _hybrid_problem(cuda_device, dt, precondition="bdd",
                                slim=True, interior_inverse=True,
                                matrix_free_gg=True)
    _, g = system._condense(system._force(b))
    tol = 1e-6 * float(torch.linalg.norm(g))
    out = []
    for graphed in (True, False):
        blk = CGBlock(system.schur_matvec, g, M_inv=system.apply_M, tol=tol,
                      eps=1e-30)
        blk.graphed = graphed and blk.graphed
        u, info = blk.solve(g, max_iter=100)
        out.append((u, info.history, info.iterations))
    (u1, h1, i1), (u2, h2, i2) = out
    assert int(i1) == int(i2) > 0
    assert torch.equal(u1, u2) and torch.equal(h1, h2)
    _, info = system.solve(b, tol=tol, max_iter=100)
    assert torch.equal(info.history, h1)


def _workload(dev, bundle=None):
    """The SimJEB workload at c3d4 n = 3 in float64 from its arrays (the
    pipeline run_simjeb_workload runs after ingest; no h5 file, which this
    machine may not read): synthesized on `dev`, or run from `bundle`.
    Returns ((synthesis SolveInfo, arrays) or None, metrics)."""
    from tpufem_torch.utils.profiling import StageClock
    from tpufem_torch.workloads import simjeb
    prev = torch.get_default_dtype()
    tpufem_torch.enable_x64()
    try:
        stages = StageClock(dev)
        syn = None
        if bundle is None:
            *arrays, info = simjeb._synthesize_arrays(
                3, simjeb.SIMJEB_E, simjeb.SIMJEB_NU, dev, "c3d4", stages)
            syn = bundle = (info, arrays)
        coords, conn, rbe2, rbe3, _, u = bundle[1]
        outputs = np.zeros((coords.shape[0], 1, 6))
        outputs[:, 0, :3] = u
        m = simjeb._run_arrays(
            coords, conn, "c3d4", {"rbe2": rbe2, "rbe3": rbe3,
                                   "outputs": outputs},
            E=simjeb.SIMJEB_E, nu=simjeb.SIMJEB_NU, tol=1e-8, max_iter=2000,
            warm_start=False, dev=dev, out_path=None, verbose=False,
            stages=stages)
    finally:
        torch.set_default_dtype(prev)
    return syn, m


@pytest.mark.cuda
def test_workload_on_card_vs_cpu(cuda_device):
    """The workload on the card against the same calls on the CPU (f64).

    The PCG counts agree within one: the f64 dots reduce in another order
    on the card, and at this size a 1e-15 relative change of the right-
    hand side moves the last residuals by a few percent and the count
    across the 1e-8 tolerance (71 or 72 for the synthesis; measured on
    the CPU).  Both synthesized truths agree to 1e-9 (one iteration moves
    them 3.8e-10).  From the one CPU bundle, residual_zero and
    residual_truth (no solve) agree to 1e-9 of residual_zero; the solve's
    metrics within what one iteration moves them (measured on the CPU:
    residual_solve 6.5e-9 of residual_zero, equilibrium 3.5e-9, vm_max
    2.2e-10 relative): 1e-8."""
    cpu = torch.device("cpu")
    (gi, garr), _ = _workload(cuda_device)
    bundle, cm = _workload(cpu)
    ci, carr = bundle
    assert int(gi.status) == int(ci.status) == 1
    assert abs(int(gi.iterations) - int(ci.iterations)) <= 1
    gu, cu = garr[-1], carr[-1]
    np.testing.assert_allclose(gu, cu, rtol=0, atol=1e-9 * np.abs(cu).max())
    _, gm = _workload(cuda_device, bundle)
    assert gm["status"] == cm["status"] == 1
    assert abs(gm["iterations"] - cm["iterations"]) <= 1
    scale = cm["residual_zero"]
    for k in ("residual_zero", "residual_truth"):
        assert abs(gm[k] - cm[k]) <= 1e-9 * scale, k
    assert abs(gm["residual_solve"] - cm["residual_solve"]) <= 1e-8 * scale
    for k in ("vm_max", "equilibrium", "equilibrium_mean"):
        assert abs(gm[k] - cm[k]) <= 1e-8 * abs(cm[k]), k


@pytest.mark.cuda
def test_checkpointed_cg_on_card(cuda_device, tmp_path):
    """checkpointed_cg on a packed f64 system on the card: a first call
    stops at its iteration budget, a second resumes from the file and
    converges, within 1e-8 of a one-shot cg; the first call's count and
    saved state are the CPU's."""
    from tpufem_torch.solvers.cg import CONVERGED, MAX_ITER
    from tpufem_torch.utils import checkpoint
    coords, conn = tpufem_torch.meshgen.box_tet10(3, 3, 6, 1.0, 1.0, 2.0)
    N = coords.shape[0]
    fixed = tpufem_torch.meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[tpufem_torch.meshgen.boundary_nodes(coords, 2, 2.0), 0] = 1e3
    out = {}
    for i, dev in enumerate((cuda_device, torch.device("cpu"))):
        op = tpufem_torch.PackedPartialOperator.build(
            coords, conn, "c3d10", E, NU, n_nodes=N, dtype=torch.float64,
            device=dev)
        system = tpufem_torch.PackedSystem(op, fixed_nodes=fixed)
        bX = system.pc.project_residual(op.plan.pack(torch.as_tensor(
            b, device=dev)))
        kw = dict(constraints=system.pc, M_inv=system.M_inv,
                  tol=1e-11 * float(torch.linalg.norm(bX)))
        path = str(tmp_path / f"state_{i}")
        u1, i1, d1 = checkpoint.checkpointed_cg(op, bX, path, every=25,
                                                total_iter=50, **kw)
        assert d1 == 50 and int(i1.status) == MAX_ITER
        out[i] = u1.cpu()
        if i == 0:
            u2, i2, d2 = checkpoint.checkpointed_cg(op, bX, path, every=100,
                                                    total_iter=5000, **kw)
            assert int(i2.status) == CONVERGED and d2 > d1
            u_ref, _ = tpufem_torch.cg(op, bX, max_iter=5000, **kw)
            rel = float((u2 - u_ref).abs().max() / u_ref.abs().max())
            assert rel <= 1e-8, rel
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), rtol=0,
                               atol=1e-9 * float(out[1].abs().max()))


@pytest.fixture(scope="module")
def dist_part():
    """A PackedDistPartition of box_tet10(6, 6, 12) in 4 parts, 16
    elements a cluster (both exchanges run), f32, built on the CPU."""
    from tpufem_torch.parallel.packed_dist import PackedDistPartition
    coords, conn = tpufem_torch.meshgen.box_tet10(6, 6, 12)
    part = PackedDistPartition.build(coords, conn, "c3d10", E, NU, 4,
                                     dtype=torch.float32,
                                     elems_per_cluster=16, device="cpu")
    assert part.meta.x_rounds and part.meta.c_rounds
    return part


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_packed_dist_kernels_bitwise_vs_plain(cuda_device, dist_part, dt):
    """expand, compress_gather and combine on each part's remapped tables
    (local-ext rows, the scratch row, per-row combine widths) bitwise
    against their plain versions, and a whole PartMesh apply through the
    kernels bitwise against the same through the plain versions."""
    from tpufem_torch.parallel.dist import PartMesh
    from tpufem_torch.parallel.packed_dist import PackedHaloFEM
    fem = PackedHaloFEM(PartMesh(4, device=cuda_device), "parts", dist_part)
    m = dist_part.meta
    rng = np.random.default_rng(21)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                               device=cuda_device)

    for l in range(4):
        X = rand(m.Nbp + m.Gx + 1, 384)
        X[-1] = 0.0
        args = (X, fem.win_nodes[l], fem.wslot[l], fem.jslot[l],
                fem.lconn[l])
        assert torch.equal(tpk.expand(*args, wk=m.win_n),
                           tpk.expand_plain(*args, wk=m.win_n))
        fe = rand(m.Bp, 3, m.lanes)
        assert torch.equal(
            tpk.compress_gather(fe, fem.cinc[l], m.v_widths),
            tpk.compress_gather_plain(fe, fem.cinc[l], m.v_widths))
        Yc = rand(m.Bp + m.Gc + 1, 384)
        Yc[-1] = 0.0
        targs = (Yc, fem.winc[l], fem.slotidx[l], fem.wk[l])
        assert torch.equal(tpk.combine(*targs), tpk.combine_plain(*targs))
    if dt == torch.float32:
        X = rand(4 * m.Nbp, 384)
        launches = [K.launches for K in (tpk.EXPAND, tpk.COMPRESS_GATHER,
                                          tpk.COMBINE)]
        F = fem.spmv(X)
        assert [K.launches - n for K, n in zip(
            (tpk.EXPAND, tpk.COMPRESS_GATHER, tpk.COMBINE), launches)] \
            == [4, 4, 4]
        assert torch.equal(F, fem.spmv_with(X, tpk.expand_plain,
                                            tpk.compress_gather_plain,
                                            tpk.combine_plain))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_packed_dist_apply_on_card_matches_cpu(cuda_device, dist_part):
    """A PartMesh(4) packed apply on the card (kernels, f32) against the
    same on the CPU (plain versions), the same partition: within 1e-6
    relative; and the block-Jacobi PCG's first 64 iterations as CUDA
    graphs against the same blocks run eagerly, bitwise."""
    from tpufem_torch.parallel.dist import PartMesh
    from tpufem_torch.parallel.packed_dist import PackedHaloFEM
    card = PackedHaloFEM(PartMesh(4, device=cuda_device), "parts", dist_part)
    cpu = PackedHaloFEM(PartMesh(4, device="cpu"), "parts", dist_part)
    X = torch.as_tensor(np.random.default_rng(22).standard_normal(
        (4 * dist_part.meta.Nbp, 384)), dtype=torch.float32)
    F_card = card.spmv(X.to(cuda_device)).cpu()
    F_cpu = cpu.spmv(X)
    rel = float((F_card - F_cpu).abs().max() / F_cpu.abs().max())
    assert rel <= 1e-6, rel
    card.M_inv = card.block_jacobi_preconditioner()
    b = X.to(cuda_device)
    u_g, i_g = card.pcg(b, tol=0.0, max_iter=64)
    blk = next(iter(card._pcg.values()))
    assert blk.graphed and blk.graphs
    blk.graphed = False
    u_e, i_e = card.pcg(b, tol=0.0, max_iter=64)
    assert int(i_g.iterations) == int(i_e.iterations) == 64
    assert torch.equal(u_g, u_e) and torch.equal(i_g.history, i_e.history)


@pytest.mark.cuda
def test_graph_capture_failure_raises(cuda_device):
    """A block that reads a value on the host cannot be captured: the
    capture raises (nothing runs eagerly instead) and the launch counts
    stay as they were.  (Last in the file: a failed capture is left to
    the process's end.)"""
    from tpufem_torch.ops import cuda as tcu
    from tpufem_torch.solvers.cg import CGBlock
    system, bX = _graph_system(cuda_device, torch.float32)

    def syncing(x):
        float(x.sum())
        return system.op(x)

    blk = CGBlock(syncing, bX, constraints=system.pc, M_inv=system.M_inv)
    before = [K.launches for K in tcu.REGISTRY]
    with pytest.raises(RuntimeError):
        blk.capture(32)
    assert [K.launches for K in tcu.REGISTRY] == before
    assert not blk.graphs
