"""The API that tpufem has and the port lacked until now, against tpufem:
core.voigt.stress_vector, solid.stiffness's `fused` keyword (None: the
port's routing rule, True: the fused kernel, False: the B^T D B pipeline)
and native.block_windows (the unpacked block-window tables, bitwise on
the cluster-slot tables of tests/test_torch_plan.py's plans)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpufem
import tpufem.native as j_native
from tpufem.elements import solid as j_solid
from tpufem.utils import meshgen

import tpufem_torch as tt
import tpufem_torch.native as t_native
from tpufem_torch.elements import solid as t_solid
from tpufem_torch.ops import packed as t_packed
from tpufem_torch.ops import stiffness_kernels as t_sk

E, NU = 200e9, 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(3, 3), (7, 3, 3), (4, 5, 3, 3)])
def test_stress_vector_matches_tpufem(shape):
    rng = np.random.default_rng(len(shape))
    t = rng.standard_normal(shape)
    got = tt.stress_vector(torch.as_tensor(t))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(tpufem.stress_vector(
                                      jnp.asarray(t))))
    assert got.shape == shape[:-2] + (6,)
    # the inverse of stress_tensor on symmetric tensors
    v = torch.as_tensor(rng.standard_normal(shape[:-2] + (6,)))
    assert torch.equal(tt.stress_vector(tt.stress_tensor(v)), v)


def _curved(gen, *dims):
    coords, conn = gen(*dims)
    rng = np.random.default_rng(3)
    return coords + 0.02 * rng.standard_normal(coords.shape), conn


MESHES = {
    "c3d4": lambda: _curved(meshgen.box_tet, 2, 2, 2),
    "c3d10": lambda: _curved(meshgen.box_tet10, 1, 2, 1),
    "c3d8": lambda: _curved(meshgen.box_hex, 2, 1, 2),
    "c3d6": lambda: _curved(meshgen.box_wedge, 1, 2, 1),
    "c3d20": lambda: _curved(lambda *d: meshgen.hex8_to_hex20(
        *meshgen.box_hex(*d)), 1, 1, 2),
}


@pytest.mark.parametrize("etype", list(MESHES))
def test_stiffness_fused_keyword(etype):
    """fused=False is stiffness_bmat (bitwise) and tpufem's fused=False
    (1e-12 relative, f64); fused=True is K6's plain version (bitwise on
    the CPU) where K6 is built, and raises where it is not; fused=None
    keeps the port's routing (K6 for k <= 10 at the default rule)."""
    coords, conn = MESHES[etype]()
    ct, et = torch.as_tensor(coords), torch.as_tensor(conn)
    bmat = t_solid.stiffness_bmat(ct, et, etype,
                                  tt.elasticity_matrix(E, NU))
    K_false = t_solid.stiffness(ct, et, etype, E, NU, fused=False)
    assert torch.equal(K_false, bmat)
    K_j = np.asarray(j_solid.stiffness(jnp.asarray(coords), jnp.asarray(conn),
                                       etype, E, NU, fused=False))
    np.testing.assert_allclose(K_false.numpy(), K_j, rtol=0,
                               atol=1e-12 * np.abs(K_j).max())
    K_none = t_solid.stiffness(ct, et, etype, E, NU)
    if etype == "c3d20":
        assert torch.equal(K_none, bmat)
        with pytest.raises(ValueError, match="stiffness_fused"):
            t_solid.stiffness(ct, et, etype, E, NU, fused=True)
        return
    K_true = t_solid.stiffness(ct, et, etype, E, NU, fused=True)
    assert torch.equal(K_true, t_sk.stiffness_fused_plain(ct, et, etype, E,
                                                          NU))
    assert torch.equal(K_none, K_true)
    np.testing.assert_allclose(K_true.numpy(), K_j, rtol=0,
                               atol=1e-12 * np.abs(K_j).max())
    # a rule without a K6 instantiation: None goes to B^T D B
    rule = "reduced" if etype in ("c3d10", "c3d8") else None
    if rule:
        assert torch.equal(
            t_solid.stiffness(ct, et, etype, E, NU, rule=rule),
            t_solid.stiffness(ct, et, etype, E, NU, rule=rule, fused=False))


@pytest.fixture(scope="module", params=[3, 10],
                ids=["one_bucket", "multi_bucket"])
def slot_tables(request):
    """(l2g, Nb, plan) of the port's box_tet10(n) plan: the cluster-slot
    table the plan build passes to the native engine."""
    n = request.param
    coords, conn = meshgen.box_tet10(n, n, n)
    seen = []
    real = t_native.cluster_slots

    def record(rows):
        out = real(rows)
        seen.append(out[0].copy())
        return out

    t_native.cluster_slots = record
    try:
        plan = t_packed.PackedPlan.build(coords, conn, coords.shape[0],
                                         device="cpu")
    finally:
        t_native.cluster_slots = real
    return seen[-1], plan.meta.n_blocks, plan


def test_block_windows_bitwise(slot_tables):
    l2g, nb, plan = slot_tables
    got, want = t_native.block_windows(l2g, nb), j_native.block_windows(l2g,
                                                                      nb)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    winc, slotidx, wc_cnt = got
    B = l2g.shape[0]
    assert winc.shape == (nb, max(int(wc_cnt.max()), 1))
    assert slotidx.shape == winc.shape + (128,)
    # clusters ascend within each block; pads are B and -1
    for blk in range(nb):
        w = winc[blk, :wc_cnt[blk]]
        assert np.all(np.diff(w) > 0)
        assert np.all(winc[blk, wc_cnt[blk]:] == B)
        assert np.all(slotidx[blk, wc_cnt[blk]:] == -1)
    # the packed fill in the identity order holds the same tables
    wc = winc.shape[1]
    winc_p, packed = t_native.block_windows_fill_packed(
        l2g, nb, wc, np.arange(nb), np.arange(B))
    np.testing.assert_array_equal(winc_p, winc)
    pad = np.concatenate([slotidx, np.full((nb, (-wc) % 4, 128), -1,
                                           np.int32)], axis=1)
    by = (pad + 1).reshape(nb, -1, 4, 128).astype(np.int64)
    words = (by[:, :, 0] | by[:, :, 1] << 8 | by[:, :, 2] << 16
             | by[:, :, 3] << 24)
    np.testing.assert_array_equal(packed.astype(np.int64) & 0xFFFFFFFF,
                                  words)
    # the plan's window width is these counts' maximum
    assert int(wc_cnt.max()) == plan.meta.win_c
