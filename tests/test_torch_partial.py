"""tpufem_torch's geometry-factor operators against tpufem's.

PartialAssemblyOperator for c3d4, c3d10, c3d8, c3d6 and c3d20 on curved
meshes (and c3d4/c3d10 on straight ones), f64: the apply and the
diagonal within 1e-12 relative (max-norm) of tpufem's, the affine
detection the same; pa_apply_components within 1e-12 of tpufem's on the
same columns; ClusteredPartialOperator on box_tet10(1, 1, 2) in two
clusters of 8 (the one-hot einsum path and the kernels' plain versions,
use_pallas False / True) within 1e-12 of tpufem's apply and diagonal, and
of the port's PartialAssemblyOperator.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpufem.ops import partial as j_partial
from tpufem.ops.clustered import ClusteredPartialOperator as JCPO
from tpufem.utils import meshgen

from tpufem_torch.ops import partial as t_partial
from tpufem_torch.ops.clustered import ClusteredPartialOperator as TCPO

E, NU = 200.0, 0.3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


MESHES = {
    "c3d4": lambda: meshgen.box_tet(2, 2, 2),
    "c3d10": lambda: meshgen.box_tet10(2, 1, 2),
    "c3d8": lambda: meshgen.box_hex(2, 2, 2),
    "c3d6": lambda: meshgen.box_wedge(2, 2, 2),
    "c3d20": lambda: meshgen.hex8_to_hex20(*meshgen.box_hex(1, 1, 2)),
}


@pytest.mark.parametrize("etype,curved", [(e, True) for e in sorted(MESHES)]
                         + [("c3d4", False), ("c3d10", False)])
def test_partial_operator_matches_tpufem(etype, curved):
    coords, conn = MESHES[etype]()
    rng = np.random.default_rng(0)
    if curved:
        coords = coords + 0.04 * rng.standard_normal(coords.shape)
    N = coords.shape[0]
    jo = j_partial.PartialAssemblyOperator.build(jnp.asarray(coords), conn,
                                                 etype, E, NU, n_nodes=N)
    to = t_partial.PartialAssemblyOperator.build(coords, conn, etype, E, NU,
                                                 n_nodes=N, device="cpu")
    assert to.affine == jo.meta.affine
    if etype == "c3d10":          # one J^-1 per straight-edged element
        assert to.affine == (not curved)
    assert tuple(to.Jinv.shape) == tuple(jo.Jinv.shape)
    u = rng.standard_normal((N, 3))
    Fj, dj = jo(jnp.asarray(u)), jo.diagonal()     # a few eager einsums
    assert _rel(to(torch.from_numpy(u)).numpy(), Fj) <= 1e-12
    assert _rel(to.diagonal().numpy(), dj) <= 1e-12


def test_partial_operator_needs_node_count():
    coords, conn = meshgen.box_tet(1, 1, 1)
    with pytest.raises(ValueError):
        t_partial.PartialAssemblyOperator.build(coords, conn, "c3d4", E, NU,
                                                device="cpu")
    with pytest.raises(ValueError):
        TCPO.build(coords, conn, "c3d4", E, NU, device="cpu")


def test_pa_apply_components():
    rng = np.random.default_rng(1)
    from tpufem.elements.tables import element_table
    dN = element_table("c3d10").dN
    M = 7
    ue = tuple(rng.standard_normal((M, 10)) for _ in range(3))
    Jc = rng.standard_normal((M, 4, 9))
    W = rng.random((M, 4))
    got = t_partial.pa_apply_components(
        tuple(torch.from_numpy(x) for x in ue), torch.from_numpy(Jc),
        torch.from_numpy(W), dN, 2.0, 1.5)
    # eager: tpufem's unrolled chain compiles for seconds under jit
    want = j_partial.pa_apply_components(
        tuple(jnp.asarray(x) for x in ue), jnp.asarray(Jc), jnp.asarray(W),
        dN, 2.0, 1.5)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-12


@pytest.fixture(scope="module")
def clustered():
    coords, conn = meshgen.box_tet10(1, 1, 2)
    coords = coords + 0.02 * np.random.default_rng(2).standard_normal(
        coords.shape)
    N = coords.shape[0]
    jo = JCPO.build(jnp.asarray(coords), conn, "c3d10", E, NU, n_nodes=N,
                    elems_per_cluster=8)
    u = np.random.default_rng(3).standard_normal((N, 3))
    # eager: tpufem's unrolled chain compiles for seconds under jit
    return (coords, conn, u, np.asarray(jo(jnp.asarray(u))),
            np.asarray(jo.diagonal()))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["onehot", "plain_kernels"])
def test_clustered_partial_matches_tpufem(clustered, use_pallas):
    coords, conn, u, Fj, dj = clustered
    N = coords.shape[0]
    to = TCPO.build(coords, conn, "c3d10", E, NU, n_nodes=N, device="cpu",
                    use_pallas=use_pallas, elems_per_cluster=8)
    F = to(torch.from_numpy(u))
    assert _rel(F.numpy(), Fj) <= 1e-12
    assert _rel(to.diagonal().numpy(), dj) <= 1e-12
    pa = t_partial.PartialAssemblyOperator.build(coords, conn, "c3d10", E,
                                                 NU, n_nodes=N, device="cpu")
    assert _rel(F.numpy(), pa(torch.from_numpy(u)).numpy()) <= 1e-12
