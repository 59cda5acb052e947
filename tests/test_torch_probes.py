"""The port's probe kernels (tpufem_torch/ops/probe_kernels.py) against
tpufem's Pallas probes of scripts/, run in interpret mode on the CPU.

- relayout_fwd: the four candidates of scripts/probe_reshape.py
  (`make_kernel(cand_*)`) and its `scratch_kernel`, gridded over T tiles,
  bitwise against the plain relayout of every variant;
- relayout_inv: its kernels are nested in the script's main(), so the
  plain inverse is checked against numpy's reshape, as the script checks
  its kernels, and for the round trip;
- row_accumulate: a verbatim copy of the nested `kern` of
  scripts/probe_rowdma.py, bitwise against the plain version, and
  torch's embedding_bag to 1e-6 relative (it sums in another order);
- planar_write / planar_read: `_write_kernel` and `_read_kernel` of
  scripts/probe_planar_io.py, bitwise, with the zero-filled round trip;
- the three mains on the CPU, and their refusal to run without a card
  when none is asked for.
Inputs are seeded numpy arrays given to both packages.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpufem_torch.ops import probe_kernels as pk
from tpufem_torch.ops import probe_planar_io, probe_reshape, probe_rowdma

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs: its tensors are small,
    and under the suite's parallel workers torch's thread pool costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiles(kernel, x, out_rows, out_cols, scratch=()):
    """tpufem's one-block kernel over T tiles, in interpret mode."""
    T, rows, cols = x.shape
    return np.asarray(pl.pallas_call(
        kernel, grid=(T,),
        in_specs=[pl.BlockSpec((None, rows, cols), lambda t: (t, 0, 0))],
        out_specs=pl.BlockSpec((None, out_rows, out_cols),
                               lambda t: (t, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((T, out_rows, out_cols), jnp.float32),
        scratch_shapes=list(scratch), interpret=True)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(0).standard_normal((3, 64, 32)).astype(
        np.float32)


def test_relayout_candidates_match_plain(tiles):
    """Every forward candidate of the probe equals the plain relayout of
    its variant (and of every other variant: one function, five maps)."""
    ref = _script("probe_reshape")
    kernels = {"reshape": ref.make_kernel(ref.cand_reshape),
               "slice_strided": ref.make_kernel(ref.cand_slice_strided),
               "reshape3": ref.make_kernel(ref.cand_reshape3),
               "getitem_strided": ref.make_kernel(ref.cand_getitem_strided),
               "scratch_strided": ref.scratch_kernel}
    x = torch.as_tensor(tiles)
    for name, variant in probe_reshape.FORWARD:
        scratch = ([pltpu.VMEM((64, 32), jnp.float32)]
                   if name == "scratch_strided" else [])
        want = _tiles(kernels[name], tiles, 16, 128, scratch)
        assert np.array_equal(want, tiles.reshape(3, 16, 128)), name
        got = pk.relayout_fwd(x, variant)
        assert got.shape == (3, 16, 128)
        assert np.array_equal(got.numpy(), want), name
        for v in pk.FWD_VARIANTS:
            assert np.array_equal(pk.relayout_fwd_plain(x, v).numpy(), want)


@pytest.mark.parametrize("variant", pk.INV_VARIANTS)
def test_relayout_inverse(tiles, variant):
    """The inverse against numpy (the script's own check of inv_kernel and
    inv_scratch_kernel) and the round trip through every forward map."""
    y = tiles.reshape(3, 16, 128)
    got = pk.relayout_inv(torch.as_tensor(y), variant)
    assert got.shape == (3, 64, 32)
    assert np.array_equal(got.numpy(), tiles)
    x = torch.as_tensor(tiles)
    for v in pk.FWD_VARIANTS:
        assert torch.equal(pk.relayout_inv(pk.relayout_fwd(x, v), variant), x)


def test_relayout_checks():
    with pytest.raises(ValueError, match="variant"):
        pk.relayout_fwd(torch.zeros(1, 64, 32), 3)
    with pytest.raises(ValueError, match="variant"):
        pk.relayout_inv(torch.zeros(1, 16, 128), 0)
    with pytest.raises(ValueError, match="tiles"):
        pk.relayout_fwd(torch.zeros(1, 32, 64), 0)
    with pytest.raises(RuntimeError, match="no kernel"):
        pk.relayout_fwd(torch.zeros(1, 64, 32, device="meta"), 0)


# scripts/probe_rowdma.py:73-92, verbatim (the kernel is nested in main())
ROW = 384
TR, K = 128, 8


def kern(idx_ref, src_ref, out_ref, scratch, sems):
    base = pl.program_id(0) * TR

    def start(r):
        pltpu.make_async_copy(
            src_ref.at[pl.ds(idx_ref[base + r], 1)],
            scratch.at[r % K], sems.at[r % K]).start()
    for r in range(K):
        start(r)
    acc = jnp.zeros((1, ROW), jnp.float32)
    for r in range(TR):
        pltpu.make_async_copy(
            src_ref.at[pl.ds(idx_ref[base + r], 1)],
            scratch.at[r % K], sems.at[r % K]).wait()
        acc = acc + scratch[r % K]
        if r + K < TR:
            start(r + K)
    out_ref[...] = acc


def test_row_accumulate_matches_pallas():
    """n_src 1000, n_rd 256: two output rows of 128 reads each."""
    n_src, n_rd = 1000, 256
    rng = np.random.default_rng(1)
    src = rng.standard_normal((n_src, ROW)).astype(np.float32)
    idx = rng.integers(0, n_src, n_rd).astype(np.int32)
    grid = n_rd // TR
    want = np.asarray(pl.pallas_call(
        kern,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(grid,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((None, 1, ROW),
                                   lambda i, ix_ref: (i, 0, 0)),
            scratch_shapes=[pltpu.VMEM((K, 1, ROW), jnp.float32),
                            pltpu.SemaphoreType.DMA((K,))]),
        out_shape=jax.ShapeDtypeStruct((grid, 1, ROW), jnp.float32),
        interpret=True)(jnp.asarray(idx), jnp.asarray(src)))
    st, it = torch.as_tensor(src), torch.as_tensor(idx)
    got = pk.row_accumulate(st, it)
    assert got.shape == (grid, 1, ROW) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    bag = torch.nn.functional.embedding_bag(it.view(-1, TR).long(), st,
                                            mode="sum")
    assert float((bag - got[:, 0]).abs().max() / bag.abs().max()) <= 1e-6


def test_row_accumulate_checks():
    src = torch.zeros(10, ROW)
    with pytest.raises(ValueError, match="multiple of 128"):
        pk.row_accumulate(src, torch.zeros(100, dtype=torch.int32))
    with pytest.raises(ValueError, match="src"):
        pk.row_accumulate(torch.zeros(10, 128),
                          torch.zeros(128, dtype=torch.int32))


@pytest.mark.parametrize("k,E_c", [(10, 32), (4, 32)])
def test_planar_io_matches_pallas(k, E_c):
    """The probe's write and read kernels at B = 64 (TB = 8) against the
    plain versions, and the round trip with the padding lanes zeroed."""
    ref = _script("probe_planar_io")
    B, TB = 64, 8
    Rp = pk.planar_lanes(k, E_c)
    assert Rp == -(-k * E_c // 128) * 128
    x = np.random.default_rng(2).standard_normal((B, 3, Rp)).astype(
        np.float32)
    write = functools.partial(ref._write_kernel, TB=TB, k=k, E_c=E_c)
    planar = pl.pallas_call(
        write, grid=(B // TB,),
        in_specs=[pl.BlockSpec((TB, 3, Rp), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((3, k, TB, E_c), lambda i: (0, 0, i, 0)),
        out_shape=jax.ShapeDtypeStruct((3, k, B, E_c), jnp.float32),
        interpret=True)(jnp.asarray(x))
    read = functools.partial(ref._read_kernel, TB=TB, k=k, E_c=E_c)
    back = pl.pallas_call(
        read, grid=(B // TB,),
        in_specs=[pl.BlockSpec((3, k, TB, E_c), lambda i: (0, 0, i, 0))],
        out_specs=pl.BlockSpec((TB, 3, Rp), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 3, Rp), jnp.float32),
        interpret=True)(planar)
    xt = torch.as_tensor(x)
    got_w = pk.planar_write(xt, k, E_c)
    assert got_w.shape == (3, k, B, E_c)
    assert np.array_equal(got_w.numpy(), np.asarray(planar))
    got_r = pk.planar_read(got_w)
    assert np.array_equal(got_r.numpy(), np.asarray(back))
    masked = x.copy()
    masked[:, :, k * E_c:] = 0.0
    assert np.array_equal(got_r.numpy(), masked)


def test_planar_io_checks():
    with pytest.raises(ValueError, match="E_c"):
        pk.planar_lanes(10, 24)
    with pytest.raises(ValueError, match="E_c"):
        pk.planar_write(torch.zeros(4, 3, 256), 10, 24)
    with pytest.raises(ValueError, match="E_c"):
        pk.planar_read(torch.zeros(3, 10, 4, 24))
    with pytest.raises(ValueError, match="planar_write"):
        pk.planar_write(torch.zeros(4, 3, 256), 10, 32)
    # E_c 16: Rp 256, lanes 160..255 zero after the round trip
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (5, 3, 256)).astype(np.float32))
    back = pk.planar_read(pk.planar_write(x, 10, 16))
    assert torch.equal(back[:, :, :160], x[:, :, :160])
    assert not back[:, :, 160:].any()


def test_probe_mains_on_cpu(capsys):
    assert all(probe_reshape.main(device="cpu").values())
    assert set(probe_rowdma.main(1000, 256, device="cpu")) == {"gather_ms",
                                                               "kernel_ms"}
    res = probe_planar_io.main(device="cpu")
    assert res["write_err"] == 0.0 and res["read_err"] == 0.0
    out = capsys.readouterr().out
    assert out.count("correct=True") == 7
    assert "write planar err: 0.0" in out and "read planar err: 0.0" in out


def test_probe_mains_need_a_card(monkeypatch):
    """device=None means CUDA; without a card every probe raises instead of
    running its plain path on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (probe_reshape.main, probe_rowdma.main, probe_planar_io.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main()
        with pytest.raises(RuntimeError, match="CUDA"):
            main(device="cuda")
