"""The kernels of the three probes: relayout_fwd and relayout_inv
(ops/probe_reshape.py), row_accumulate (ops/probe_rowdma.py), planar_write
and planar_read (ops/probe_planar_io.py).

The counterparts of the Pallas kernels in tpufem's scripts/probe_reshape.py,
scripts/probe_rowdma.py and scripts/probe_planar_io.py.  Each public kernel
function here is a wrapper: on a CPU tensor it runs the plain PyTorch
version beside it; on a CUDA tensor it launches the hand-written kernel
(csrc/probe_reshape.cu, csrc/probe_rowdma.cu, csrc/probe_planar_io.cu) or
raises.  The kernels take float32, as the probes do.  The plain versions
are index copies, and row_accumulate_plain adds the rows in the kernel's
order, so each kernel agrees with its plain version bitwise.
"""
from __future__ import annotations

import torch

from . import cuda

ROW = 384            # values per row of row_accumulate's src
READS = 128          # rows summed into one output row
LANE_CHUNK = 128     # the planar layout's lane chunk

# forward variants: 0 flat, 1 strided rows, 2 strided rows through shared
# memory; inverse variants: 1 stacked column blocks, 2 stride-4 scratch rows
FWD_VARIANTS = (0, 1, 2)
INV_VARIANTS = (1, 2)

_RELAYOUT_ARGS = [cuda.I32, cuda.VP, cuda.I64, cuda.VP, cuda.VP]
_PLANAR_ARGS = [cuda.VP, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.VP,
                cuda.VP]
RELAYOUT_FWD = cuda.CudaKernel(
    "relayout_fwd", "probe_reshape.cu", "scripts/probe_reshape.py:39,49",
    {"tpufem_relayout_fwd": _RELAYOUT_ARGS})
RELAYOUT_INV = cuda.CudaKernel(
    "relayout_inv", "probe_reshape.cu", "scripts/probe_reshape.py:92,111",
    {"tpufem_relayout_inv": _RELAYOUT_ARGS})
ROW_ACCUMULATE = cuda.CudaKernel(
    "row_accumulate", "probe_rowdma.cu", "scripts/probe_rowdma.py:75",
    {"tpufem_row_accumulate": [cuda.VP, cuda.I64, cuda.VP, cuda.I64, cuda.VP,
                               cuda.VP]})
PLANAR_WRITE = cuda.CudaKernel(
    "planar_write", "probe_planar_io.cu", "scripts/probe_planar_io.py:23",
    {"tpufem_planar_write": _PLANAR_ARGS})
PLANAR_READ = cuda.CudaKernel(
    "planar_read", "probe_planar_io.cu", "scripts/probe_planar_io.py:36",
    {"tpufem_planar_read": _PLANAR_ARGS})


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA
    one (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {t.device}")
    return True


def _check_f32(name: str, t: torch.Tensor, vec4: bool = False) -> None:
    """float32, contiguous and, for the kernels that move float4s (vec4),
    16-byte aligned."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    cuda.check_cuda_args(name, t.device, t.dtype, floats=(t,))
    if vec4 and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a 16-byte aligned tensor")


def _check_tiles(name, x, shape, variant, variants) -> None:
    if variant not in variants:
        raise ValueError(f"{name}: variant must be one of {variants}, got "
                         f"{variant!r}")
    if x.dim() != 3 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{name}: expected [T, {shape[0]}, {shape[1]}] "
                         f"tiles, got {tuple(x.shape)}")


def relayout_fwd_plain(x: torch.Tensor, variant: int) -> torch.Tensor:
    """[T, 64, 32] -> [T, 16, 128]: the flat reshape (variant 0) or
    out[:, r, 32i + c] = x[:, 4r + i, c] (variants 1 and 2)."""
    T = x.shape[0]
    if variant == 0:
        return x.reshape(T, 16, 128).clone()
    return torch.cat([x[:, i::4] for i in range(4)], dim=2)


def relayout_fwd(x: torch.Tensor, variant: int) -> torch.Tensor:
    """[T, 64, 32] tiles -> [T, 16, 128] row-major reshapes, by the index
    map of `variant` (FWD_VARIANTS)."""
    _check_tiles("relayout_fwd", x, (64, 32), variant, FWD_VARIANTS)
    if not _on_card("relayout_fwd", x):
        return relayout_fwd_plain(x, variant)
    _check_f32("relayout_fwd", x, vec4=True)
    out = torch.empty((x.shape[0], 16, 128), dtype=x.dtype, device=x.device)
    RELAYOUT_FWD.launch("tpufem_relayout_fwd", variant, cuda.ptr(x),
                        x.shape[0], cuda.ptr(out), cuda.stream(x))
    return out


def relayout_inv_plain(y: torch.Tensor, variant: int) -> torch.Tensor:
    """[T, 16, 128] -> [T, 64, 32], out[:, 4r + i, c] = y[:, r, 32i + c]:
    the column blocks stacked (variant 1) or written to rows i::4 of a
    scratch tile (variant 2)."""
    T = y.shape[0]
    blocks = [y[:, :, 32 * i:32 * (i + 1)] for i in range(4)]
    if variant == 1:
        return torch.stack(blocks, dim=2).reshape(T, 64, 32)
    out = y.new_empty((T, 64, 32))
    for i, blk in enumerate(blocks):
        out[:, i::4] = blk
    return out


def relayout_inv(y: torch.Tensor, variant: int) -> torch.Tensor:
    """[T, 16, 128] tiles -> [T, 64, 32], the inverse of relayout_fwd, by
    the index map of `variant` (INV_VARIANTS)."""
    _check_tiles("relayout_inv", y, (16, 128), variant, INV_VARIANTS)
    if not _on_card("relayout_inv", y):
        return relayout_inv_plain(y, variant)
    _check_f32("relayout_inv", y, vec4=True)
    out = torch.empty((y.shape[0], 64, 32), dtype=y.dtype, device=y.device)
    RELAYOUT_INV.launch("tpufem_relayout_inv", variant, cuda.ptr(y),
                        y.shape[0], cuda.ptr(out), cuda.stream(y))
    return out


def row_accumulate_plain(src: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """out[g, 0] = sum over r = 0..127 of src[idx[128 g + r]], added in r
    order from zero."""
    ix = idx.reshape(-1, READS).long()
    acc = src.new_zeros((ix.shape[0], src.shape[1]))
    for r in range(READS):
        acc = acc + src[ix[:, r]]
    return acc.reshape(-1, 1, src.shape[1])


def row_accumulate(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src [n_src, 384], idx [n_rd] int32 in [0, n_src) with n_rd a
    multiple of 128 -> [n_rd / 128, 1, 384] sums of 128 indexed rows each."""
    if src.dim() != 2 or src.shape[1] != ROW:
        raise ValueError(f"row_accumulate: src must be [n, {ROW}], got "
                         f"{tuple(src.shape)}")
    if idx.dim() != 1 or idx.numel() % READS:
        raise ValueError(f"row_accumulate: idx must be 1-D with a multiple "
                         f"of {READS} entries, got {tuple(idx.shape)}")
    if not _on_card("row_accumulate", src):
        return row_accumulate_plain(src, idx)
    _check_f32("row_accumulate", src, vec4=True)
    cuda.check_cuda_args("row_accumulate", src.device, src.dtype,
                         ints=(idx,))
    n_out = idx.numel() // READS
    out = torch.empty((n_out, 1, ROW), dtype=src.dtype, device=src.device)
    ROW_ACCUMULATE.launch("tpufem_row_accumulate", cuda.ptr(src),
                          src.shape[0], cuda.ptr(idx), n_out, cuda.ptr(out),
                          cuda.stream(src))
    return out


def planar_lanes(k: int, E_c: int) -> int:
    """Rp, the lanes of k element nodes of E_c elements in 128-lane chunks;
    raises ValueError unless E_c divides 128 (the probe's precondition)."""
    if k < 1 or E_c < 1 or LANE_CHUNK % E_c:
        raise ValueError(f"planar layout needs k >= 1 and E_c dividing "
                         f"{LANE_CHUNK}; got k {k}, E_c {E_c}")
    return -(-k * E_c // LANE_CHUNK) * LANE_CHUNK


def planar_write_plain(x: torch.Tensor, k: int, E_c: int) -> torch.Tensor:
    B = x.shape[0]
    return x[:, :, :k * E_c].reshape(B, 3, k, E_c).permute(
        1, 2, 0, 3).contiguous()


def planar_write(x: torch.Tensor, k: int, E_c: int) -> torch.Tensor:
    """Lane-major [B, 3, Rp] -> planar [3, k, B, E_c]:
    out[c, kk, b, e] = x[b, c, kk * E_c + e]."""
    Rp = planar_lanes(k, E_c)
    if x.dim() != 3 or tuple(x.shape[1:]) != (3, Rp):
        raise ValueError(f"planar_write: expected [B, 3, {Rp}] for k {k}, "
                         f"E_c {E_c}; got {tuple(x.shape)}")
    if not _on_card("planar_write", x):
        return planar_write_plain(x, k, E_c)
    _check_f32("planar_write", x)
    B = x.shape[0]
    out = torch.empty((3, k, B, E_c), dtype=x.dtype, device=x.device)
    PLANAR_WRITE.launch("tpufem_planar_write", cuda.ptr(x), B, k,
                        E_c.bit_length() - 1, Rp, cuda.ptr(out),
                        cuda.stream(x))
    return out


def planar_read_plain(p: torch.Tensor) -> torch.Tensor:
    _, k, B, E_c = p.shape
    out = p.new_zeros((B, 3, planar_lanes(k, E_c)))
    out[:, :, :k * E_c] = p.permute(2, 0, 1, 3).reshape(B, 3, k * E_c)
    return out


def planar_read(p: torch.Tensor) -> torch.Tensor:
    """Planar [3, k, B, E_c] -> lane-major [B, 3, Rp]; the lanes from
    k * E_c on are zero."""
    if p.dim() != 4 or p.shape[0] != 3:
        raise ValueError(f"planar_read: expected [3, k, B, E_c], got "
                         f"{tuple(p.shape)}")
    _, k, B, E_c = p.shape
    Rp = planar_lanes(k, E_c)
    if not _on_card("planar_read", p):
        return planar_read_plain(p)
    _check_f32("planar_read", p)
    out = torch.empty((B, 3, Rp), dtype=p.dtype, device=p.device)
    PLANAR_READ.launch("tpufem_planar_read", cuda.ptr(p), B, k,
                       E_c.bit_length() - 1, Rp, cuda.ptr(out),
                       cuda.stream(p))
    return out
