"""The packed operator's gather and gather-sum kernels: expand and
expand_planar (X rows -> element lanes), compress_gather and
compress_planar (element lanes -> cluster slot sums), combine (slot sums
-> node rows).

Each public function is a wrapper: on a CPU tensor it runs the plain
PyTorch version beside it; on a CUDA tensor it launches the hand-written
kernel (csrc/expand.cu, csrc/compress_gather.cu, csrc/combine.cu) or
raises.  The plain versions use integer-tensor indexing with the kernels'
fixed summation order, so the two agree bitwise; they are the CPU path and
the kernels' oracle on the card.

Planar arrays [3, k, n, E_c] (element e of node kk, component c) may be a
bucket's rows of a larger [3, k, B, E_c] array: the planar wrappers take
such row slices (strides (k * P, P, E_c, 1)) as input and as `out`.

Byte-packed tables (see ops.packed.PackedPlan): 4 entries per int32 word,
entry v in byte v % 4 of word v // 4, value = index + 1 (0 = unused).  The
top byte can hold 128, so the decode masks after the shift (torch's >> on
int32 is arithmetic; masking with 0xFF makes it agree with the logical
shift tpufem uses).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import cuda

ROW = 384
BLK = 128

COMBINE = cuda.CudaKernel(
    "combine", "combine.cu", "tpufem/ops/packed_kernels.py:373",
    {"tpufem_combine": [cuda.I32, cuda.VP, cuda.I64, cuda.VP, cuda.I32,
                        cuda.VP, cuda.I32, cuda.VP, cuda.VP, cuda.I64,
                        cuda.VP]})
COMPRESS_GATHER = cuda.CudaKernel(
    "compress_gather", "compress_gather.cu",
    "tpufem/ops/packed_kernels.py:313",
    {"tpufem_compress_gather": [cuda.I32, cuda.VP, cuda.I32, cuda.VP,
                                cuda.I32, cuda.VP, cuda.I32, cuda.VP,
                                cuda.I64, cuda.VP]})
COMPRESS_PLANAR = cuda.CudaKernel(
    "compress_planar", "compress_gather.cu",
    "tpufem/ops/packed_kernels.py:242",
    {"tpufem_compress_planar": [cuda.I32, cuda.VP, cuda.I64, cuda.I32,
                                cuda.I32, cuda.VP, cuda.I32, cuda.VP,
                                cuda.I32, cuda.VP, cuda.I64, cuda.VP]})
_EXPAND_ARGS = [cuda.I32, cuda.VP, cuda.I64, cuda.VP, cuda.I32, cuda.I32,
                cuda.VP, cuda.VP, cuda.VP, cuda.I32]
EXPAND = cuda.CudaKernel(
    "expand", "expand.cu", "tpufem/ops/packed_kernels.py:110",
    {"tpufem_expand": _EXPAND_ARGS + [cuda.VP, cuda.I64, cuda.VP]})
EXPAND_PLANAR = cuda.CudaKernel(
    "expand_planar", "expand.cu", "tpufem/ops/packed_kernels.py:178",
    {"tpufem_expand_planar": _EXPAND_ARGS + [cuda.I32, cuda.I32, cuda.VP,
                                             cuda.I64, cuda.I64, cuda.VP]})


def unpack_byte(words: torch.Tensor, v: int) -> torch.Tensor:
    """Byte v % 4 of int32 `words` as int64 (0..255)."""
    return ((words >> (8 * (v % 4))) & 0xFF).long()


def _emit(res: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return res
    _out(out, res.shape[0], res).copy_(res)
    return out


def _emit_as(res: torch.Tensor, out: Optional[torch.Tensor],
             check) -> torch.Tensor:
    """res, or res copied into `out` after check(out) accepts it."""
    if out is None:
        return res
    check(out)
    out.copy_(res)
    return out


def _out(out, n, like):
    if out is None:
        return torch.empty((n, ROW), dtype=like.dtype, device=like.device)
    if (out.shape != (n, ROW) or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous [{n}, {ROW}] "
                         f"{like.dtype} tensor on {like.device}")
    return out


def _check_widths(cinc: torch.Tensor, v_widths: Sequence[int]) -> None:
    if len(v_widths) > 16:
        raise ValueError("at most 16 incidence chunks (k * E_c <= 2048)")
    if sum(v_widths) > 4 * cinc.shape[1]:
        raise ValueError(f"incidence widths {tuple(v_widths)} exceed the "
                         f"{cinc.shape[1]} words of cinc")


def _check_float_out(name, t, shape, like):
    if (tuple(t.shape) != tuple(shape) or t.dtype != like.dtype
            or t.device != like.device):
        raise ValueError(f"{name}: expected a {tuple(shape)} {like.dtype} "
                         f"tensor on {like.device}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")


def _planar_ok(t: torch.Tensor) -> bool:
    """A [3, k, n, E_c] array, or a row slice of a larger one: strides
    (k * P, P, E_c, 1)."""
    _, k, _, E_c = t.shape
    return (t.stride(3) == 1 and t.stride(2) == E_c
            and t.stride(0) == k * t.stride(1))


def _check_planar(name, t, shape, like):
    _check_float_out(name, t, shape, like)
    if not _planar_ok(t):
        raise ValueError(f"{name}: a planar array must be [3, k, n, E_c] "
                         f"rows of a contiguous [3, k, B, E_c] array, got "
                         f"strides {t.stride()}")


# ---------------------------------------------------------------------------
# expand: two-hop gather, X rows -> cluster slots -> element lanes
# ---------------------------------------------------------------------------

def hop1_plain(X: torch.Tensor, win_nodes: torch.Tensor, wslot: torch.Tensor,
               jslot: torch.Tensor, wk: int):
    """Slot values [3] planes [n, 128]: slot s of cluster b reads X[row,
    c*128 + jslot[b, s]] with row = win_nodes[b, wslot[b, s]]; an empty
    slot (wslot >= wk) or a padded row (== Nb) reads zero."""
    Nb = X.shape[0]
    ws = wslot.long()
    valid = ws < wk
    row = torch.gather(win_nodes.long(), 1, ws.clamp(max=max(wk - 1, 0)))
    valid = valid & (row < Nb)
    row = row.clamp(max=Nb - 1)
    js = jslot.long()
    return [torch.where(valid, X[row, c * BLK + js], 0.0) for c in range(3)]


def _check_expand(name, X, win_nodes, wslot, jslot, lconn, wk):
    n = wslot.shape[0]
    if (X.dim() != 2 or X.shape[1] != ROW or wslot.shape != (n, BLK)
            or jslot.shape != wslot.shape or win_nodes.shape[0] != n
            or lconn.shape[0] != n or not 0 <= wk <= win_nodes.shape[1]):
        raise ValueError(f"{name}: shapes X {tuple(X.shape)}, win_nodes "
                         f"{tuple(win_nodes.shape)}, wslot "
                         f"{tuple(wslot.shape)}, jslot {tuple(jslot.shape)}, "
                         f"lconn {tuple(lconn.shape)}, wk {wk}")


def expand_plain(X, win_nodes, wslot, jslot, lconn, *, wk: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature)."""
    uc = hop1_plain(X, win_nodes, wslot, jslot, wk)
    lc = lconn.long()
    res = torch.stack([torch.gather(uc[c], 1, lc) for c in range(3)], dim=1)
    return _emit_as(res, out, lambda o: _check_float_out(
        "expand", o, res.shape, res))


def expand(X: torch.Tensor, win_nodes: torch.Tensor, wslot: torch.Tensor,
           jslot: torch.Tensor, lconn: torch.Tensor, *, wk: int,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Element-lane values ue [n, 3, Rp] of one cluster bucket:
    ue[b, c, r] = slot lconn[b, r]'s component c (hop1_plain gives the
    slots).  X: [Nb, 384] the whole packed field (rows read by index);
    win_nodes [n, Wn], wslot/jslot [n, 128], lconn [n, Rp]: int32 plan
    rows of the bucket; wk: the bucket's window width."""
    _check_expand("expand", X, win_nodes, wslot, jslot, lconn, wk)
    n, Rp = lconn.shape
    if X.device.type == "cpu":
        return expand_plain(X, win_nodes, wslot, jslot, lconn, wk=wk,
                            out=out)
    if X.device.type != "cuda":
        raise RuntimeError(f"expand: no kernel for {X.device}")
    cuda.check_cuda_args("expand", X.device, X.dtype, floats=(X,),
                         ints=(win_nodes, wslot, jslot, lconn))
    if out is None:
        out = torch.empty((n, 3, Rp), dtype=X.dtype, device=X.device)
    _check_float_out("expand", out, (n, 3, Rp), X)
    if not out.is_contiguous():
        raise ValueError("expand: out must be contiguous")
    EXPAND.launch("tpufem_expand", int(X.dtype == torch.float64),
                  cuda.ptr(X), X.shape[0], cuda.ptr(win_nodes),
                  win_nodes.shape[1], wk, cuda.ptr(wslot), cuda.ptr(jslot),
                  cuda.ptr(lconn), Rp, cuda.ptr(out), n, cuda.stream(X))
    return out


def expand_planar_plain(X, win_nodes, wslot, jslot, lconn, k: int, E_c: int,
                        *, wk: int, out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same signature)."""
    n = wslot.shape[0]
    uc = hop1_plain(X, win_nodes, wslot, jslot, wk)
    lc = lconn[:, :k * E_c].long()
    res = torch.stack([torch.gather(uc[c], 1, lc).reshape(n, k, E_c)
                       .transpose(0, 1) for c in range(3)])
    return _emit_as(res, out, lambda o: _check_planar(
        "expand_planar", o, res.shape, res))


def expand_planar(X: torch.Tensor, win_nodes: torch.Tensor,
                  wslot: torch.Tensor, jslot: torch.Tensor,
                  lconn: torch.Tensor, k: int, E_c: int, *, wk: int,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """expand's gather written in the element-compute layout: ue3
    [3, k, n, E_c], ue3[c, kk, b, e] = ue[b, c, kk * E_c + e].  Needs
    128 % E_c == 0 (tpufem's precondition); `out` may be a bucket's rows
    of a larger planar array."""
    _check_expand("expand_planar", X, win_nodes, wslot, jslot, lconn, wk)
    n, Rp = lconn.shape
    if E_c <= 0 or BLK % E_c or k * E_c > Rp:
        raise ValueError(f"expand_planar: needs 128 % E_c == 0 and "
                         f"k * E_c <= Rp, got k={k}, E_c={E_c}, Rp={Rp}")
    if X.device.type == "cpu":
        return expand_planar_plain(X, win_nodes, wslot, jslot, lconn, k, E_c,
                                   wk=wk, out=out)
    if X.device.type != "cuda":
        raise RuntimeError(f"expand_planar: no kernel for {X.device}")
    cuda.check_cuda_args("expand_planar", X.device, X.dtype, floats=(X,),
                         ints=(win_nodes, wslot, jslot, lconn))
    if out is None:
        out = torch.empty((3, k, n, E_c), dtype=X.dtype, device=X.device)
    _check_planar("expand_planar", out, (3, k, n, E_c), X)
    EXPAND_PLANAR.launch(
        "tpufem_expand_planar", int(X.dtype == torch.float64), cuda.ptr(X),
        X.shape[0], cuda.ptr(win_nodes), win_nodes.shape[1], wk,
        cuda.ptr(wslot), cuda.ptr(jslot), cuda.ptr(lconn), Rp, k, E_c,
        cuda.ptr(out), out.stride(1), n, cuda.stream(X))
    return out


# ---------------------------------------------------------------------------
# compress: per-slot incidence sums
# ---------------------------------------------------------------------------

def compress_chunks_plain(chunks, cinc: torch.Tensor,
                          v_widths: Sequence[int]):
    """Slot sums from per-chunk lane values.

    chunks[g][c]: [n, 128] values of element lanes g*128.. of component c;
    cinc: [n, Wp, 128] int32.  Returns [3] planes [n, 128]:
    acc[c][b, s] = sum_v chunks[g][c][b, byte_v - 1] over nonzero bytes, in
    the fixed (g, v) order."""
    n = cinc.shape[0]
    ref = chunks[0][0]
    acc = [torch.zeros((n, BLK), dtype=ref.dtype, device=ref.device)
           for _ in range(3)]
    off = 0
    for g, vg in enumerate(v_widths):
        for v in range(vg):
            vi = off + v
            byte = unpack_byte(cinc[:, vi // 4, :], vi)
            valid = byte > 0
            idx = (byte - 1).clamp_(min=0)
            for c in range(3):
                gth = torch.gather(chunks[g][c], 1, idx)
                acc[c] = acc[c] + torch.where(valid, gth, 0.0)
        off += vg
    return acc


def compress_gather_plain(fe: torch.Tensor, cinc: torch.Tensor,
                          v_widths: Sequence[int],
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fe [n, 3, Rp] -> Yc [n, 384]."""
    chunks = [[fe[:, c, g * BLK:(g + 1) * BLK] for c in range(3)]
              for g in range(len(v_widths))]
    return _emit(torch.cat(compress_chunks_plain(chunks, cinc, v_widths),
                           dim=1), out)


def compress_gather(fe: torch.Tensor, cinc: torch.Tensor,
                    v_widths: Sequence[int],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fe [n, 3, Rp] -> Yc [n, 384] through one bucket's incidence table
    cinc [n, Wp, 128] int32 with chunk widths v_widths."""
    n, three, Rp = fe.shape
    if three != 3 or cinc.shape[0] != n or cinc.shape[2] != BLK:
        raise ValueError(f"shapes fe {tuple(fe.shape)}, "
                         f"cinc {tuple(cinc.shape)}")
    if len(v_widths) * BLK > Rp:
        raise ValueError("incidence chunks beyond the element lanes")
    _check_widths(cinc, v_widths)
    if fe.device.type == "cpu":
        return compress_gather_plain(fe, cinc, v_widths, out)
    if fe.device.type != "cuda":
        raise RuntimeError(f"compress_gather: no kernel for {fe.device}")
    cuda.check_cuda_args("compress_gather", fe.device, fe.dtype,
                         floats=(fe,), ints=(cinc,))
    res = _out(out, n, fe)
    COMPRESS_GATHER.launch(
        "tpufem_compress_gather", int(fe.dtype == torch.float64),
        cuda.ptr(fe), Rp, cuda.ptr(cinc), cinc.shape[1],
        cuda.int_array(v_widths),
        len(v_widths), cuda.ptr(res), n, cuda.stream(fe))
    return res


def planar_chunks(plane, k: int, E_c: int, n_chunks: int, zero):
    """Element planes -> 128-lane chunks (lane r = kk * E_c + e):
    chunks[g][c] [n, 128] concatenates plane(c, kk) for the 128 / E_c
    nodes kk of chunk g; a node kk >= k (or a plane that is None) reads
    `zero`."""
    per = BLK // E_c
    chunks = []
    for g in range(n_chunks):
        parts = []
        for c in range(3):
            planes = []
            for i in range(per):
                kk = g * per + i
                f = plane(c, kk) if kk < k else None
                planes.append(f if f is not None else zero)
            parts.append(torch.cat(planes, dim=1))
        chunks.append(parts)
    return chunks


def compress_planar_plain(fe3: torch.Tensor, cinc: torch.Tensor,
                          v_widths: Sequence[int],
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Planar Fe3 [3, k, n, E_c] -> Yc [n, 384]."""
    _, k, n, E_c = fe3.shape
    zero = torch.zeros((n, E_c), dtype=fe3.dtype, device=fe3.device)
    chunks = planar_chunks(lambda c, kk: fe3[c, kk], k, E_c, len(v_widths),
                           zero)
    return _emit(torch.cat(compress_chunks_plain(chunks, cinc, v_widths),
                           dim=1), out)


def compress_planar(fe3: torch.Tensor, cinc: torch.Tensor,
                    v_widths: Sequence[int],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """compress_gather reading planar Fe3 [3, k, n, E_c] (lane l of chunk
    g is node g * (128 / E_c) + l / E_c, element l % E_c; nodes >= k read
    0): bitwise equal to compress_gather on the lane-major transpose.
    Needs 128 % E_c == 0; fe3 may be a bucket's rows of a larger planar
    array."""
    three, k, n, E_c = fe3.shape
    if (three != 3 or E_c <= 0 or BLK % E_c or cinc.shape[0] != n
            or cinc.shape[2] != BLK):
        raise ValueError(f"compress_planar: shapes fe3 {tuple(fe3.shape)}, "
                         f"cinc {tuple(cinc.shape)} (128 % E_c == 0)")
    _check_widths(cinc, v_widths)
    if fe3.device.type == "cpu":
        return compress_planar_plain(fe3, cinc, v_widths, out)
    if fe3.device.type != "cuda":
        raise RuntimeError(f"compress_planar: no kernel for {fe3.device}")
    cuda.check_cuda_args("compress_planar", fe3.device, fe3.dtype,
                         ints=(cinc,))
    _check_planar("compress_planar", fe3, fe3.shape, fe3)
    res = _out(out, n, fe3)
    if n == 0:
        return res
    COMPRESS_PLANAR.launch(
        "tpufem_compress_planar", int(fe3.dtype == torch.float64),
        cuda.ptr(fe3), fe3.stride(1), k, E_c, cuda.ptr(cinc), cinc.shape[1],
        cuda.int_array(v_widths), len(v_widths), cuda.ptr(res), n,
        cuda.stream(fe3))
    return res


# ---------------------------------------------------------------------------
# combine: cluster slot sums -> node rows
# ---------------------------------------------------------------------------

def combine_plain(Yc: torch.Tensor, winc: torch.Tensor,
                  slotidx: torch.Tensor, wk: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """F[j, c*128+l] = sum_w Yc[winc[j, w], c*128 + byte_w(l) - 1], w in
    order below row j's width wk[j]; rows of Yc are read by index (winc ==
    B reads zero)."""
    B = Yc.shape[0]
    n = winc.shape[0]
    widths = wk.long()
    wmax = int(widths.max()) if n else 0
    acc = [torch.zeros((n, BLK), dtype=Yc.dtype, device=Yc.device)
           for _ in range(3)]
    wc = winc[:, :wmax].long()
    for w in range(wmax):
        byte = unpack_byte(slotidx[:, w // 4, :], w)
        rows = wc[:, w:w + 1]
        valid = (byte > 0) & (rows < B) & (widths > w)[:, None]
        idx = (byte - 1).clamp_(min=0)
        rows = rows.clamp(max=B - 1)
        for c in range(3):
            gth = Yc[rows, c * BLK + idx]
            acc[c] = acc[c] + torch.where(valid, gth, 0.0)
    return _emit(torch.cat(acc, dim=1), out)


def combine(Yc: torch.Tensor, winc: torch.Tensor, slotidx: torch.Tensor,
            wk: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """Slot sums Yc [B, 384] -> node rows [n, 384]: winc [n, Wc] int32 (pad
    B), slotidx [n, Wp, 128] int32 byte-packed, wk [n] int32 each row's
    window width (<= Wc, <= 4 * Wp): PackedPlan.row_wk for all block
    buckets in one launch, or one bucket's width repeated, as tpufem's
    kernel takes it."""
    B, row = Yc.shape
    n = winc.shape[0]
    Wc, Wp = winc.shape[1], slotidx.shape[1]
    if (row != ROW or slotidx.shape[0] != n or slotidx.shape[2] != BLK
            or tuple(wk.shape) != (n,)):
        raise ValueError(f"shapes Yc {tuple(Yc.shape)}, winc "
                         f"{tuple(winc.shape)}, slotidx "
                         f"{tuple(slotidx.shape)}, wk {tuple(wk.shape)}")
    if Yc.device.type == "cpu":
        if n and not 0 <= int(wk.min()) <= int(wk.max()) <= min(Wc, 4 * Wp):
            raise ValueError(f"row widths outside [0, {min(Wc, 4 * Wp)}]")
        return combine_plain(Yc, winc, slotidx, wk, out)
    if Yc.device.type != "cuda":
        raise RuntimeError(f"combine: no kernel for {Yc.device}")
    cuda.check_cuda_args("combine", Yc.device, Yc.dtype, floats=(Yc,),
                         ints=(winc, slotidx, wk))
    res = _out(out, n, Yc)
    COMBINE.launch("tpufem_combine", int(Yc.dtype == torch.float64),
                   cuda.ptr(Yc), B, cuda.ptr(winc), Wc, cuda.ptr(slotidx),
                   Wp, cuda.ptr(wk), cuda.ptr(res), n, cuda.stream(Yc))
    return res
