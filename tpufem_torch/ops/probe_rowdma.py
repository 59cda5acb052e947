"""Indexed row reads in a kernel against a materialised row gather.

The port of tpufem's scripts/probe_rowdma.py.  It measures, for rows of
384 float32 values read by index from a large array:

  a) the gather baseline: src[(idx + i) % n] materialised and summed, in an
     eager loop of 2 and of 22 iterations; the time per gather is the slope
     over the 20 extra iterations (the loop-dependent indices keep the
     gather from being hoisted);
  b) the kernel row_accumulate (csrc/probe_rowdma.cu), which keeps K = 8
     rows in flight with cp.async and sums every 128 of them, checked
     bitwise against its plain version first.

Times are host-clock minima over a few runs that each end in a read back
to the host, as the probe takes them.

    python -m tpufem_torch.ops.probe_rowdma [n_src_rows] [n_reads]
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import probe_kernels as pk

IN_FLIGHT = 8        # rows in flight per block (csrc/probe_rowdma.cu)


def _best_s(f, reps: int) -> float:
    """Least host-clock seconds of f() over `reps` runs, after one more."""
    f()
    best = []
    for _ in range(reps):
        t0 = time.perf_counter()
        f()
        best.append(time.perf_counter() - t0)
    return min(best)


def _rate(n_rd: int, t: float) -> str:
    return (f"{t * 1e3:.2f} ms / {n_rd} rows = {n_rd / t / 1e6:.1f} M rows/s "
            f"({n_rd * pk.ROW * 4 / t / 1e9:.0f} GB/s)")


def main(n_src: int = 198208, n_rd: int = 1 << 20, device=None) -> dict:
    """Defaults: B at 5.14M elements as the source rows, ~1M reads.
    Returns the two times in ms."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.standard_normal((n_src, pk.ROW)).astype(
        np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, n_src, n_rd).astype(np.int32),
                          device=dev)

    def take(iters):
        def f():
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(iters):
                acc = acc + src[(idx + i) % n_src].sum()
            return float(acc)
        return f

    t_lo = _best_s(take(2), 5)
    t_hi = _best_s(take(22), 5)
    t_take = max((t_hi - t_lo) / 20, 1e-9)
    print(f"gather src[(idx + i) % n]: {_rate(n_rd, t_take)}", flush=True)

    if not torch.equal(pk.row_accumulate(src, idx),
                       pk.row_accumulate_plain(src, idx)):
        raise RuntimeError("row_accumulate differs from its plain version")
    t_row = _best_s(lambda: float(pk.row_accumulate(src, idx)[:, 0, 0].sum()),
                    3)
    print(f"row kernel (K={IN_FLIGHT} in flight): {_rate(n_rd, t_row)}",
          flush=True)
    return {"gather_ms": t_take * 1e3, "kernel_ms": t_row * 1e3}


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:3]])
