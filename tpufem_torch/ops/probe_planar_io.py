"""Element lanes to the planar layout and back, and the round trip's time.

The port of tpufem's scripts/probe_planar_io.py: planar_write moves
lane-major [B, 3, Rp] element values to the planar [3, k, B, E_c] layout,
planar_read moves them back with the padding lanes zeroed
(csrc/probe_planar_io.cu).  main() prints the largest error of each
against the permuted array and, on the card, the host-clock ms of a loop
of v <- 0.5 * read(write(v)) + 0.5 * v at 5 and 45 iterations (two kernel
launches per iteration).  A nonzero error raises.

    python -m tpufem_torch.ops.probe_planar_io
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..core.device import resolve_device
from . import probe_kernels as pk

K, E_C, B = 10, 32, 2688     # the probe's c3d10 layout and cluster count


def main(device=None) -> dict:
    dev = resolve_device(device)
    Rp = pk.planar_lanes(K, E_C)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (B, 3, Rp)).astype(np.float32), device=dev)
    planar = pk.planar_write(x, K, E_C)
    ref = x[:, :, :K * E_C].reshape(B, 3, K, E_C).permute(1, 2, 0, 3)
    err = float((planar - ref).abs().max())
    print("write planar err:", err, flush=True)
    back = pk.planar_read(planar)
    x_masked = x.clone()
    x_masked[:, :, K * E_C:] = 0.0
    err2 = float((back - x_masked).abs().max())
    print("read planar err:", err2, flush=True)

    ms = {}
    if dev.type == "cuda":
        def loop(iters):
            v = x
            for _ in range(iters):
                v = pk.planar_read(pk.planar_write(v, K, E_C)) * 0.5 + v * 0.5
            return float(v.sum())

        for iters in (5, 45):
            loop(iters)
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                loop(iters)
                ts.append(time.perf_counter() - t0)
            ms[iters] = min(ts) * 1e3
            print(f"iters={iters}: {ms[iters]:.1f} ms", flush=True)
    if not (err == 0.0 and err2 == 0.0):
        raise RuntimeError(f"planar round trip is not exact: write err {err}, "
                           f"read err {err2}")
    return {"write_err": err, "read_err": err2, "ms": ms}


if __name__ == "__main__":
    main()
