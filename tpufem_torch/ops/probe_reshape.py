"""Which [64, 32] -> [16, 128] row-major relayouts are right on the card?

The port of tpufem's scripts/probe_reshape.py.  Each candidate of that
probe (four reshapes of one [64, 32] block, the same through a scratch
tile, and two inverses) is a variant of the kernels relayout_fwd and
relayout_inv (ops/probe_kernels.py); main() runs each on one tile, checks
it against numpy's reshape and prints the probe's line per candidate.  In
row-major memory the relayout is a flat copy (csrc/probe_reshape.cu), so
every candidate should be right; a wrong one raises.

    python -m tpufem_torch.ops.probe_reshape
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from . import probe_kernels as pk

# the probe's candidates: (name, relayout_fwd variant)
FORWARD = (("reshape", 0), ("slice_strided", 1), ("reshape3", 0),
           ("getitem_strided", 1), ("scratch_strided", 2))
# (name, relayout_inv variant)
INVERSE = (("inv_stack_reshape", 1), ("inv_scratch", 2))


def main(device=None) -> dict:
    """Run every candidate on one tile; returns {name: correct}."""
    dev = resolve_device(device)
    x = np.arange(64 * 32, dtype=np.float32).reshape(1, 64, 32)
    xt = torch.as_tensor(x, device=dev)
    want = torch.as_tensor(x.reshape(1, 16, 128), device=dev)
    results = {}
    runs = ([(name, pk.relayout_fwd, v, xt, want) for name, v in FORWARD]
            + [(name, pk.relayout_inv, v, want, xt) for name, v in INVERSE])
    for name, fn, variant, arg, expect in runs:
        results[name] = torch.equal(fn(arg, variant), expect)
        print(f"{name:18s} compiled, correct={results[name]}", flush=True)
    wrong = [name for name, ok in results.items() if not ok]
    if wrong:
        raise RuntimeError(f"relayout candidates gave wrong answers: {wrong}")
    return results


if __name__ == "__main__":
    main()
