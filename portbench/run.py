"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1> [--control 1]

from the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (tpufem_torch/).  Needs as many CUDA cards as the cell asks for;
the last line of standard output is the result's JSON object (see
portbench.harness), and nothing is printed there when the run fails.
--control 1 runs the cell's control (the program one precision below the
configuration's) in place of its path: the correctness check's control,
never part of a timed run.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.load(args.workload)
    t = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        print(f"torch is not importable: {e}", file=sys.stderr)
        return 3
    from portbench.harness import log, run_cell
    log(f"stage torch_import: {time.perf_counter() - t:.4f} s "
        f"(from the start {time.perf_counter() - T0:.4f} s)")
    t = time.perf_counter()
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 3
    log(f"stage cuda_check: {time.perf_counter() - t:.4f} s")
    if importlib.util.find_spec("tpufem_torch") is None:
        log("the program (tpufem_torch) is not in this checkout")
        return 3
    result, rc = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda:0", T0, control=bool(args.control))
    if result is not None:
        print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
