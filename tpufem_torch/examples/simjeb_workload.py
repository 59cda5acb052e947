"""The reference's end-to-end SimJEB workload (solver_example.ipynb 3-11).

The port of tpufem's examples/simjeb_workload.py.  Load mesh (.vtu/.vtk)
+ h5 sample -> RBE2-constrained packed PCG -> residual-sum acceptance ->
nodal von Mises -> shared-face equilibrium.

    python -m tpufem_torch.examples.simjeb_workload [--device cpu]
    python -m tpufem_torch.examples.simjeb_workload mesh.vtu sample_0.h5

With no paths a SimJEB-shaped bundle (XML .vtu mesh + h5 sample with
forces/rbe2/rbe3/outputs datasets) is synthesized first (box_tet(n, n,
2n), --n 8), so the whole pipeline — including the io layer — runs
self-contained.  The result (displacement, nodal von Mises) is written to
simjeb_result.vtu under the temporary directory.  Without h5py the
example says so and runs the same pipeline on the synthesized sample's
arrays in memory (the h5 file is then neither written nor read).
"""
import argparse
import importlib.util
import os
import tempfile
import time

from tpufem_torch.core.device import resolve_device
from tpufem_torch.utils.profiling import StageClock
from tpufem_torch.workloads import (run_simjeb_workload,
                                    synthesize_simjeb_bundle)
from tpufem_torch.workloads import simjeb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*", help="mesh.vtu sample_0.h5")
    ap.add_argument("--n", type=int, default=8,
                    help="the synthetic bundle's box_tet(n, n, 2n)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out_path = os.path.join(tempfile.gettempdir(), "simjeb_result.vtu")
    sample = None
    if len(args.paths) >= 2:
        mesh_path, h5_path = args.paths[0], args.paths[1]
    else:
        out_dir = os.path.join(tempfile.gettempdir(), "tpufem_torch_simjeb")
        print("no data paths given - synthesizing a SimJEB-shaped bundle")
        t0 = time.time()
        if importlib.util.find_spec("h5py") is None:
            print("h5py is not installed: sample_0.h5 is neither written "
                  "nor read; the workload runs on the sample's arrays")
            dev = resolve_device(args.device)
            mesh_path, sample, _ = simjeb._bundle_arrays(
                out_dir, args.n, simjeb.SIMJEB_E, simjeb.SIMJEB_NU, dev,
                "c3d4", StageClock(dev))
        else:
            paths = synthesize_simjeb_bundle(out_dir, n=args.n,
                                             device=args.device)
            mesh_path, h5_path = paths["mesh"], paths["h5"]
        print(f"bundle at {out_dir} ({time.time() - t0:.1f} s)")

    t0 = time.time()
    if sample is None:
        metrics = run_simjeb_workload(mesh_path, h5_path, device=args.device,
                                      out_path=out_path)
    else:
        metrics = simjeb._run_mesh_file(
            mesh_path, sample, etype=None, dev=dev,
            stages=StageClock(dev), E=simjeb.SIMJEB_E,
            nu=simjeb.SIMJEB_NU, tol=1e-6, max_iter=2000, warm_start=True,
            out_path=out_path, verbose=True)
    print(f"workload wall time: {time.time() - t0:.1f} s")
    ok = metrics["residual_solve"] <= 1.05 * metrics["residual_truth"] + \
        1e-6 * metrics["residual_zero"]
    print("ACCEPTED" if ok else "NOT CONVERGED")
    return metrics, ok


if __name__ == "__main__":
    main()
