"""Mixed-precision refined solve: f64-verified residuals at f32 speed.

The port of tpufem's examples/refined_solve.py: f32 packed PCG corrections
(each PCG block a CUDA graph on the card) inside an f64 true-residual
outer loop, on box_tet10(6, 6, 12) over a 1 x 1 x 2 box fixed at z = 0,
shearing the tip (1e3 in x on the z = 2 face) to a 1e-8 true relative
residual.  tpufem_torch.scripts.solve_scale is the same flow at 5.14M and
10.11M elements.

Run: python -m tpufem_torch.examples.refined_solve [--device cpu]
"""
import argparse

import numpy as np
import torch

from tpufem_torch import (PackedPartialOperator, PackedSystem,
                          RefinedSystem, meshgen)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    coords, conn = meshgen.box_tet10(6, 6, 12, 1.0, 1.0, 2.0)
    N = coords.shape[0]
    op = PackedPartialOperator.build(coords, conn, "c3d10", 200e9, 0.3,
                                     n_nodes=N, dtype=torch.float32,
                                     device=args.device)
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    system = PackedSystem(op, fixed_nodes=fixed, precondition="jacobi")
    refined = RefinedSystem(system, coords, conn, "c3d10", 200e9, 0.3)

    tip_nodes = meshgen.boundary_nodes(coords, 2, 2.0)
    b = np.zeros((N, 3), np.float32)
    b[tip_nodes, 0] = 1e3                      # shear the tip

    u, info = refined.solve(
        b, tol_rel=1e-8, inner_tol=1e-2, inner_max_iter=3000,
        progress=lambda cy, it, rr: print(
            f"cycle {cy}: inner iters {it}, TRUE rel residual {rr:.3e}"))
    print(f"converged={info.converged} cycles={info.cycles} "
          f"inner_iterations={info.inner_iterations} "
          f"true rel residual={info.rel_residual:.3e}")
    tip = u.reshape(N, 3)[torch.as_tensor(tip_nodes).long(), 0].cpu()
    print(f"tip ux mean {float(tip.mean()):.4e} (f64-accurate displacement)")
    return info, float(tip.mean())


if __name__ == "__main__":
    main()
