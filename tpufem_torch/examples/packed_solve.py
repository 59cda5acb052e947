"""The packed fast path: scalar- and block-Jacobi PCG, then the same
solve on a part mesh.

The port of tpufem's examples/packed_solve.py.  The packed
operator (ops.packed) is the fast SpMV of this framework: dense [rows,
384] tiles, geometry factors instead of element stiffness, kernels
fused_yc and combine in every apply.  PackedSystem wraps it with
constraints and a scalar- (diagonal by compress_gather) or 3x3
node-block-Jacobi preconditioner, each PCG block a CUDA graph on the
card.  The sharded half runs parallel.packed_dist.PackedHaloFEM (block
Jacobi) on a PartMesh of --parts parts of one device: kernels expand,
compress_gather and combine per part on its remapped tables.

    python -m tpufem_torch.examples.packed_solve [n] [--parts 4]
                                                 [--device cpu]
                                                 # 6 n^2 * 2n c3d10 elements

Float32 unless float64 is torch's default floating type.
"""
import argparse
import time

import numpy as np
import torch

from tpufem_torch.ops.packed import PackedPartialOperator, PackedSystem
from tpufem_torch.utils import meshgen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--parts", type=int, default=4,
                    help="parts of the sharded solve's part mesh")
    args = ap.parse_args(argv)
    n = args.n
    coords, conn = meshgen.box_tet10(n, n, 2 * n, 1.0, 1.0, 2.0)
    N, (M, k) = coords.shape[0], conn.shape
    print(f"mesh: {M} c3d10 elements, {N} nodes")

    dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
             else torch.float32)
    t0 = time.time()
    op = PackedPartialOperator.build(coords, conn, "c3d10", 200e9, 0.3,
                                     n_nodes=N, dtype=dtype,
                                     device=args.device)
    print(f"operator build: {time.time() - t0:.2f} s "
          f"(geometry factors only — no element stiffness)")

    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3), np.float32)
    b[meshgen.boundary_nodes(coords, 2, 2.0), 2] = -1e3

    out = {}
    for precond in ("jacobi", "block"):
        sys_ = PackedSystem(op, fixed_nodes=fixed, precondition=precond)
        t0 = time.time()
        u, info = sys_.solve(b, tol=1e-6, max_iter=20000)
        uz = float(u[:, 2].min())
        print(f"{precond:7s}: status={int(info.status)} "
              f"iters={int(info.iterations)} "
              f"solve={time.time() - t0:.2f} s "
              f"tip uz={uz:.3e}")
        out[precond] = (info, uz)

    # the same solve, sharded over the parts of a part mesh
    from tpufem_torch.parallel.dist import PartMesh
    from tpufem_torch.parallel.packed_dist import build_packed_halo_fem

    mesh = PartMesh(args.parts, device=args.device)
    fem, part = build_packed_halo_fem(coords, conn, "c3d10", 200e9, 0.3,
                                      mesh=mesh, fixed_nodes=fixed,
                                      dtype=dtype, precondition="block")
    bX = part.pack_np(b.astype(np.float64 if dtype == torch.float64
                               else np.float32))
    uX, info = fem.pcg(bX, tol=1e-6, max_iter=20000)
    uz = float(part.unpack_np(fem.gather(uX))[:, 2].min())
    print(f"distributed ({mesh.n_parts} parts): status={int(info.status)} "
          f"iters={int(info.iterations)} tip uz={uz:.3e}")
    out["distributed"] = (info, uz)
    return out


if __name__ == "__main__":
    main()
