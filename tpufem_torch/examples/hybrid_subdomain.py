"""Hybrid iterative + direct subdomain solve (the subdivision.ipynb
workload, with the outer interface iteration).

The port of tpufem's examples/hybrid_subdomain.py: box_tet(8) c3d4 fixed
at z = 0, -1e5 in z on the top face, the part count from the reference's
memory-budget heuristic unless given, Jacobi interface PCG.

Run: python -m tpufem_torch.examples.hybrid_subdomain [n_parts]
         [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from tpufem_torch import build_hybrid, meshgen
from tpufem_torch.parallel.partition import compute_subdivisions


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_parts", type=int, nargs="?", default=None)
    ap.add_argument("--device", default=device,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    coords, conn = meshgen.box_tet(8, 8, 8)
    N, M = coords.shape[0], conn.shape[0]
    n_parts = args.n_parts
    if n_parts is None:
        # the reference's memory-budget heuristic (subdivision.ipynb cell 7)
        n_parts = max(2, compute_subdivisions(N * 3, memory_gb=0.001))
    print(f"mesh: {N} nodes, {M} c3d4 elements, {n_parts} subdomains")
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 1.0), 2] = -1e5

    t0 = time.time()
    sys_ = build_hybrid(coords, conn, "c3d4", 200e9, 0.3, n_parts,
                        fixed_nodes=fixed, device=args.device)
    print(f"setup (partition + batched Cholesky): {time.time() - t0:.2f}s; "
          f"interface nodes: {sys_.meta.n_interface}")
    t0 = time.time()
    u, info = sys_.solve(b, tol=1e-10, max_iter=500)
    if u.is_cuda:
        torch.cuda.synchronize()
    print(f"interface CG: {time.time() - t0:.2f}s status={int(info.status)} "
          f"outer iters={int(info.iterations)}")
    print("max |u| =", float(u.abs().max()))
    return u, info


if __name__ == "__main__":
    main()
