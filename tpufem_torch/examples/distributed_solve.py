"""Distributed PCG on a part mesh (the port of tpufem's
examples/distributed_solve.py).

The all-gather distributed system (parallel.dist.DistFEM: element
stiffness by kernel stiffness_fused on the card) on a PartMesh: --parts
parts held as a leading axis on one device, every collective a fixed-order
tensor operation.  Under torchrun, --group runs one part per rank of a
torch.distributed process group instead (GroupMesh: NCCL on the card,
gloo with --device cpu), with the same numbers.

    python -m tpufem_torch.examples.distributed_solve [--parts 8] [--n 8]
                                                      [--device cpu]
    torchrun --nproc-per-node 2 -m tpufem_torch.examples.distributed_solve \
        --group --device cpu
"""
import argparse
import time

import numpy as np
import torch

from tpufem_torch.parallel.dist import (GroupMesh, PartMesh,
                                        build_distributed_fem)
from tpufem_torch.utils import meshgen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--n", type=int, default=8,
                    help="box_tet(n, n, 2n) over 1 x 1 x 2")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--group", action="store_true",
                    help="one part per rank of the process group that "
                    "torchrun's environment describes")
    args = ap.parse_args(argv)
    if args.group:
        import torch.distributed as tdist
        dev = torch.device(args.device or "cuda")
        if not tdist.is_initialized():
            tdist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo")
        mesh = GroupMesh(device=dev)
    else:
        mesh = PartMesh(args.parts, device=args.device)
    print(f"part mesh: {type(mesh).__name__}, {mesh.n_parts} part(s) on "
          f"{mesh.device}")
    n = args.n
    coords, conn = meshgen.box_tet(n, n, 2 * n, 1.0, 1.0, 2.0)
    N = coords.shape[0]
    fixed = meshgen.boundary_nodes(coords, 2, 0.0)
    fem, part = build_distributed_fem(coords, conn, "c3d4", 200e9, 0.3,
                                      mesh=mesh, fixed_nodes=fixed)
    print(f"partitioned over {mesh.n_parts} part(s); "
          f"{part.meta.elems_per_part} elems/part, "
          f"{part.meta.block_rows} owned rows/part")
    b = np.zeros((N, 3))
    b[meshgen.boundary_nodes(coords, 2, 2.0), 0] = 1e6
    t0 = time.time()
    u_new, info = fem.pcg(part.to_new(torch.as_tensor(b, dtype=fem.dtype)),
                          tol=1e-6, max_iter=3000)
    u = part.to_old(fem.gather(u_new)).cpu().numpy()
    print(f"pcg: {time.time() - t0:.2f}s status={int(info.status)} "
          f"iters={int(info.iterations)}")
    print("max |u| =", np.abs(u).max())
    return info, u


if __name__ == "__main__":
    main()
