"""End-to-end static solve: c3d10 cantilever under gravity, stress output.

The port of tpufem's examples/static_cantilever.py.  Mirrors the reference
solver_example.ipynb flow (mesh -> stiffness -> constrained CG -> nodal
von Mises -> export) on generated data: box_tet10(6, 6, 18) over a
0.5 x 0.5 x 2 beam fixed at z = 0, gravity through the lumped mass, the
element stiffness by the fused kernel (stiffness_fused on the card), the
matrix-free operator with a Jacobi preconditioner, and the result written
as a legacy .vtk file.  Float32 on the card, float64 on the CPU (tpufem's
rule: float32 on its chip, float64 elsewhere).

Run: python -m tpufem_torch.examples.static_cantilever [--device cpu]
     [--out result.vtk]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

import tpufem_torch as tt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "cantilever_result.vtk"))
    args = ap.parse_args(argv)
    dev = tt.resolve_device(args.device)

    E, nu, rho = 200e9, 0.3, 7800.0
    coords, conn = tt.meshgen.box_tet10(6, 6, 18, 0.5, 0.5, 2.0)
    N, M = coords.shape[0], conn.shape[0]
    print(f"mesh: {N} nodes, {M} c3d10 elements")

    np_dtype = np.float32 if dev.type == "cuda" else np.float64
    dtype = torch.float32 if dev.type == "cuda" else torch.float64
    cj = torch.as_tensor(coords, device=dev).to(dtype)
    conn_t = torch.as_tensor(conn, device=dev)
    plan = tt.ScatterPlan.build(conn, N, 3, device=dev)
    fixed = tt.meshgen.boundary_nodes(coords, 2, 0.0)
    cons = tt.Constraints.fixed(N, fixed, 3, dtype=np_dtype)

    # gravity load via lumped mass
    Mlump = tt.solid.lumped_mass(cj, conn_t, "c3d10", rho)
    g_elem = torch.zeros((M, 30), dtype=dtype, device=dev)
    g_elem[:, 2::3] = -9.81 * Mlump[:, 2::3]
    b = plan.scatter(g_elem).reshape(N, 3)

    t0 = time.time()
    K = tt.solid.stiffness(cj, conn_t, "c3d10", E, nu)
    op = tt.MatrixFreeOperator(K, plan)
    Minv = tt.diagonal_preconditioner([op])
    u, info = tt.cg(op, b, constraints=cons, M_inv=Minv, tol=1e-6,
                    max_iter=4000)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"solve: {time.time() - t0:.2f}s  status={int(info.status)} "
          f"iters={int(info.iterations)} ||r||={float(info.residual_norm):.3e}")

    tens, vm = tt.solid.element_stress(cj, conn_t, u, "c3d10", E, nu)
    nvm = tt.solid.node_vm_stress(N, conn_t, vm)
    tip = int(np.argmax(coords[:, 2]))
    uz = float(u[tip, 2])
    print(f"tip deflection uz = {uz:.4e} m, max nodal vM = "
          f"{tt.human_readable_number(float(nvm.max()))} Pa")

    tt.vtk_io.write_vtk(args.out, coords, {"c3d10": conn},
                        point_data={"displacement": u, "von_mises": nvm})
    print(f"wrote {args.out}")
    return info, uz


if __name__ == "__main__":
    main()
