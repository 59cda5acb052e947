"""The modal solve's accuracy against its outer and inner iteration counts.

On box_tet10(n) (z = 0 fixed), f64, the packed operator with scalar
Jacobi, lumped mass at rho = 7800: PackedSystem.modal's iteration (5 modes
and 2 guard vectors, inner PCG to tol 1e-8) run step by step, for each
inner limit in turn from the same start block.  After every outer step it
prints the Ritz values and each mode's f64 eigen-residual
||K phi - lam M phi|| / (lam ||M phi||) (K by refine.F64Operator), as
phase 12 of chip_smoke.py computes them after its last step.  Prints one
JSON object per line and needs the card.

Usage: python -m tpufem_torch.scripts.modal_sweep [n=55]
           [inner:outer ...]        (default 400:20 800:16 1000:12)
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

E, NU, RHO = 200e9, 0.3, 7800.0
NUM_EIGS, N_GUARD = 5, 2


def main(argv) -> None:
    import tpufem_torch as tt
    from tpufem_torch.ops.packed import ROW
    from tpufem_torch.solvers.modal import subspace_steps

    n = int(argv[0]) if argv else 55
    runs = [tuple(int(x) for x in a.split(":")) for a in argv[1:]] or [
        (400, 20), (800, 16), (1000, 12)]
    dev = tt.resolve_device(None)
    f64 = torch.float64
    coords, conn = tt.meshgen.box_tet10(n, n, n)
    N = coords.shape[0]
    fixed = tt.meshgen.boundary_nodes(coords, 2, 0.0)
    op = tt.PackedPartialOperator.build(coords, conn, "c3d10", E, NU,
                                        n_nodes=N, dtype=f64, device=dev)
    system = tt.PackedSystem(op, fixed_nodes=fixed, precondition="jacobi")
    op64 = tt.F64Operator(coords, conn, "c3d10", E, NU, geometry_dtype=f64,
                          device=dev)
    ct = torch.as_tensor(coords, dtype=f64, device=dev)
    conn_t = torch.as_tensor(conn, device=dev)
    splan = tt.ScatterPlan.build(conn, N, 3, device=dev)
    mass = splan.scatter(tt.solid.lumped_mass(ct, conn_t, "c3d10",
                                              RHO)).reshape(N, 3)
    m3 = torch.ones((N, 3), dtype=f64, device=dev)
    m3[torch.as_tensor(fixed, device=dev).long()] = 0.0
    plan = op.plan
    nb = plan.meta.n_blocks
    Mdiag = system.mass_packed(mass)
    print(json.dumps({"mesh": f"box_tet10({n})", "nodes": int(N),
                      "elements": int(conn.shape[0]), "runs": runs}),
          flush=True)
    for inner, outer in runs:
        steps = subspace_steps(op, Mdiag, (nb, ROW), NUM_EIGS + N_GUARD,
                               constraints=system.pc, inner_tol=1e-8,
                               inner_max_iter=inner,
                               precondition=system.jacobi)
        next(steps)
        t0 = time.perf_counter()
        for it in range(1, outer + 1):
            lam, X = next(steps)
            res = []
            for j in range(NUM_EIGS):
                phi = plan.unpack(X[:, j].reshape(nb, ROW))
                lj = float(lam[j])
                Mphi = mass * phi
                r = (op64(phi.reshape(-1)).reshape(N, 3) - lj * Mphi) * m3
                res.append(float(torch.linalg.norm(r))
                           / (lj * float(torch.linalg.norm(Mphi * m3))))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(json.dumps({
                "inner_max_iter": inner, "outer": it,
                "seconds": round(time.perf_counter() - t0, 3),
                "ritz": [float(x) for x in lam[:NUM_EIGS]],
                "eigen_residuals": res,
                "max_eigen_residual": max(res)}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
