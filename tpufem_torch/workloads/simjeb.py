"""The SimJEB-shaped end-to-end workload of the reference notebook.

The port of tpufem/workloads/simjeb.py.  Reproduces
`solver_example.ipynb` cells 3-11 as one runnable pipeline with the
notebook's de-facto acceptance metric:

    cell 3   load mesh (.vtk/.vtu) + h5 sample (forces/rbe2/rbe3/outputs)
    cell 4   F_target: zeros except the rbe3 load nodes, which carry
             [0, 0, f] with f read from the operator applied to the
             ground-truth displacement
    cells 6/8  anchor residual sums  sum_n ||(A u - F_target)_n||, rows
             zeroed at the rbe2 (fixed) nodes — evaluated at the ground
             truth ("참값의 오차") and at zero displacement ("변위 0의 오차")
    cell 10  constrained PCG solve (rbe2 pinned, warm-started at outputs)
    cell 11  residual sum of the solution (the acceptance number)

plus the postprocess/diagnostics the reference performs elsewhere:
element/nodal von Mises recovery (solver/element.py:466-504) and the
shared-face force equilibrium check (solver/element.py:3343-3383).

The solve path is the packed operator (ops.packed: kernels fused_yc and
combine in every apply, compress_gather in the Jacobi diagonal) with its
PCG blocks replayed as CUDA graphs on the card.  Both entry points run on
the CUDA card unless given device="cpu"; the working type is float64
when that is torch's default floating type (core.dtypes.enable_x64),
else float32.  `timings`, when given a dict, receives the seconds of each
stage (the device synchronized at each stage's end).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..utils.profiling import StageClock

# SimJEB material (solver_example.ipynb cell 2)
SIMJEB_E = 113.8e9
SIMJEB_NU = 0.342


def _working_dtype() -> torch.dtype:
    """tpufem's jax_enable_x64 test, in torch's terms."""
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _synthesize_arrays(n: int, E: float, nu: float, dev: torch.device,
                       etype: str, stages: StageClock):
    """The bundle's arrays: (coords, conn, rbe2, rbe3, F_target, u, info)
    with u the converged constrained PCG solution for the tip load."""
    from ..ops.packed import PackedPartialOperator, PackedSystem
    from ..utils import meshgen

    gen = meshgen.box_tet10 if etype == "c3d10" else meshgen.box_tet
    coords, conn = gen(n, n, 2 * n, 1.0, 1.0, 2.0)
    N = coords.shape[0]
    rbe2 = np.asarray(meshgen.boundary_nodes(coords, 2, 0.0))
    rbe3 = np.asarray(meshgen.boundary_nodes(coords, 2, 2.0))
    stages.tick("mesh")

    op = PackedPartialOperator.build(coords, conn, etype, E, nu, n_nodes=N,
                                     dtype=_working_dtype(), device=dev)
    F_target = np.zeros((N, 3))
    F_target[rbe3, 2] = -1e4
    system = PackedSystem(op, fixed_nodes=rbe2)
    stages.tick("synthesis_build")
    u, info = system.solve(F_target, tol=1e-8 * float(
        np.linalg.norm(F_target)), max_iter=4000)
    u = u.cpu().numpy()
    stages.tick("synthesis_solve")
    return coords, conn, rbe2, rbe3, F_target, u, info


def _bundle_arrays(out_dir: str, n: int, E: float, nu: float,
                   dev: torch.device, etype: str, stages: StageClock):
    """The bundle's mesh.vtu, written, and its sample's datasets, in
    memory: (mesh path, {"forces", "rbe2", "rbe3", "outputs"}, the
    synthesis PCG's SolveInfo)."""
    from ..io import vtk

    coords, conn, rbe2, rbe3, F_target, u, info = _synthesize_arrays(
        n, E, nu, dev, etype, stages)
    os.makedirs(out_dir, exist_ok=True)
    mesh_path = os.path.join(out_dir, "mesh.vtu")
    vtk.write_vtu(mesh_path, coords, {etype: conn})
    stages.tick("vtu_write")
    N = coords.shape[0]
    outputs = np.zeros((N, 1, 6))
    outputs[:, 0, :3] = u
    forces = np.zeros((N, 6))
    forces[:, :3] = F_target
    return mesh_path, {"forces": forces, "rbe2": rbe2, "rbe3": rbe3,
                       "outputs": outputs}, info


def synthesize_simjeb_bundle(out_dir: str, n: int = 6, *,
                             E: float = SIMJEB_E, nu: float = SIMJEB_NU,
                             device=None, etype: str = "c3d4",
                             timings: Optional[dict] = None) -> Dict:
    """Write a synthetic SimJEB-shaped (mesh.vtu, sample_0.h5) pair.

    The geometry is a box bracket: the rbe2 set is the clamped base ring
    (z = 0), the rbe3 set the load-introduction nodes (z = max).  The
    ground-truth 'outputs' displacement is a converged constrained PCG
    solution for a tip load, so the bundle has the same structure and
    consistency properties as a real SimJEB sample.  Returns tpufem's
    {"mesh", "h5", "etype"} and the synthesis PCG's "status" and
    "iterations".
    """
    import h5py

    from ..core.device import resolve_device

    dev = resolve_device(device)
    stages = StageClock(dev, timings)
    mesh_path, sample, info = _bundle_arrays(out_dir, n, E, nu, dev, etype,
                                             stages)
    h5_path = os.path.join(out_dir, "sample_0.h5")
    with h5py.File(h5_path, "w") as f:
        for key in ("forces", "rbe2", "rbe3", "outputs"):
            f[key] = sample[key]
    stages.tick("h5_write")
    return {"mesh": mesh_path, "h5": h5_path, "etype": etype,
            "status": int(info.status), "iterations": int(info.iterations)}


def run_simjeb_workload(mesh_path: str, h5_path: str, *,
                        etype: Optional[str] = None,
                        E: float = SIMJEB_E, nu: float = SIMJEB_NU,
                        tol: float = 1e-6, max_iter: int = 2000,
                        warm_start: bool = True, device=None,
                        out_path: Optional[str] = None,
                        verbose: bool = True,
                        timings: Optional[dict] = None) -> Dict[str, float]:
    """Run the notebook workload end to end; returns the metric dict.

    Metrics (all host floats):
      residual_truth — cell 6 anchor (sum of row norms at ground truth)
      residual_zero  — cell 8 anchor (at zero displacement)
      residual_solve — cell 11 acceptance number for our solution
      vm_max         — max nodal von Mises stress
      equilibrium    — max interior-face force-balance violation,
                       relative to the largest face force
      iterations     — PCG iterations
    """
    from ..core.device import resolve_device
    from ..io import h5 as h5io

    dev = resolve_device(device)
    stages = StageClock(dev, timings)
    sample = h5io.load_simjeb_sample(h5_path)
    return _run_mesh_file(mesh_path, sample, etype=etype, E=E, nu=nu,
                          tol=tol, max_iter=max_iter, warm_start=warm_start,
                          dev=dev, out_path=out_path, verbose=verbose,
                          stages=stages)


def _run_mesh_file(mesh_path: str, sample: Dict[str, np.ndarray], *,
                   etype: Optional[str], dev: torch.device,
                   stages: StageClock, **kw) -> Dict[str, float]:
    """The workload from the mesh file and the sample's datasets (cell 3's
    mesh ingest, then _run_arrays)."""
    from ..io import vtk

    coords, blocks = (vtk.read_vtu(mesh_path)
                      if mesh_path.lower().endswith(".vtu")
                      else vtk.read_vtk(mesh_path))
    if etype is None:
        (etype, conn), = blocks.items()
    else:
        conn = blocks[etype]
    stages.tick("read")
    return _run_arrays(coords, conn, etype, sample, dev=dev, stages=stages,
                       **kw)


def _run_arrays(coords: np.ndarray, conn: np.ndarray, etype: str,
                sample: Dict[str, np.ndarray], *, E: float, nu: float,
                tol: float, max_iter: int, warm_start: bool,
                dev: torch.device, out_path: Optional[str], verbose: bool,
                stages: StageClock) -> Dict[str, float]:
    """The workload after ingest (cells 4-11 and the postprocess), from
    the mesh's arrays and the sample's {"rbe2", "rbe3", "outputs"}."""
    from ..elements.solid import element_stress, node_vm_stress
    from ..io import vtk
    from ..ops.packed import PackedPartialOperator, PackedSystem
    from ..topology.diagnostics import (element_face_forces,
                                        shared_face_force_residual)
    from ..utils.format import human_readable_number

    rbe2 = np.asarray(sample["rbe2"]).reshape(-1)
    rbe3 = np.asarray(sample["rbe3"]).reshape(-1)
    outputs = np.asarray(sample["outputs"])[:, 0, :3]
    N = coords.shape[0]

    dtype = _working_dtype()
    op = PackedPartialOperator.build(coords, conn, etype, E, nu, n_nodes=N,
                                     dtype=dtype, device=dev)
    plan = op.plan

    def nodal_forces(u):
        return plan.unpack(op(plan.pack(torch.as_tensor(
            u, dtype=dtype, device=dev)))).cpu().numpy()

    # cell 4: F_target from the operator response at the ground truth
    F_gt = nodal_forces(outputs)
    f = float(F_gt[rbe3[0], 2])
    F_target = np.zeros((N, 3))
    F_target[rbe3] = (0.0, 0.0, f)

    def residual_sum(u):
        """cells 6/8/11: sum of row norms, rbe2 rows zeroed."""
        r = np.linalg.norm(nodal_forces(u) - F_target, axis=-1)
        r[rbe2] = 0.0
        return float(r.sum())

    residual_truth = residual_sum(outputs)
    residual_zero = residual_sum(np.zeros((N, 3)))

    # cell 10: constrained PCG (rbe2 pinned), warm-started at the outputs
    system = PackedSystem(op, fixed_nodes=rbe2)
    stages.tick("operator")
    u, info = system.solve(F_target,
                           x0=outputs if warm_start else None,
                           tol=tol * float(np.linalg.norm(F_target)),
                           max_iter=max_iter)
    u = u.cpu().numpy()
    stages.tick("solve")
    residual_solve = residual_sum(u)

    # postprocess: element/nodal von Mises + equilibrium diagnosis
    coords_t = torch.as_tensor(coords, device=dev).to(dtype)
    conn_t = torch.as_tensor(conn, device=dev)
    tensors, vm = element_stress(coords_t, conn_t,
                                 torch.as_tensor(u, device=dev).to(dtype),
                                 etype, E, nu, single=True)
    nvm = node_vm_stress(N, conn_t, vm).cpu().numpy()
    tensors = tensors.cpu().numpy()
    del coords_t, conn_t, vm
    stages.tick("stress")
    ff = element_face_forces(coords, conn, etype, tensors)
    res = shared_face_force_residual(conn, etype, ff)
    # stress-jump indicator: exact only in the refinement limit (the
    # reference checks it on converged SimJEB meshes); max is dominated
    # by the load-introduction corners, the mean is the mesh-wide number
    scale = float(np.linalg.norm(ff, axis=-1).max())
    equilibrium = float(np.linalg.norm(res, axis=-1).max() / max(scale,
                                                                 1e-30))
    equilibrium_mean = float(np.linalg.norm(res, axis=-1).mean()
                             / max(float(np.linalg.norm(ff, axis=-1).mean()),
                                   1e-30))
    stages.tick("faces")

    if out_path:
        vtk.write_vtu(out_path, coords, {etype: conn},
                      point_data={"displacement": u, "von_mises": nvm})
        stages.tick("result_write")

    metrics = {
        "residual_truth": residual_truth,
        "residual_zero": residual_zero,
        "residual_solve": residual_solve,
        "vm_max": float(nvm.max()),
        "equilibrium": equilibrium,
        "equilibrium_mean": equilibrium_mean,
        "iterations": int(info.iterations),
        "status": int(info.status),
    }
    if verbose:
        print(f"mesh: {conn.shape[0]} {etype} elements, {N} nodes; "
              f"|rbe2|={rbe2.size} |rbe3|={rbe3.size}")
        print("참값의 오차 (residual at ground truth):  "
              + human_readable_number(residual_truth))
        print("변위 0의 오차 (residual at zero):        "
              + human_readable_number(residual_zero))
        print(f"PCG: status={metrics['status']} "
              f"iters={metrics['iterations']}")
        print("solution residual sum (acceptance):     "
              + human_readable_number(residual_solve))
        print(f"max nodal von Mises: {metrics['vm_max']:.4e}")
        print(f"interior-face equilibrium violation: {equilibrium:.2e} "
              "(relative)")
    return metrics
