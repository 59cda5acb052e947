"""tpufem_torch: the PyTorch/CUDA port of tpufem for NVIDIA Hopper (H100).

Three paths and three probes are ported, each on hand-written CUDA
kernels:

* the refined packed solve: box meshes, the packed plan, the matrix-free
  partial-assembly operator (kernels fused_yc, combine, compress_gather),
  SPC/RBE2/RBE3 constraints, Jacobi PCG with chunked exact resume, and
  the f64 iterative-refinement outer loop; tpufem's script at 5-10M
  elements (``python -m tpufem_torch.scripts.solve_scale``) and its
  example (``python -m tpufem_torch.examples.refined_solve``);
* the staged packed pipeline (fuse="", any elems_per_cluster: kernels
  expand, compress_gather, combine around the planar element math) under
  block-Jacobi PCG (block_diagonal, BlockJacobi) and the same refinement;
  the planar variant (kernels expand_planar, compress_planar) in
  ops.probe_fused;
* the assembled-stiffness static solve: element stiffness (kernel
  stiffness_fused for k <= 10 types), the scatter-plan and the clustered
  operators (kernels cluster_expand, cluster_compress), Jacobi PCG through
  static_structure_solver; with mass and stress recovery;
* Kirchhoff shells (s3, s4: elements.shell, ShellOperator) and the mixed
  solid + shell driver: static_structure_solver with shell blocks, and
  ops.packed_mixed.PackedMixedSystem for operator="packed" with several
  blocks (the largest solid block on kernels fused_yc, combine and
  compress_gather, the others on stiffness_fused);
* Schur substructuring (solvers.hybrid: build_hybrid, HybridSystem,
  hybrid_solve) with Jacobi, Neumann-Neumann and BDD interface
  preconditioners, on the partitioners of parallel.partition, element
  stiffness by kernel stiffness_fused and the interface PCG as CUDA
  graphs; the geometry-factor operators PartialAssemblyOperator and
  ClusteredPartialOperator (kernels cluster_expand, cluster_compress), BSR
  assembly (ops.assembly) and static_structure_solver(operator="partial");
  the topology tools (topo_faces, topo_edges, topo_diagnostics);
* the rest of the solver family: bicgstab, gmres, newton_raphson,
  modal_solver / naive_modal_solver, masked_cg and the compensated dot
  (cg's dot_dtype="compensated"), also on the packed operator
  (PackedSystem.solve_bicgstab, solve_gmres, modal), and the
  reference-signature entry points of solvers.legacy;
* the probes of tpufem's scripts/: the [64, 32] <-> [16, 128] relayouts
  (ops.probe_reshape; kernels relayout_fwd, relayout_inv), indexed row
  reads against a gather (ops.probe_rowdma; kernel row_accumulate) and
  the planar element layout's write and read (ops.probe_planar_io;
  kernels planar_write, planar_read);
* the reference's end-to-end SimJEB workload (workloads.simjeb:
  synthesize_simjeb_bundle, run_simjeb_workload on kernels fused_yc,
  combine and compress_gather) with the host tools it runs on: VTK and
  SimJEB h5 I/O (io.vtk as vtk_io, io.h5 as h5_io), the plotly viewers
  (viz.plot), utils.format, utils.profiling (timers, roofline counters,
  torch.profiler traces) and utils.checkpoint (npz state,
  checkpointed_cg); and the examples static_cantilever, simjeb_workload
  and packed_solve;
* the four distributed systems of parallel/ (dist.DistFEM, halo.HaloFEM,
  halo_partial.HaloPartialFEM, packed_dist.PackedHaloFEM: the last on
  kernels expand, compress_gather and combine per part) on a part mesh:
  PartMesh holds P parts as a leading axis on one device (every
  collective a fixed-order tensor operation, the PCG blocks CUDA graphs),
  GroupMesh one part per rank of a torch.distributed process group
  (NCCL or gloo, eager), the two bitwise equal; the host cost model
  scripts.dist_cost_model and the example distributed_solve.

Every PCG and BiCGStab solve runs its loop in 32-iteration blocks, and
GMRES each restart cycle, that the card replays as CUDA graphs
(solvers.cg.CGBlock, solvers.bicgstab.BiCGStabBlock,
solvers.gmres.GMRESCycle).

The JAX package ``tpufem`` stays the reference; nothing here imports it.
Entry points (the plans' and operators' build functions, PackedSystem,
RefinedSystem, static_structure_solver, the workload) run on the CUDA
card unless the caller passes ``device="cpu"``, which runs every kernel's
plain PyTorch version instead.

TF32 is off: float32 matrix products (the Jacobian einsums, the element
GEMV) and cuDNN convolutions run in full float32, the analogue of
tpufem's Precision.HIGHEST contractions on the TPU.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.device import resolve_device  # noqa: E402
from .core.dtypes import enable_x64  # noqa: E402
from .core.voigt import stress_tensor, stress_vector, von_mises  # noqa: E402
from .core.materials import (elasticity_matrix,  # noqa: E402
                             kirchhoff_D_matrix, lame_parameters)
from .elements import dispatch, shell, solid  # noqa: E402
from .elements.shell import (ShellOperator, local_frames,  # noqa: E402
                             shell_nodal_forces, shell_postprocess_values,
                             shell_stiffness, shell_stress)
from .elements.tables import ElementTable, element_table  # noqa: E402
from .ops import assembly, cuda  # noqa: E402
from .ops.assembly import (BSRMatrix, BSRStructure,  # noqa: E402
                           assemble_bsr, assemble_dense, bsr_matvec,
                           build_bsr_structure, to_scipy)
from .ops.cluster_kernels import (CLUSTER_COMPRESS, CLUSTER_EXPAND,  # noqa: E402
                                  cluster_compress, cluster_expand,
                                  cluster_spmv)
from .ops.clustered import (ClusteredOperator,  # noqa: E402
                            ClusteredPartialOperator, ClusterPlan)
from .ops.fused_kernels import FUSED_YC, fused_yc  # noqa: E402
from .ops.operator import (MatrixFreeOperator, block_operator,  # noqa: E402
                           diagonal_preconditioner, nodal_forces)
from .ops import probe_fused  # noqa: E402
from .ops.probe_kernels import (PLANAR_READ, PLANAR_WRITE,  # noqa: E402
                                RELAYOUT_FWD, RELAYOUT_INV, ROW_ACCUMULATE,
                                planar_read, planar_write, relayout_fwd,
                                relayout_inv, row_accumulate)
from .ops.packed import (BlockJacobi, PackedConstraints,  # noqa: E402
                         PackedPartialOperator, PackedPlan, PackedSystem,
                         block_apply, invert_block_planes)
from .ops.packed_mixed import (MixedConstraints,  # noqa: E402
                               PackedMixedOperator, PackedMixedSystem)
from .ops.packed_kernels import (COMBINE, COMPRESS_GATHER,  # noqa: E402
                                 COMPRESS_PLANAR, EXPAND, EXPAND_PLANAR,
                                 combine, compress_gather, compress_planar,
                                 expand, expand_planar)
from .ops.partial import PartialAssemblyOperator  # noqa: E402
from .ops.scatter import CombinePlan, ScatterPlan  # noqa: E402
from .ops.stiffness_kernels import STIFFNESS_FUSED, stiffness_fused  # noqa: E402
from .solvers import legacy, modal  # noqa: E402
from .solvers.bicgstab import bicgstab  # noqa: E402
from .solvers.cg import SolveInfo, cg, comp_vdot, masked_cg  # noqa: E402
from .solvers.cg_fused import (CG_PAP, CG_UPDATE_P,  # noqa: E402
                               CG_UPDATE_R)
from .solvers.constraints import Constraints  # noqa: E402
from .solvers.gmres import gmres  # noqa: E402
from .solvers.hybrid import (HybridSystem, build_hybrid,  # noqa: E402
                             hybrid_solve)
from .solvers.modal import (lumped_mass_diagonal, modal_solver,  # noqa: E402
                            naive_modal_solver)
from .solvers.newton import newton_raphson  # noqa: E402
from .solvers.refine import F64Operator, RefinedSystem, RefineInfo  # noqa: E402
from .solvers.static import (StaticModel, build_static_model,  # noqa: E402
                             static_structure_solver)
from .parallel import dist, partition  # noqa: E402
from .parallel.dist import (DistFEM, DistPartition,  # noqa: E402
                            GroupMesh, PartMesh, build_distributed_fem)
from .parallel.halo import HaloFEM, HaloPartition, build_halo_fem  # noqa: E402
from .topology import convert as topo_convert  # noqa: E402
from .topology import diagnostics as topo_diagnostics  # noqa: E402
from .topology import edges as topo_edges  # noqa: E402
from .topology import faces as topo_faces  # noqa: E402
from .utils import meshgen  # noqa: E402
from .io import h5 as h5_io  # noqa: E402
from .io import vtk as vtk_io  # noqa: E402
from .utils.format import human_readable_number  # noqa: E402
from .workloads import (run_simjeb_workload,  # noqa: E402
                        synthesize_simjeb_bundle)

# the CUDA kernels of the refined packed solve, in the order of the apply
PACKED_KERNELS = (FUSED_YC, COMBINE, COMPRESS_GATHER)
# the CUDA kernels of the assembled-stiffness static solve
STATIC_KERNELS = (STIFFNESS_FUSED, CLUSTER_EXPAND, CLUSTER_COMPRESS)
# the CUDA kernels the staged and planar packed pipelines add (the staged
# apply also runs COMPRESS_GATHER and COMBINE)
STAGED_KERNELS = (EXPAND, EXPAND_PLANAR, COMPRESS_PLANAR)
# the CUDA kernels of the three probes
PROBE_KERNELS = (RELAYOUT_FWD, RELAYOUT_INV, ROW_ACCUMULATE, PLANAR_WRITE,
                 PLANAR_READ)
# the CUDA kernels of cg's fused iteration (solvers.cg_fused), in launch
# order
SOLVER_KERNELS = (CG_PAP, CG_UPDATE_R, CG_UPDATE_P)
# every CUDA kernel of the package
KERNELS = (PACKED_KERNELS + STATIC_KERNELS + STAGED_KERNELS + PROBE_KERNELS
           + SOLVER_KERNELS)

__all__ = [
    "BSRMatrix", "BSRStructure", "BlockJacobi", "CG_PAP", "CG_UPDATE_P",
    "CG_UPDATE_R", "CLUSTER_COMPRESS",
    "CLUSTER_EXPAND", "COMBINE", "COMPRESS_GATHER", "COMPRESS_PLANAR",
    "ClusterPlan", "ClusteredOperator", "ClusteredPartialOperator",
    "CombinePlan", "Constraints", "DistFEM", "DistPartition", "EXPAND",
    "EXPAND_PLANAR", "ElementTable", "F64Operator", "FUSED_YC", "GroupMesh", "HaloFEM",
    "HaloPartition", "HybridSystem", "KERNELS",
    "MatrixFreeOperator", "MixedConstraints", "PACKED_KERNELS",
    "PLANAR_READ", "PLANAR_WRITE", "PROBE_KERNELS", "PackedConstraints",
    "PackedMixedOperator", "PackedMixedSystem", "PackedPartialOperator",
    "PackedPlan", "PackedSystem", "PartMesh", "PartialAssemblyOperator",
    "RELAYOUT_FWD", "RELAYOUT_INV", "ROW_ACCUMULATE", "RefineInfo",
    "RefinedSystem", "SOLVER_KERNELS", "STAGED_KERNELS", "STATIC_KERNELS",
    "STIFFNESS_FUSED",
    "ScatterPlan", "ShellOperator", "SolveInfo", "StaticModel",
    "assemble_bsr", "assemble_dense", "assembly", "bicgstab",
    "block_apply", "block_operator", "bsr_matvec", "build_bsr_structure",
    "build_distributed_fem", "build_halo_fem", "build_hybrid",
    "build_static_model", "cg", "cluster_compress",
    "cluster_expand", "cluster_spmv", "combine", "comp_vdot",
    "compress_gather", "compress_planar", "cuda",
    "diagonal_preconditioner", "dispatch", "dist", "elasticity_matrix",
    "element_table", "enable_x64", "expand", "expand_planar", "fused_yc",
    "gmres", "h5_io", "human_readable_number", "hybrid_solve",
    "invert_block_planes", "kirchhoff_D_matrix", "lame_parameters",
    "legacy", "local_frames", "lumped_mass_diagonal", "masked_cg",
    "meshgen", "modal", "modal_solver", "naive_modal_solver",
    "newton_raphson", "nodal_forces", "partition", "planar_read",
    "planar_write", "probe_fused", "relayout_fwd", "relayout_inv",
    "resolve_device", "row_accumulate", "run_simjeb_workload", "shell",
    "shell_nodal_forces", "shell_postprocess_values", "shell_stiffness",
    "shell_stress", "solid", "static_structure_solver", "stiffness_fused",
    "stress_tensor", "stress_vector", "synthesize_simjeb_bundle",
    "to_scipy", "topo_convert", "topo_diagnostics", "topo_edges",
    "topo_faces", "von_mises", "vtk_io",
]
