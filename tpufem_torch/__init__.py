"""tpufem_torch: the PyTorch/CUDA port of tpufem for NVIDIA Hopper (H100).

Two paths are ported, each on hand-written CUDA kernels:

* the refined packed c3d10 solve: box meshes, the packed plan, the
  matrix-free partial-assembly operator (kernels fused_yc, combine,
  compress_gather), Jacobi PCG with chunked exact resume, and the f64
  iterative-refinement outer loop;
* the assembled-stiffness static solve: element stiffness (kernel
  stiffness_fused for k <= 10 types), the scatter-plan and the clustered
  operators (kernels cluster_expand, cluster_compress), Jacobi PCG through
  static_structure_solver; with mass and stress recovery.

The JAX package ``tpufem`` stays the reference; nothing here imports it.
Entry points (the plans' and operators' build functions, PackedSystem,
RefinedSystem, static_structure_solver) run on the CUDA card unless the
caller passes ``device="cpu"``, which runs every kernel's plain PyTorch
version instead.

TF32 is off: float32 matrix products (the Jacobian einsums, the element
GEMV) and cuDNN convolutions run in full float32, the analogue of
tpufem's Precision.HIGHEST contractions on the TPU.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.device import resolve_device  # noqa: E402
from .core.materials import elasticity_matrix, lame_parameters  # noqa: E402
from .elements import solid  # noqa: E402
from .elements.tables import ElementTable, element_table  # noqa: E402
from .ops import cuda  # noqa: E402
from .ops.cluster_kernels import (CLUSTER_COMPRESS, CLUSTER_EXPAND,  # noqa: E402
                                  cluster_compress, cluster_expand,
                                  cluster_spmv)
from .ops.clustered import ClusteredOperator, ClusterPlan  # noqa: E402
from .ops.fused_kernels import FUSED_YC, fused_yc  # noqa: E402
from .ops.operator import (MatrixFreeOperator, block_operator,  # noqa: E402
                           diagonal_preconditioner, nodal_forces)
from .ops.packed import (PackedConstraints, PackedPartialOperator,  # noqa: E402
                         PackedPlan, PackedSystem)
from .ops.packed_kernels import (COMBINE, COMPRESS_GATHER, combine,  # noqa: E402
                                 compress_gather)
from .ops.scatter import CombinePlan, ScatterPlan  # noqa: E402
from .ops.stiffness_kernels import STIFFNESS_FUSED, stiffness_fused  # noqa: E402
from .solvers.cg import SolveInfo, cg  # noqa: E402
from .solvers.constraints import Constraints  # noqa: E402
from .solvers.refine import F64Operator, RefinedSystem, RefineInfo  # noqa: E402
from .solvers.static import (StaticModel, build_static_model,  # noqa: E402
                             static_structure_solver)
from .utils import meshgen  # noqa: E402

# the CUDA kernels of the refined packed solve, in the order of the apply
PACKED_KERNELS = (FUSED_YC, COMBINE, COMPRESS_GATHER)
# the CUDA kernels of the assembled-stiffness static solve
STATIC_KERNELS = (STIFFNESS_FUSED, CLUSTER_EXPAND, CLUSTER_COMPRESS)
# every CUDA kernel of the package
KERNELS = PACKED_KERNELS + STATIC_KERNELS

__all__ = [
    "CLUSTER_COMPRESS", "CLUSTER_EXPAND", "COMBINE", "COMPRESS_GATHER",
    "ClusterPlan", "ClusteredOperator", "CombinePlan", "Constraints",
    "ElementTable", "F64Operator", "FUSED_YC", "KERNELS",
    "MatrixFreeOperator", "PACKED_KERNELS", "PackedConstraints",
    "PackedPartialOperator", "PackedPlan", "PackedSystem", "RefineInfo",
    "RefinedSystem", "STATIC_KERNELS", "STIFFNESS_FUSED", "ScatterPlan",
    "SolveInfo", "StaticModel", "block_operator", "build_static_model", "cg",
    "cluster_compress", "cluster_expand", "cluster_spmv", "combine",
    "compress_gather", "cuda", "diagonal_preconditioner",
    "elasticity_matrix", "element_table", "fused_yc", "lame_parameters",
    "meshgen", "nodal_forces", "resolve_device", "solid",
    "static_structure_solver", "stiffness_fused",
]
