"""PyTorch/CUDA port of sparse_matrix_math_tpu: the DIA solve path and its
preconditioners.

Load or build a CSR matrix on a device, then solve with :func:`cg` or
:func:`bicgstab`, optionally preconditioned (Jacobi, SGS, IC0, ILU0), and
get a :class:`SolveResult` back.  A large CSR matrix on a CUDA device is
routed to DIA; every iteration's matvec is the hand-written DIA kernel in
``csrc/dia_spmv.cu``, and every SGS, IC0 or ILU0 apply one call of the
fused sweep kernels in ``csrc/trisweep.cu``.  Public names follow the JAX
package.
"""

from .formats import (
    COOArrays,
    CSRMatrix,
    DIAMatrix,
    PerformanceWarning,
    auto_route_for_solve,
    coo_from_arrays,
    csr_from_coo,
    dia_from_csr,
    try_dia_from_csr,
)
from .io import MatrixLoadStatus, MatrixMarketError, load_matrix_csr
from .ops import dot, norm2, rmult, rmult_add, rmult_sub
from .precond import (
    FactorizationError,
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
    SolverPreconditioner,
    get_preconditioner,
)
from .solvers import SolveResult, SolverStatus, bicgstab, cg, conjugate_gradient
from .utils import (
    convection_diffusion_2d,
    laplace_1d,
    poisson_2d,
    poisson_3d,
    poisson_3d_27pt,
)

__all__ = [
    "COOArrays", "CSRMatrix", "DIAMatrix", "PerformanceWarning", "auto_route_for_solve",
    "coo_from_arrays", "csr_from_coo", "dia_from_csr", "try_dia_from_csr",
    "MatrixLoadStatus", "MatrixMarketError", "load_matrix_csr",
    "dot", "norm2", "rmult", "rmult_add", "rmult_sub",
    "FactorizationError", "IdentityPreconditioner", "JacobiPreconditioner",
    "SGSPreconditioner", "ILU0Preconditioner", "IC0Preconditioner", "SolverPreconditioner",
    "get_preconditioner",
    "SolveResult", "SolverStatus", "bicgstab", "cg", "conjugate_gradient",
    "convection_diffusion_2d", "laplace_1d", "poisson_2d", "poisson_3d",
    "poisson_3d_27pt",
]
