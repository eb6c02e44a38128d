"""PyTorch/CUDA port of sparse_matrix_math_tpu: the front door, the DIA,
grid-stencil, general-pattern and routed solve paths, their preconditioners,
and the double-word (f64-grade from float32 pairs) solvers.

Load or build a CSR matrix on a device, then call :func:`solve` (with
``auto_format=True`` :func:`best_format` picks the layout: grid stencil, DIA,
W-SELL, RCM + W-SELL, the routed R-SELL chain, or the CSR itself), or solve
with :func:`cg`, :func:`bicgstab`, :func:`bicg_symmetric` or :func:`cgs`,
optionally preconditioned (Jacobi, SGS, IC0, ILU0, Chebyshev), and get a
:class:`SolveResult` back; :func:`cg_multi` (or :func:`solve` with a ``b``
of shape ``(n, m)``) solves m right-hand sides through one loop and returns
a :class:`MultiSolveResult`.  A large CSR matrix on a CUDA device is
routed to DIA, else to W-SELL, else (with no preconditioner) through an RCM
renumbering to W-SELL.  The matvec of a DIA solve is the hand-written kernel
in ``csrc/dia_spmv.cu`` and its SGS, IC0 or ILU0 apply one call of the fused
sweep kernels in ``csrc/trisweep.cu``; the matvec of a W-SELL solve, each
strict-factor product of its preconditioner, and an ELL matrix's product
are ``csrc/sell_spmv.cu`` over the slab-sorted SELL-32 layout each matrix
carries (``formats/sell.py``), and so is a W-SELL or ELL panel product (up to
8 columns per launch, the panel products of :func:`cg_multi`); each routing
pass of a
:class:`RoutedMatrix` is ``csrc/stream_gather.cu``.  :func:`cg_df64`,
:func:`bicgstab_df64`, :func:`cg_ir_df64` and :func:`bicgstab_ir_df64` solve
with double-word operators (:class:`DfDiaMatrix`, :class:`DfEllMatrix`,
:func:`load_matrix_df`); a DfDiaMatrix's product is ``csrc/dia_spmv_df.cu``.
Public names follow the JAX package.
"""

from .formats import (
    COOArrays,
    CSRMatrix,
    DIAMatrix,
    ELLMatrix,
    GridStencilMatrix,
    HYBMatrix,
    PerformanceWarning,
    ReorderedMatrix,
    RoutedMatrix,
    WSellMatrix,
    auto_route_for_solve,
    best_format,
    coo_from_arrays,
    csr_from_coo,
    dia_from_csr,
    ell_from_csr,
    hyb_from_csr,
    permute_csr,
    rcm_permutation,
    reorder_to_wsell,
    routed_from_csr,
    try_dia_from_csr,
    try_grid_stencil_from_csr,
    try_routed_from_csr,
    try_wsell_from_csr,
    wsell_from_csr,
)
from .io import MatrixLoadStatus, MatrixMarketError, load_matrix_csr, load_matrix_df
from .ops import (
    DfDiaMatrix,
    DfEllMatrix,
    DfGridStencil,
    df_from_host,
    df_operator_from_host_csr,
    df_to_host,
    dot,
    norm2,
    rmult,
    rmult_add,
    rmult_sub,
)
from .ops.stream_gather import stream_gather
from .precond import (
    ChebyshevPreconditioner,
    FactorizationError,
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
    SolverPreconditioner,
    get_preconditioner,
)
from .solvers import (
    SOLVERS,
    DfSolveResult,
    MultiSolveResult,
    SolverConfig,
    SolveResult,
    SolverStatus,
    bicg_symmetric,
    bicgstab,
    bicgstab_df64,
    bicgstab_ir_df64,
    cg,
    cg_df64,
    cg_ir_df64,
    cg_multi,
    cgs,
    conjugate_gradient,
    conjugate_gradient_squared,
    solve,
)
from .utils import (
    convection_diffusion_2d,
    laplace_1d,
    laplace_3d_jittered,
    poisson_2d,
    poisson_3d,
    poisson_3d_27pt,
    random_spd_csr,
    uniform_random_csr,
)

__all__ = [
    "COOArrays", "CSRMatrix", "DIAMatrix", "PerformanceWarning", "auto_route_for_solve",
    "coo_from_arrays", "csr_from_coo", "dia_from_csr", "try_dia_from_csr",
    "ELLMatrix", "ell_from_csr", "HYBMatrix", "hyb_from_csr", "WSellMatrix", "wsell_from_csr",
    "try_wsell_from_csr", "ReorderedMatrix", "permute_csr", "rcm_permutation",
    "reorder_to_wsell", "RoutedMatrix", "routed_from_csr", "try_routed_from_csr",
    "GridStencilMatrix", "try_grid_stencil_from_csr", "best_format", "stream_gather",
    "MatrixLoadStatus", "MatrixMarketError", "load_matrix_csr", "load_matrix_df",
    "dot", "norm2", "rmult", "rmult_add", "rmult_sub",
    "FactorizationError", "IdentityPreconditioner", "JacobiPreconditioner",
    "SGSPreconditioner", "ILU0Preconditioner", "IC0Preconditioner", "SolverPreconditioner",
    "get_preconditioner", "ChebyshevPreconditioner",
    "SolveResult", "SolverStatus", "bicgstab", "cg", "conjugate_gradient", "bicg_symmetric",
    "cgs", "conjugate_gradient_squared", "solve", "SolverConfig", "SOLVERS",
    "cg_multi", "MultiSolveResult",
    "DfSolveResult", "DfDiaMatrix", "DfEllMatrix", "DfGridStencil", "df_from_host", "df_to_host",
    "df_operator_from_host_csr", "cg_df64", "bicgstab_df64", "cg_ir_df64", "bicgstab_ir_df64",
    "convection_diffusion_2d", "laplace_1d", "laplace_3d_jittered", "poisson_2d",
    "poisson_3d", "poisson_3d_27pt", "random_spd_csr", "uniform_random_csr",
]
