"""PyTorch/CUDA port of sparse_matrix_math_tpu: the front door, the DIA,
grid-stencil, general-pattern and routed solve paths, their preconditioners,
and the double-word (f64-grade from float32 pairs) solvers.

Load or build a CSR matrix on a device, then call :func:`solve` (with
``auto_format=True`` :func:`best_format` picks the layout: grid stencil, DIA,
W-SELL, RCM + W-SELL, the routed R-SELL chain, or the CSR itself), or solve
with :func:`cg`, :func:`bicgstab`, :func:`bicg_symmetric`, :func:`cgs`,
:func:`gmres` (restarted, or s-step), :func:`chebyshev`, :func:`cg_pipelined`
or :func:`deflated_cg`, optionally preconditioned (Jacobi, SGS, IC0, ILU0,
Chebyshev, the geometric multigrid V-cycle :class:`PoissonMultigrid`), and get
a :class:`SolveResult` back (:func:`cg_solve` is a CG solve that autograd
differentiates); :func:`cg_multi` (or :func:`solve` with a ``b``
of shape ``(n, m)``) solves m right-hand sides through one loop and returns
a :class:`MultiSolveResult`.  :func:`solve_with_stats` and
:func:`spmv_throughput` time solves and products, :func:`checkpointed_solve`
runs a solve in checkpointed restart chunks, and ``python -m
sparse_matrix_math_tpu_torch`` is the command line (``info``, ``solve``,
``bench-spmv``).  A large CSR matrix on a CUDA device is
routed to DIA, else to W-SELL, else (with no preconditioner) through an RCM
renumbering to W-SELL.  The matvec of a DIA solve is the hand-written kernel
in ``csrc/dia_spmv.cu`` and its SGS, IC0 or ILU0 apply one call of the fused
sweep kernels in ``csrc/trisweep.cu``; the matvec of a W-SELL solve, each
strict-factor product of its preconditioner, and an ELL matrix's product
are ``csrc/sell_spmv.cu`` over the slab-sorted SELL-32 layout each matrix
carries (``formats/sell.py``), and so is a W-SELL or ELL panel product (up to
8 columns per launch, the panel products of :func:`cg_multi`), and so is a
:class:`RoutedMatrix`'s product, over its routing chain folded once into
that layout by ``csrc/stream_gather.cu``.  :func:`cg_df64`,
:func:`bicgstab_df64`, :func:`cg_ir_df64` and :func:`bicgstab_ir_df64` solve
with double-word operators (:class:`DfDiaMatrix`, :class:`DfEllMatrix`,
:func:`load_matrix_df`); a DfDiaMatrix's product is ``csrc/dia_spmv_df.cu``.
Public names follow the JAX package.
"""

__version__ = "0.1.0"

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
    TripletMatrix,
    WSellMatrix,
    auto_route_for_solve,
    best_format,
    coo_from_arrays,
    csr_from_coo,
    csr_from_dense,
    csr_from_triplet,
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
from .io import (
    MatrixLoadStatus,
    MatrixMarketError,
    load_matrix,
    load_matrix_csr,
    load_matrix_df,
    load_matrix_market,
    load_smmdt,
    save_dense_text,
)
from .ops import (
    DfDiaMatrix,
    DfEllMatrix,
    DfGridStencil,
    axpy,
    df_from_host,
    df_operator_from_host_csr,
    df_to_host,
    dot,
    norm2,
    norm2_squared,
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
    PoissonMultigrid,
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
    cg_pipelined,
    cg_solve,
    cgs,
    chebyshev,
    conjugate_gradient,
    conjugate_gradient_squared,
    deflated_cg,
    gmres,
    lanczos_deflation_basis,
    lanczos_extremal,
    mixed_cg,
    solve,
)
from .utils import (
    SolveStats,
    checkpointed_solve,
    convection_diffusion_2d,
    laplace_1d,
    laplace_3d_jittered,
    load_checkpoint,
    load_csr_npz,
    poisson_2d,
    poisson_3d,
    poisson_3d_27pt,
    random_spd_csr,
    save_checkpoint,
    save_csr_npz,
    sherman1_tiled,
    solve_with_stats,
    spmv_throughput,
    uniform_random_csr,
)

__all__ = [
    "__version__", "COOArrays", "CSRMatrix", "DIAMatrix", "PerformanceWarning",
    "auto_route_for_solve", "TripletMatrix", "coo_from_arrays", "csr_from_coo",
    "csr_from_dense", "csr_from_triplet", "dia_from_csr", "try_dia_from_csr",
    "ELLMatrix", "ell_from_csr", "HYBMatrix", "hyb_from_csr", "WSellMatrix", "wsell_from_csr",
    "try_wsell_from_csr", "ReorderedMatrix", "permute_csr", "rcm_permutation",
    "reorder_to_wsell", "RoutedMatrix", "routed_from_csr", "try_routed_from_csr",
    "GridStencilMatrix", "try_grid_stencil_from_csr", "best_format", "stream_gather",
    "MatrixLoadStatus", "MatrixMarketError", "load_matrix", "load_matrix_csr", "load_matrix_df",
    "load_matrix_market", "load_smmdt", "save_dense_text",
    "axpy", "dot", "norm2", "norm2_squared", "rmult", "rmult_add", "rmult_sub",
    "FactorizationError", "IdentityPreconditioner", "JacobiPreconditioner",
    "SGSPreconditioner", "ILU0Preconditioner", "IC0Preconditioner", "SolverPreconditioner",
    "get_preconditioner", "ChebyshevPreconditioner",
    "SolveResult", "SolverStatus", "bicgstab", "cg", "conjugate_gradient", "bicg_symmetric",
    "cgs", "conjugate_gradient_squared", "solve", "SolverConfig", "SOLVERS",
    "cg_multi", "MultiSolveResult", "mixed_cg", "gmres", "chebyshev", "lanczos_extremal",
    "cg_pipelined", "deflated_cg", "lanczos_deflation_basis", "cg_solve", "PoissonMultigrid",
    "DfSolveResult", "DfDiaMatrix", "DfEllMatrix", "DfGridStencil", "df_from_host", "df_to_host",
    "df_operator_from_host_csr", "cg_df64", "bicgstab_df64", "cg_ir_df64", "bicgstab_ir_df64",
    "convection_diffusion_2d", "laplace_1d", "laplace_3d_jittered", "poisson_2d",
    "poisson_3d", "poisson_3d_27pt", "random_spd_csr", "sherman1_tiled", "uniform_random_csr",
    "checkpointed_solve", "load_checkpoint", "save_checkpoint", "save_csr_npz", "load_csr_npz",
    "SolveStats", "solve_with_stats", "spmv_throughput",
]
