"""The solve front door and the solver configuration.

Port of ``sparse_matrix_math_tpu/solvers/api.py``.  A :class:`SolverConfig`
holds the whole run-time configuration (method, tolerance, iteration cap,
preconditioner and its options, the format and escalation switches), and
:func:`solve` dispatches to the solver and preconditioner it names: the
one-call API for users coming from the reference's ``SolverStatus f(A, b, x,
...)`` call sites.

A 2-D ``b`` of shape ``(n, m)`` goes to :func:`~.block.cg_multi` (method
``cg`` only) and returns a :class:`~.block.MultiSolveResult`.

``matrix_dtype`` (e.g. ``"bfloat16"``) goes to :func:`~.mixed.mixed_cg`:
method ``cg`` only, no preconditioner, no residual trace; with
``auto_format`` a grid stencil is laid out as DIA for it, and a stencil of at
most 9 diagonals draws a :class:`PerformanceWarning` (PERF.md has the card's
numbers).

The method table is the JAX package's: CG, BiCGSymmetric, CGS, BiCGStab,
Chebyshev, pipelined CG and GMRES, and the four double-word methods.
``preconditioner="multigrid"`` (or ``"mg"``) builds
:meth:`~.multigrid.PoissonMultigrid.for_stencil` for a grid stencil, or for a
CSR or DIA matrix the stencil detector verifies as the Poisson family; the
V-cycle also serves as the double-word refinement's inner preconditioner when
the request is pre-routed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from ..formats.csr import CSRMatrix
from ..precond.preconditioners import get_preconditioner
from ..utils.profiling import span
from .bicg_symmetric import bicg_symmetric
from .bicgstab import bicgstab
from .cg import conjugate_gradient
from .cgs import conjugate_gradient_squared
from .chebyshev import chebyshev
from .gmres import gmres
from .pipelined import cg_pipelined
from .types import SolveResult

__all__ = ["SolverConfig", "solve", "SOLVERS"]

SOLVERS = {
    "cg": conjugate_gradient,
    "conjugate_gradient": conjugate_gradient,
    "bicg_symmetric": bicg_symmetric,
    "cgs": conjugate_gradient_squared,
    "conjugate_gradient_squared": conjugate_gradient_squared,
    "bicgstab": bicgstab,
    "chebyshev": chebyshev,
    "cg_pipelined": cg_pipelined,
    "gmres": gmres,
}

# mixed_cg on a stencil of at most this many diagonals draws a
# PerformanceWarning (the JAX package's threshold, api.py:323)
_NARROW_STENCIL = 9

# double-word methods (solvers/df64.py, solvers/ir_df64.py): a branch of
# their own in solve(), with other operator and result types (DfSolveResult)
_DF64_METHODS = ("cg_df64", "bicgstab_df64", "cg_ir_df64", "bicgstab_ir_df64")

# which solvers take a preconditioner (the reference: CG has the IC0 overload
# h:2414-2505, BiCGStab the preconditioned form h:2191-2283)
_PRECONDITIONABLE = {"cg", "conjugate_gradient", "bicgstab", "gmres"}

_SGS_KINDS = ("sgs", "symmetric_gauss_seidel", "symmetric_gaus_seidel")


def _build_preconditioner(a, kind, options):
    """Resolve a preconditioner spec for the matrix's format.

    CSR takes every kind (``get_preconditioner``); DIA takes the kinds whose
    factors the diagonal layout represents: ``'sgs'`` (PaddedSGS, the padded
    path's apply) and ``'chebyshev'``, which any format takes.
    """
    from ..formats.dia import DIAMatrix
    from ..formats.reorder import ReorderedMatrix

    if hasattr(kind, "apply"):
        # a preconditioner OBJECT passes through: anything with apply(r) -> z
        return kind
    if isinstance(kind, str) and kind.lower() in ("multigrid", "mg"):
        return _build_multigrid(a, options)
    if isinstance(a, ReorderedMatrix):
        # the hoisted solvers run in the permuted domain
        # (formats/reorder.py:reorder_hoisted), so the preconditioner is
        # factored from the PERMUTED matrix
        if a.inner_csr is None:
            raise ValueError("ReorderedMatrix carries no permuted CSR; pass a "
                             "preconditioner object built in the permuted domain")
        return _build_preconditioner(a.inner_csr, kind, options)
    if isinstance(a, CSRMatrix):
        return get_preconditioner(a, kind, **options)
    k = kind.lower() if isinstance(kind, str) else kind
    if k in ("cheby", "chebyshev", "poly", "polynomial"):
        from ..precond.cheby_poly import ChebyshevPreconditioner

        return ChebyshevPreconditioner.from_matrix(a, **options)
    if isinstance(a, DIAMatrix) and k in _SGS_KINDS:
        from ..precond.padded_sgs import PaddedSGS

        opts = dict(options)
        opts.setdefault("sweeps", 4)
        return PaddedSGS.from_dia(a, **opts)
    raise ValueError(
        f"preconditioner {kind!r} is not buildable for {type(a).__name__}; construct from "
        "CSR (get_preconditioner) or pass a preconditioner object directly")


def _build_multigrid(a, options):
    """``preconditioner="multigrid"``: the geometric V-cycle of the Poisson
    stencil family (solvers/multigrid.py).  A GridStencilMatrix is taken as it
    is; a CSR or DIA matrix is verified entry for entry by the stencil
    detector first, since a V-cycle applied to another operator would
    precondition the wrong system."""
    from ..formats.dia import DIAMatrix
    from ..formats.stencil import (
        GridStencilMatrix,
        try_grid_stencil_from_csr,
        try_grid_stencil_from_dia,
    )
    from .multigrid import PoissonMultigrid

    st = a if isinstance(a, GridStencilMatrix) else None
    if st is None and isinstance(a, CSRMatrix):
        st = try_grid_stencil_from_csr(a)
    if st is None and isinstance(a, DIAMatrix):
        st = try_grid_stencil_from_dia(a)
    if st is None:
        raise ValueError(
            "preconditioner='multigrid' needs a Poisson-family grid stencil operator "
            "(GridStencilMatrix, or a CSR that the stencil detector verifies); got "
            f"{type(a).__name__}")
    return PoissonMultigrid.for_stencil(st, **options)


def _build_preconditioner_for(a, a_source, kind, options):
    """Build for the solve operator, falling back to the CSR source.

    With ``auto_format`` the operator may be a layout (W-SELL, R-SELL, grid
    stencil) whose kinds are not directly buildable; those layouts keep the
    row and column order, so a factor of the original CSR is exact.  A
    ReorderedMatrix does not: ``_build_preconditioner`` factors from its
    permuted CSR, and there is no fallback across the permutation."""
    from ..formats.reorder import ReorderedMatrix

    with span("precond_build"):
        try:
            return _build_preconditioner(a, kind, options)
        except ValueError:
            if a_source is a or isinstance(a, ReorderedMatrix):
                raise
            return _build_preconditioner(a_source, kind, options)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Run-time solver configuration."""

    method: str = "cg"
    epsilon: float = 1e-8
    max_iterations: int = -1          # -1 => n, reference convention
    # a kind string (none/jacobi/sgs/ilu0/ic0/chebyshev) or any OBJECT with
    # apply(r) -> z; both serve the plain path AND the escalation
    preconditioner: Any = "none"
    preconditioner_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    record_residuals: bool = False
    # stream the MATRIX in this dtype (e.g. "bfloat16") with f32 vectors and
    # true-residual refinement (solvers/mixed.py, mixed_cg)
    matrix_dtype: Optional[str] = None
    # convert a CSR input through formats.best_format before solving (grid
    # stencil / DIA / W-SELL / RCM + W-SELL / R-SELL / CSR by pattern).  Off
    # by default: a layout build costs host time that only pays over real
    # solver runs.
    auto_format: bool = False
    # when a float32 solve stops at its PRECISION FLOOR (floor_hit: a
    # verified-convergence restart could not shrink the true residual) above
    # ``epsilon``, go on through the double-word refinement (cg_ir_df64 /
    # bicgstab_ir_df64) from the floored iterate, which delivers the
    # reference's f64-default accuracy contract (test/include/test_common.h:
    # 30-38).  The escalated call returns a DfSolveResult.  Opt out to get
    # the floored SolveResult back.
    auto_escalate: bool = True

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


def solve(a, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          config: Optional[SolverConfig] = None, **overrides):
    """Solve ``a @ x = b`` according to ``config`` and keyword overrides, on
    the device of ``a`` and ``b``.

    Returns a ``SolveResult``; a ``DfSolveResult`` for the df64 methods, or
    when ``auto_escalate`` sends a float32 request below its precision floor
    through the double-word refinement (see :class:`SolverConfig`); a
    ``MultiSolveResult`` for a ``b`` of shape ``(n, m)``.

    >>> solve(a, b, method="bicgstab", preconditioner="sgs", epsilon=1e-8)
    """
    with span("solve"):
        cfg = (config or SolverConfig()).replace(**overrides)
        method = cfg.method.lower()
        if method not in SOLVERS and method not in _DF64_METHODS:
            raise ValueError(
                f"unknown method {cfg.method!r}; options: "
                f"{sorted(set(SOLVERS) | set(_DF64_METHODS))}")
        shape = getattr(a, "shape", None)
        if shape is not None and getattr(b, "ndim", 0) >= 1 and b.shape[0] != shape[0]:
            # the JAX package fails here with broadcasting's TypeError
            raise TypeError(f"b has {b.shape[0]} rows; the matrix has {shape[0]}")
        if method in _DF64_METHODS:
            return _solve_df64(a, b, x0, cfg, method)
        a_source = a  # preconditioners factor from the CSR source below
        if cfg.auto_format and isinstance(a, CSRMatrix):
            from ..formats import best_format
            from ..formats.dia import try_dia_from_csr
            from ..formats.stencil import GridStencilMatrix

            a = best_format(a)
            if isinstance(a, GridStencilMatrix) and (
                    cfg.matrix_dtype is not None
                    or str(cfg.preconditioner).lower() in _SGS_KINDS + ("ilu0", "ic0")):
                # these ride the DIA machinery (the bf16 diagonal stream,
                # PaddedSGS, the padded factor applies); the matrix-free stencil
                # has no matrix stream to retype and stores no factors: keep DIA
                dia = try_dia_from_csr(a_source)
                if dia is not None:
                    a = dia
        if getattr(b, "ndim", 1) == 2:
            # a multi-RHS panel: one panel product feeds every column
            # (solvers/block.py); returns a MultiSolveResult
            from .block import cg_multi

            if method not in ("cg", "conjugate_gradient"):
                raise ValueError("multi-RHS b (n, m) is supported for method='cg' (cg_multi); "
                                 "solve each column separately for other methods")
            precond = None
            if not _is_none(cfg.preconditioner):
                # every preconditioner apply takes the (n, m) panel
                precond = _build_preconditioner_for(a, a_source, cfg.preconditioner,
                                                    cfg.preconditioner_options)
            return cg_multi(a, b, x0, max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                            preconditioner=precond, record_residuals=cfg.record_residuals)
        if cfg.matrix_dtype is not None:
            return _solve_mixed(a, b, x0, cfg, method)
        kwargs: Dict[str, Any] = dict(max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                                      record_residuals=cfg.record_residuals)
        if not _is_none(cfg.preconditioner):
            if method not in _PRECONDITIONABLE:
                raise ValueError(f"{method} does not take a preconditioner "
                                 "(cg, bicgstab, and gmres do)")
            kwargs["preconditioner"] = _build_preconditioner_for(
                a, a_source, cfg.preconditioner, cfg.preconditioner_options)
        # an escalation returns a DfSolveResult, which has no residual trace: an
        # explicit record_residuals request stays on the plain path
        escalatable = cfg.auto_escalate and not cfg.record_residuals
        if escalatable and method in _ESCALATION:
            # pre-route: an epsilon below what the working dtype can represent
            # relative to b (||r|| < eps_mach * ||b|| is no reachable float32
            # state) skips the doomed n-iteration pass
            if b.dtype.is_floating_point and torch.finfo(b.dtype).eps > 1e-10:
                floor_est = float(torch.finfo(b.dtype).eps) * float(torch.linalg.norm(b))
                if cfg.epsilon < floor_est:
                    esc = _escalated_solve(a_source, b, x0, cfg, method, kwargs, a)
                    if esc is not None:
                        return esc
        res = SOLVERS[method](a, b, x0, **kwargs)
        if escalatable:
            esc = _maybe_escalate(res, a_source, b, cfg, method, kwargs, a)
            if esc is not None:
                return esc
        return res


def _solve_mixed(a, b, x0, cfg: SolverConfig, method: str):
    """The bfloat16-matrix branch (JAX ``api.py:307-356``): ``mixed_cg``."""
    import warnings

    from ..formats import PerformanceWarning
    from .mixed import mixed_cg

    if method not in ("cg", "conjugate_gradient"):
        raise ValueError("matrix_dtype (mixed precision) is supported for method='cg' only")
    ndiags = len(getattr(a, "offsets", ())) or None
    if ndiags is not None and ndiags <= _NARROW_STENCIL:
        # the rule of the JAX package: on a narrow stencil the refinement's
        # extra rounds and products can outweigh the halved diagonal bytes
        warnings.warn(
            f"matrix_dtype={cfg.matrix_dtype!r} on a narrow {ndiags}-diagonal stencil: "
            f"on stencils of at most {_NARROW_STENCIL} diagonals the mixed solve can be "
            "SLOWER than plain f32 CG at matched true accuracy (the bf16 stream halves "
            "only the diagonals' bytes, and refinement adds rounds); PERF.md has the "
            "measurements on the card.  Drop matrix_dtype to use the f32 path.",
            PerformanceWarning, stacklevel=3)
    if not _is_none(cfg.preconditioner):
        raise ValueError("matrix_dtype does not compose with a preconditioner yet")
    if cfg.record_residuals:
        raise ValueError("mixed_cg does not record residual traces (the outer loop only "
                         "tracks true-residual checkpoints)")
    return mixed_cg(a, b, x0, max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                    matrix_dtype=cfg.matrix_dtype)


def _is_none(pre) -> bool:
    return pre is None or (isinstance(pre, str) and pre == "none")


def _solve_df64(a, b, x0, cfg: SolverConfig, method: str):
    """The double-word methods: they take the CSR source (or a double-word
    operator) directly; formats, string preconditioners and traces belong to
    the plain path."""
    from .df64 import bicgstab_df64, cg_df64
    from .ir_df64 import bicgstab_ir_df64, cg_ir_df64

    if cfg.record_residuals:
        raise ValueError(f"{method} does not record residual traces")
    if method in ("cg_ir_df64", "bicgstab_ir_df64"):
        # the refinement's inner f32 solve takes a preconditioner OBJECT
        pre = cfg.preconditioner
        if _is_none(pre):
            pre = None
        elif isinstance(pre, str):
            raise ValueError(
                f"{method} via solve() takes a preconditioner OBJECT (apply(r) -> z), not a "
                f"string factory name; call {method}() directly or pass the object")
        ir_fn = cg_ir_df64 if method == "cg_ir_df64" else bicgstab_ir_df64
        return ir_fn(a, b, x0, max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                     preconditioner=pre)
    if not _is_none(cfg.preconditioner):
        raise ValueError(f"{method} does not take a preconditioner yet")
    fn = cg_df64 if method == "cg_df64" else bicgstab_df64
    return fn(a, b, x0, max_iterations=cfg.max_iterations, epsilon=cfg.epsilon)


# the methods that escalate, and the double-word refinement each goes to.
# GMRES reports no floor_hit (as in the JAX package), so only its pre-route
# fires: an f32 request below the precision floor goes straight to the
# nonsymmetric refinement, whose inner BiCGStab needs only a modest relative
# reduction per round.
_ESCALATION = {
    "cg": "cg",
    "conjugate_gradient": "cg",
    "bicgstab": "bicgstab",
    "gmres": "bicgstab",
}


def _escalated_solve(a_source, b, x0, cfg, method, kwargs, a_solve=None):
    """Run the double-word refinement (pre-routed, or after a floored f32
    pass).  None when the operator has no double-word twin: the caller then
    keeps the plain behaviour."""
    from ..formats.reorder import ReorderedMatrix
    from .ir_df64 import bicgstab_ir_df64, cg_ir_df64

    dfa = _df_operator_for(a_source)
    if dfa is None:
        return None
    ir_fn = cg_ir_df64 if _ESCALATION[method] == "cg" else bicgstab_ir_df64
    pre = kwargs.get("preconditioner")
    if pre is not None and not hasattr(pre, "apply"):
        pre = None
    if pre is not None and isinstance(a_solve, ReorderedMatrix):
        # auto_format factored the preconditioner in the PERMUTED domain; the
        # refinement runs on the original-order operator: escalate without it
        pre = None
    return ir_fn(dfa, b, x0=x0, max_iterations=cfg.max_iterations, epsilon=cfg.epsilon,
                 preconditioner=pre)


def _maybe_escalate(res, a_source, b, cfg, method, kwargs, a_solve=None):
    """Escalate a float32 solve that stopped at its precision floor above the
    requested ``epsilon`` to the double-word refinement, from the floored
    iterate.  None when escalation does not apply."""
    if method not in _ESCALATION or not isinstance(res, SolveResult):
        return None
    if not res.floor_hit:
        return None
    if not float(res.residual_norm) > float(cfg.epsilon):
        return None
    return _escalated_solve(a_source, b, res.x, cfg, method, kwargs, a_solve)


def _df_operator_for(a):
    """The double-word operator of the solve's source matrix, or None when
    the format has no double-word twin.  Float32 values mean zero lo planes:
    the refinement then solves the f32-rounded operator to ``epsilon``."""
    from ..formats.dia import DIAMatrix
    from ..formats.stencil import GridStencilMatrix
    from ..ops.df32 import DfDiaMatrix, DfEllMatrix, DfGridStencil, df_from_host
    from .df64 import _as_df_operator

    if isinstance(a, (CSRMatrix, GridStencilMatrix)):
        return _as_df_operator(a)
    if isinstance(a, DIAMatrix):
        hi, lo = df_from_host(a.diags, device=a.device)
        return DfDiaMatrix(diags_hi=hi, diags_lo=lo, offsets=a.offsets, shape=a.shape,
                           nnz=a.nnz)
    if isinstance(a, (DfDiaMatrix, DfEllMatrix, DfGridStencil)):
        return a
    return None
