"""Padded-domain solve path for DIA (stencil) matrices.

Port of ``sparse_matrix_math_tpu/solvers/_padded.py:44-206``.  Every solver
vector lives in the :class:`~..ops.dia_spmv.PaddedDIA` layout for the whole
solve: pad once before the loop, unpad once after.  The guard elements hold
exact zeros through the SpMV, the preconditioner apply, the axpys and dots,
so the dots equal the unpadded ones.  On a CUDA device the matvec is the
padded kernel (K2) and an SGS, IC0 or ILU0 apply is one call of the fused
sweep kernel (K4 or K5); on the CPU their plain versions run.

Eligibility is decided before the solve, from the preconditioner's type
and fields; the JAX path's ``try``/``except`` fallback to the generic path
(:128-134, 148-155) guards against Mosaic refusing a kernel and is not
ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.dia import DIAMatrix
from ..ops.dia_spmv import dia_spmv_padded, pad_dia
from ..precond.cheby_poly import ChebyshevPreconditioner, cheby_apply_fn
from ..precond.padded_sgs import PaddedSGS
from ..precond.padded_tri import PaddedTriPair, strict_offsets
from ..precond.preconditioners import (
    IC0Preconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from ..utils.profiling import span, spanned
from .bicg_symmetric import bicg_symmetric_core
from .bicgstab import bicgstab_core
from .cg import cg_core, pcg_core
from .cgs import cgs_core
from .types import SolveResult

__all__ = ["eligible", "padded_solve", "padded_preconditioner"]

_CORES = {
    "cg": cg_core,
    "bicg_symmetric": bicg_symmetric_core,
    "cgs": cgs_core,
    # bicgstab_core's preconditioner argument is bound in padded_solve
    "bicgstab": bicgstab_core,
}


def eligible(a, preconditioner=None) -> bool:
    """Take the padded path?  A DIA matrix, on any device, with no
    preconditioner, Jacobi, or one the padded layout represents: SGS, IC0
    and ILU0 whose triangular solves use ``method='jacobi'`` (the factors'
    strict parts must lie on the matrix's diagonals), a PaddedSGS or
    PaddedTriPair, or a Chebyshev polynomial of ``a`` itself (its apply is
    padded products).  ``method='dense'`` takes the generic path, as in JAX."""
    if not isinstance(a, DIAMatrix):
        return False
    pre = preconditioner
    if pre is None or isinstance(pre, (JacobiPreconditioner, PaddedSGS, PaddedTriPair)):
        return True
    if isinstance(pre, SGSPreconditioner):
        return pre.fwd.method == "jacobi"
    if isinstance(pre, (IC0Preconditioner, ILU0Preconditioner)):
        factors = (pre.lower, pre.upper)
        return all(t.method == "jacobi" for t in factors) and all(
            set(strict_offsets(t)) <= set(a.offsets) for t in factors)
    if isinstance(pre, ChebyshevPreconditioner):
        return pre.a is a
    return False


def padded_solve(core_name: str, a: DIAMatrix, b: torch.Tensor, x0: torch.Tensor, eps,
                 maxiter: int, record: bool, preconditioner=None) -> SolveResult:
    """Run ``cg``, ``bicgstab``, ``bicg_symmetric`` or ``cgs`` in the padded
    layout; ``cg`` and ``bicgstab`` with a preconditioner :func:`eligible`
    admits."""
    if core_name not in _CORES:
        raise ValueError(f"no padded solve for {core_name!r}")
    if preconditioner is not None and core_name not in ("cg", "bicgstab"):
        raise ValueError(f"{core_name} does not take a preconditioner")
    cheby = preconditioner if isinstance(preconditioner, ChebyshevPreconditioner) else None
    if a.dtype != b.dtype:
        a = a.astype(b.dtype)  # b carries the harmonized solve dtype
    pdia = pad_dia(a)

    def matvec(v):
        with span("spmv"):
            return dia_spmv_padded(pdia, v)

    def dotfn(u, v):
        return torch.dot(u, v)

    if cheby is not None:
        apply_ = cheby_apply_fn(matvec, cheby.lmin, cheby.lmax, cheby.degree)
    else:
        apply_ = _padded_apply(preconditioner, a, pdia)
    apply_ = spanned("precond_apply", apply_)
    bp = pdia.to_padded(b)
    x0p = pdia.to_padded(x0)
    if core_name == "bicgstab":
        res = bicgstab_core(matvec, apply_ or (lambda v: v), dotfn, bp, x0p, eps,
                            maxiter, record)
    elif apply_ is not None:
        res = pcg_core(matvec, apply_, dotfn, bp, x0p, eps, maxiter, record)
    else:
        res = _CORES[core_name](matvec, dotfn, bp, x0p, eps, maxiter, record)
    return dataclasses.replace(res, x=pdia.from_padded(res.x).clone())


def padded_preconditioner(pre, a: DIAMatrix):
    """The PaddedSGS or PaddedTriPair, in ``a``'s dtype, whose apply a padded
    solve of ``a`` runs for ``pre``: an SGS, IC0 or ILU0 preconditioner
    :func:`eligible` admits, re-laid against ``a``, or a padded one."""
    if isinstance(pre, SGSPreconditioner):
        # re-lay the truncated-sweep apply into the padded layout
        with span("precond_build"):
            pre = PaddedSGS.from_dia(a, sweeps=pre.fwd.sweeps)
    elif isinstance(pre, (IC0Preconditioner, ILU0Preconditioner)):
        with span("precond_build"):
            pre = PaddedTriPair.from_factors(pre.lower, pre.upper, a)
    return pre if pre.dtype == a.dtype else pre.astype(a.dtype)


def _padded_apply(pre, a: DIAMatrix, pdia):
    """The preconditioner apply on padded vectors, or None for none."""
    if pre is None:
        return None
    if isinstance(pre, JacobiPreconditioner):
        invp = pdia.to_padded(pre.inv_diag.to(a.dtype))  # guard zeros stay 0
        return lambda r: r * invp
    pre = padded_preconditioner(pre, a)
    if (pre.lead, pre.n_total, pre.shape) != (pdia.lead, pdia.n_total, a.shape):
        raise ValueError("the preconditioner's padded layout is not the matrix's; build "
                         "it from this matrix")
    return pre.apply_padded
