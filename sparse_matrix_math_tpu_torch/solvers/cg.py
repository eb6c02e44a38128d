"""Conjugate Gradient, plain and preconditioned.

Port of ``sparse_matrix_math_tpu/solvers/cg.py:44-347`` (reference
``ConjugateGradient``, include/sparse_matrix_math.h:2316-2398, and its
preconditioned overload h:2414-2505).  Same contract as the JAX cores:

* early SUCCESS when ``||r0||^2 < eps^2`` before any iteration;
* the inner recurrence stops at the first ``k`` with ``rr < eps^2``, at a
  non-finite ``rr``, or at ``maxiter``;
* every outer round recomputes the true residual ``b - A x``; SUCCESS means
  the true residual passed, and a refuted claim restarts the recurrence
  from it;
* ``floor_hit`` latches when a restart fails to shrink the true ``rr`` 4x:
  the solve has reached its precision floor and stops with
  MAX_ITERATIONS_REACHED.

The loop is host-driven (solvers/_loop.py): one host read per chunk of
iterations, each chunk sized from ``rr``'s observed rate against ``eps^2``,
and one per outer round.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..formats.reorder import reorder_hoisted
from ..ops.spmv import as_operator, matvec_fn
from ..ops.vector import dot
from ..utils.profiling import span
from . import _loop
from .types import SolveResult, SolverStatus, harmonize_dtypes, resolve_max_iterations

__all__ = ["conjugate_gradient", "cg", "cg_core", "pcg_core"]


@reorder_hoisted
def conjugate_gradient(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    preconditioner=None,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` for SPD ``a``.

    Args:
      a: a sparse matrix of the port's formats, a dense 2-D tensor, or a matvec
        callable.
      b: right-hand side, on the device the solve runs on.
      x0: initial guess (zeros when None).
      max_iterations: -1 means n (reference convention, h:2345-2347).
      epsilon: L2-norm threshold on the true residual.
      preconditioner: object with ``apply(r) -> z`` (SPD), or None.
      record_residuals: also return the per-iteration ||r|| trace.
    """
    from . import _padded, _stencil

    a = as_operator(a)
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    if _stencil.eligible(a, preconditioner):
        return _stencil.stencil_solve("cg", a, b, x0, epsilon, maxiter, record_residuals,
                                      preconditioner=preconditioner)
    if _padded.eligible(a, preconditioner):
        return _padded.padded_solve("cg", a, b, x0, epsilon, maxiter, record_residuals,
                                    preconditioner=preconditioner)
    matvec = matvec_fn(a)
    if preconditioner is None:
        return cg_core(matvec, dot, b, x0, epsilon, maxiter, record_residuals)
    return pcg_core(matvec, preconditioner.apply, dot, b, x0, epsilon, maxiter,
                    record_residuals)


cg = conjugate_gradient


def _cg_inner(matvec, dotfn, precond, x, r, rr, k, eps2, eps2_h, maxiter, trace):
    """The (P)CG recurrence from iteration ``k`` until ``rr < eps2``,
    divergence or ``maxiter``; frozen iterations leave the state as is."""
    z = r if precond is None else precond(r)
    rz = rr if precond is None else dotfn(r, z)
    p = z

    def active_now():
        return (rr >= eps2) & (k < maxiter) & torch.isfinite(rr)

    active = active_now()
    for _ in _loop.passes(lambda: (active, rr), eps2_h):
        ap = matvec(p)
        alpha = torch.where(active, rz / dotfn(ap, p), 0)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r - alpha * ap, r)
        new_rr = dotfn(r, r)
        if precond is None:
            z, new_rz = r, new_rr
        else:
            z = precond(r)
            new_rz = dotfn(r, z)
        p = torch.where(active, z + (new_rz / rz) * p, p)
        _loop.record_step(trace, k, active, torch.sqrt(new_rr), maxiter)
        rr = torch.where(active, new_rr, rr)
        rz = torch.where(active, new_rz, rz)
        k = k + active
        active = active_now()
    return x, rr, k, trace


def _cg_outer(matvec, dotfn, precond, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    r0 = b - matvec(x0)
    rr0 = dotfn(r0, r0)
    del r0
    trace = _loop.new_trace(torch.sqrt(rr0), maxiter, record)
    rr0_h, eps2_h = _loop.read(rr0, eps2)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    if rr0_h < eps2_h:
        return SolveResult(x=x0, status=int(SolverStatus.SUCCESS), iterations=0,
                           residual_norm=torch.sqrt(rr0), residual_trace=trace,
                           floor_hit=False)

    x, floor_rr, hit = x0, math.inf, False
    while True:
        # (re)start from the true residual
        r_e = b - matvec(x)
        x, rr, k, trace = _cg_inner(matvec, dotfn, precond, x, r_e, dotfn(r_e, r_e),
                                    k, eps2, eps2_h, maxiter, trace)
        with span("verify"):
            r_t = b - matvec(x)
            t_rr = dotfn(r_t, r_t)
            rr_h, t_rr_h, k_h = _loop.read(rr, t_rr, k)
        claimed = rr_h < eps2_h
        verified = claimed and t_rr_h < eps2_h
        refuted = claimed and not verified
        stalled = refuted and t_rr_h > floor_rr * 0.25
        hit = hit or stalled  # latch: this exit is a precision floor
        if refuted:
            floor_rr = t_rr_h
        if not math.isfinite(rr_h):
            status = SolverStatus.DIVERGED
        elif verified:
            status = SolverStatus.SUCCESS
        elif stalled or k_h >= maxiter:
            status = SolverStatus.MAX_ITERATIONS_REACHED
        else:
            continue
        break
    return SolveResult(
        x=x, status=int(status), iterations=int(k_h), residual_norm=torch.sqrt(t_rr),
        residual_trace=trace,
        floor_hit=hit and status == SolverStatus.MAX_ITERATIONS_REACHED,
    )


def cg_core(matvec, dotfn, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    """CG core over ``matvec`` and ``dotfn`` (see the module docstring)."""
    return _cg_outer(matvec, dotfn, None, b, x0, eps, maxiter, record)


def pcg_core(matvec, precond_apply, dotfn, b, x0, eps, maxiter: int,
             record: bool) -> SolveResult:
    """Preconditioned CG core: ``z = M^{-1} r``, ``alpha = (r.z)/(Ap.p)``,
    ``beta = (r'.z')/(r.z)`` (reference pseudocode h:2424-2434); a restart
    sets ``p = M^{-1} r_true``."""
    return _cg_outer(matvec, dotfn, precond_apply, b, x0, eps, maxiter, record)
