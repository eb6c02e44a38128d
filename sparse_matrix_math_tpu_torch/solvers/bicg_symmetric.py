"""BiCG specialised for symmetric matrices.

Port of ``sparse_matrix_math_tpu/solvers/bicg_symmetric.py`` (reference
``BiCGSymmetric``, include/sparse_matrix_math.h:2021-2102).  On an SPD system
it produces CG's iterates; it carries the reference's breakdown heuristics
for indefinite matrices:

* serious breakdown: ``|Ap . p| < eps`` while ``||r||^2 > 1`` -> DIVERGED,
  before the step is applied (h:2047-2058);
* critical breakdown: ``||r'||^2 > 1`` after ``||r||^2 < eps`` -> DIVERGED,
  after the step (h:2073-2081).

A do-while, like the reference: the first iteration of a solve always runs
(no initial-convergence short-circuit, h:2047).  The iteration cap ends in
MAX_ITERATIONS_REACHED (the reference's check can never fire, h:2098).
Convergence is verified as in :func:`~.cg.cg_core`: SUCCESS means the true
residual passed; a refuted claim restarts from it; a restart that fails to
shrink the true ``rr`` 4x stops with ``floor_hit``.  The loop is host-driven
(solvers/_loop.py).
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

__all__ = ["bicg_symmetric", "bicg_symmetric_core"]


@reorder_hoisted
def bicg_symmetric(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` for symmetric ``a``."""
    from . import _padded, _stencil

    a = as_operator(a)
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    if _stencil.eligible(a):
        return _stencil.stencil_solve("bicg_symmetric", a, b, x0, epsilon, maxiter,
                                      record_residuals)
    if _padded.eligible(a):
        return _padded.padded_solve("bicg_symmetric", a, b, x0, epsilon, maxiter,
                                    record_residuals)
    return bicg_symmetric_core(matvec_fn(a), dot, b, x0, epsilon, maxiter, record_residuals)


def _inner(matvec, dotfn, x, r, rr, k, eps, eps2, eps2_h, maxiter: int, trace):
    """The recurrence from iteration ``k`` until a claim, a breakdown, a
    non-finite ``rr`` or ``maxiter``; iteration 0 of the solve is forced.
    Frozen iterations leave the state as it is."""
    p = r
    serious = torch.zeros((), dtype=torch.bool, device=r.device)
    critical = serious

    def active_now():
        return (((rr >= eps2) | (k == 0)) & (k < maxiter) & ~serious & ~critical
                & torch.isfinite(rr))

    active = active_now()
    for _ in _loop.passes(lambda: (active, rr), eps2_h):
        ap = matvec(p)
        denom = dotfn(ap, p)
        # serious breakdown (h:2056-2058): the reference exits before the
        # step, so the step is masked out
        s_now = (eps > torch.abs(denom)) & (rr > 1.0)
        alpha = torch.where(s_now | ~active, 0, rr / denom)
        x = torch.where(active, x + alpha * p, x)
        r = torch.where(active, r - alpha * ap, r)
        new_rr = torch.where(s_now, rr, dotfn(r, r))
        # critical breakdown (h:2079-2081): after the step, which stands
        c_now = (new_rr > 1.0) & (rr < eps)
        p = torch.where(active, r + (new_rr / rr) * p, p)
        _loop.record_step(trace, k, active, torch.sqrt(new_rr), maxiter)
        serious = torch.where(active, s_now, serious)
        critical = torch.where(active, c_now, critical)
        rr = torch.where(active, new_rr, rr)
        k = k + active
        active = active_now()
    return x, rr, k, serious | critical, trace


def bicg_symmetric_core(matvec, dotfn, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    """BiCGSymmetric core over ``matvec`` and ``dotfn`` (see the module
    docstring)."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    r0 = b - matvec(x0)
    trace = _loop.new_trace(torch.sqrt(dotfn(r0, r0)), maxiter, record)
    del r0
    (eps2_h,) = _loop.read(eps2)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    x, floor_rr, hit = x0, math.inf, False
    while True:
        # (re)start from the true residual
        r_e = b - matvec(x)
        x, rr, k, broke, trace = _inner(matvec, dotfn, x, r_e, dotfn(r_e, r_e), k, eps, eps2,
                                        eps2_h, maxiter, trace)
        with span("verify"):
            r_t = b - matvec(x)
            t_rr = dotfn(r_t, r_t)
            rr_h, t_rr_h, k_h, broke_h = _loop.read(rr, t_rr, k, broke)
        claimed = rr_h < eps2_h and not broke_h
        verified = claimed and t_rr_h <= eps2_h
        refuted = claimed and not verified
        stalled = refuted and t_rr_h > floor_rr * 0.25
        hit = hit or stalled  # latch: this exit is a precision floor
        if refuted:
            floor_rr = t_rr_h
        if broke_h or not math.isfinite(rr_h):
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
