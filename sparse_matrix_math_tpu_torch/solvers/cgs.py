"""Conjugate Gradient Squared: transpose-free BiCG with the squared residual
polynomial.

Port of ``sparse_matrix_math_tpu/solvers/cgs.py``, the algorithm the
reference intends in ``ConjugateGradientSquared``
(include/sparse_matrix_math.h:2109-2178; that version does not compile when
instantiated and no reference test runs it).  Recursion (Saad, "Iterative
Methods for Sparse Linear Systems" 7.4.1; the reference's u/p/q/r recursion,
h:2120-2126, 2131-2168):

    alpha = (r . r0) / (A p . r0)
    q     = u - alpha A p
    x    += alpha (u + q)
    r    -= alpha A (u + q)
    beta  = (r' . r0) / (r . r0)
    u     = r + beta q
    p     = u + beta (q + beta p)

A do-while: the first iteration of every round runs.  A vanishing
``A p . r0`` or ``r . r0`` and a non-finite residual end in DIVERGED unless
the exit verifies; the iteration cap ends in MAX_ITERATIONS_REACHED.
Convergence is verified as in :func:`~.cg.cg_core`: every round restarts the
recursion from the true residual of the current x.  The loop is host-driven
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

__all__ = ["conjugate_gradient_squared", "cgs", "cgs_core"]


@reorder_hoisted
def conjugate_gradient_squared(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` (``a`` need not be symmetric)."""
    from . import _padded, _stencil

    a = as_operator(a)
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    if _stencil.eligible(a):
        return _stencil.stencil_solve("cgs", a, b, x0, epsilon, maxiter, record_residuals)
    if _padded.eligible(a):
        return _padded.padded_solve("cgs", a, b, x0, epsilon, maxiter, record_residuals)
    return cgs_core(matvec_fn(a), dot, b, x0, epsilon, maxiter, record_residuals)


cgs = conjugate_gradient_squared


def _inner(matvec, dotfn, x, r, rr0, k, eps2, eps2_h, tiny, maxiter: int, trace):
    """The CGS recursion from iteration ``k`` (always run) until a claim, a
    breakdown, a non-finite ``rr`` or ``maxiter``.  Frozen iterations leave
    the state as it is."""
    r0 = p = u = r
    q = torch.zeros_like(r)
    rr = rr0
    k_start = k
    bd = torch.zeros((), dtype=torch.bool, device=r.device)

    def active_now():
        return (((rr >= eps2) | (k == k_start)) & (k < maxiter) & ~bd & torch.isfinite(rr))

    active = active_now()
    for _ in _loop.passes(lambda: (active, rr), eps2_h):
        ap = matvec(p)
        denom = dotfn(ap, r0)
        bd1 = torch.abs(denom) < tiny
        alpha = torch.where(bd1 | ~active, 0, rr0 / denom)
        q_n = u - alpha * ap
        uq = u + q_n
        x = torch.where(active, x + alpha * uq, x)
        r = torch.where(active, r - alpha * matvec(uq), r)
        new_rr0 = dotfn(r, r0)
        new_rr = dotfn(r, r)
        bd2 = torch.abs(rr0) < tiny
        beta = torch.where(bd2, 0, new_rr0 / rr0)
        u_n = r + beta * q_n
        p = torch.where(active, u_n + beta * (q_n + beta * p), p)
        u = torch.where(active, u_n, u)
        q = torch.where(active, q_n, q)
        _loop.record_step(trace, k, active, torch.sqrt(new_rr), maxiter)
        bd = torch.where(active, bd1 | bd2, bd)
        rr0 = torch.where(active, new_rr0, rr0)
        rr = torch.where(active, new_rr, rr)
        k = k + active
        active = active_now()
    return x, rr, k, bd, trace


def cgs_core(matvec, dotfn, b, x0, eps, maxiter: int, record: bool) -> SolveResult:
    """CGS core over ``matvec`` and ``dotfn`` (see the module docstring)."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    tiny = torch.finfo(b.dtype).tiny
    r_init = b - matvec(x0)
    trace = _loop.new_trace(torch.sqrt(dotfn(r_init, r_init)), maxiter, record)
    del r_init
    (eps2_h,) = _loop.read(eps2)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    x, floor_rr, hit = x0, math.inf, False
    while True:
        # every round (re)starts the recursion from the true residual
        r_e = b - matvec(x)
        x, rr, k, bd, trace = _inner(matvec, dotfn, x, r_e, dotfn(r_e, r_e), k, eps2, eps2_h,
                                     tiny, maxiter, trace)
        with span("verify"):
            r_t = b - matvec(x)
            t_rr = dotfn(r_t, r_t)
            rr_h, t_rr_h, k_h, bd_h = _loop.read(rr, t_rr, k, bd)
        # a claim is verified even when its iteration tripped a breakdown
        # flag (an entry that had already converged makes the denominator 0)
        claimed = rr_h < eps2_h
        verified = claimed and t_rr_h <= eps2_h
        refuted = claimed and not verified
        stalled = refuted and t_rr_h > floor_rr * 0.25
        hit = hit or stalled  # latch: this exit is a precision floor
        if refuted:
            floor_rr = t_rr_h
        if (bd_h or not math.isfinite(rr_h)) and not verified:
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
