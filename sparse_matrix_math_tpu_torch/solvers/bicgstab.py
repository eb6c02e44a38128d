"""BiCGStab — transpose-free stabilised BiCG, optionally preconditioned.

Port of ``sparse_matrix_math_tpu/solvers/bicgstab.py:45-278`` (reference
``BiCGStab``, include/sparse_matrix_math.h:2191-2303).  Same contract as
the JAX core:

* the residuals are preconditioned (``r <- M^{-1}(b - A x)``, ``ap =
  M^{-1} A p``, ``as = M^{-1} A s``) and convergence is ``||r|| <= eps`` on
  the norm itself (h:2277);
* division-by-zero breakdowns are caught (DIVERGED unless verified);
* the inner recurrence runs at most 64 iterations; each outer round
  evaluates the true residual once, for the verify, the best-iterate sample
  and the honest ``residual_norm``;
* a refuted claim restarts from the true residual; ``floor_hit`` latches
  when a restart fails to halve the true residual norm;
* a residual above ``_EXPLOSION_FACTOR`` x the best one seen is an
  explosion (DIVERGED), and every exit returns the BEST iterate.

The loop is host-driven (solvers/_loop.py).
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

__all__ = ["bicgstab", "bicgstab_core"]

# Divergence cutoff: a residual above this multiple of the best seen is an
# explosion, not a transient (legitimate f32 spikes reach ~2.3e4x the best
# and recover; see the JAX package's bicgstab.py).
_EXPLOSION_FACTOR = 1e6
_ROUND = 64  # inner iterations between true-residual samples


@reorder_hoisted
def bicgstab(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    preconditioner=None,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve ``a @ x = b`` (``a`` may be nonsymmetric or indefinite)."""
    from . import _padded, _stencil

    a = as_operator(a)
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    if _stencil.eligible(a, preconditioner):
        return _stencil.stencil_solve("bicgstab", a, b, x0, epsilon, maxiter,
                                      record_residuals, preconditioner=preconditioner)
    if _padded.eligible(a, preconditioner):
        return _padded.padded_solve("bicgstab", a, b, x0, epsilon, maxiter,
                                    record_residuals, preconditioner=preconditioner)
    precond = (lambda v: v) if preconditioner is None else preconditioner.apply
    return bicgstab_core(matvec_fn(a), precond, dot, b, x0, epsilon, maxiter,
                         record_residuals)


def _inner(matvec, precond, dotfn, x, r, r0, p, rr0, k, k_h: int, chunk_end: int, eps, eps_h,
           explode_at, tiny, trace, maxiter: int):
    """The BiCGStab recurrence from iteration ``k`` (``k_h`` on the host)
    until a claimed convergence, a breakdown, an explosion or ``chunk_end``."""
    res_norm = torch.sqrt(dotfn(r, r))
    bd = torch.zeros((), dtype=torch.bool, device=r.device)

    def active_now():
        return (res_norm > eps) & (k < chunk_end) & ~bd & (res_norm < explode_at)

    active = active_now()
    for _ in _loop.passes(lambda: (active, res_norm), eps_h, chunk_end - k_h):
        ap = precond(matvec(p))
        denom = dotfn(ap, r0)
        bd1 = torch.abs(denom) < tiny
        alpha = torch.where(bd1 | ~active, 0, rr0 / denom)
        s = r - alpha * ap
        as_ = precond(matvec(s))
        asas = dotfn(as_, as_)
        bd2 = torch.abs(asas) < tiny
        omega = torch.where(bd2 | ~active, 0, dotfn(as_, s) / asas)
        x = torch.where(active, x + alpha * p + omega * s, x)
        r = torch.where(active, s - omega * as_, r)
        new_res_norm = torch.sqrt(dotfn(r, r))
        new_rr0 = dotfn(r, r0)
        bd3 = (torch.abs(rr0) < tiny) | (torch.abs(omega) < tiny)
        beta = torch.where(bd3, 0, (new_rr0 * alpha) / (rr0 * omega))
        p = torch.where(active, r + beta * (p - omega * ap), p)
        bd = torch.where(active, bd1 | bd2 | bd3 | ~torch.isfinite(new_res_norm), bd)
        _loop.record_step(trace, k, active, new_res_norm, maxiter)
        rr0 = torch.where(active, new_rr0, rr0)
        res_norm = torch.where(active, new_res_norm, res_norm)
        k = k + active
        active = active_now()
    return x, r, p, rr0, res_norm, k, bd, trace


def bicgstab_core(matvec, precond, dotfn, b, x0, eps, maxiter: int,
                  record: bool) -> SolveResult:
    """BiCGStab core over ``matvec``/``precond``/``dotfn`` (see the module
    docstring)."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    tiny = torch.finfo(b.dtype).tiny
    factor = torch.tensor(_EXPLOSION_FACTOR, dtype=b.dtype, device=b.device)

    r_init = precond(b - matvec(x0))
    rr0 = dotfn(r_init, r_init)
    res_norm0 = torch.sqrt(rr0)
    trace = _loop.new_trace(res_norm0, maxiter, record)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    x, r, r0, p = x0, r_init, r_init, r_init
    best_x, best_norm = x0, res_norm0
    res_norm0_h, eps_h = _loop.read(res_norm0, eps)
    status = SolverStatus.SUCCESS if res_norm0_h <= eps_h else None
    floor, hit, k_h = math.inf, False, 0
    while status is None:
        explode_at = best_norm * factor
        x, r, p, rr0, res_norm, k, bd, trace = _inner(
            matvec, precond, dotfn, x, r, r0, p, rr0, k, k_h, min(k_h + _ROUND, maxiter),
            eps, eps_h, explode_at, tiny, trace, maxiter,
        )
        with span("verify"):
            r_t = precond(b - matvec(x))
            t_rr = dotfn(r_t, r_t)
            t_norm = torch.sqrt(t_rr)
            res_h, t_norm_h, k_h, bd_h, explode_h, best_h = _loop.read(
                res_norm, t_norm, k, bd, explode_at, best_norm)
        k_h = int(k_h)
        claimed = res_h <= eps_h
        verified = claimed and t_norm_h <= eps_h
        refuted = claimed and not verified
        stalled = refuted and t_norm_h > floor * 0.5
        hit = hit or stalled  # latch: this exit is a precision floor
        if refuted:
            floor = t_norm_h
        if t_norm_h < best_h:
            best_x, best_norm = x, t_norm
        exploded = res_h >= explode_h
        # a verified exit is SUCCESS even when the final step also tripped
        # a breakdown guard (an exact solve makes s = 0)
        if ((bd_h and not refuted) or not math.isfinite(res_h) or exploded) and not verified:
            status = SolverStatus.DIVERGED
        elif verified:
            status = SolverStatus.SUCCESS
        elif stalled or k_h >= maxiter:
            status = SolverStatus.MAX_ITERATIONS_REACHED
        if refuted:
            # full restart: shadow vector and direction reset to the true residual
            r, r0, p, rr0 = r_t, r_t, r_t, t_rr
    return SolveResult(
        x=best_x, status=int(status), iterations=k_h, residual_norm=best_norm,
        residual_trace=trace,
        floor_hit=hit and status == SolverStatus.MAX_ITERATIONS_REACHED,
    )
