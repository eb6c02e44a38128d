"""Pipelined Conjugate Gradient: one fused reduction per iteration.

Port of ``sparse_matrix_math_tpu/solvers/pipelined.py`` (Ghysels & Vanroose,
"Hiding global synchronization latency in the preconditioned Conjugate
Gradient algorithm", 2014; no reference equivalent).  Textbook CG needs two
dependent dots per iteration; the pipelined recurrence makes both
reductions, gamma = (r, r) and delta = (w, r), available at once, so a
distributed layer merges them into one collective (``dot2fn``) and overlaps
the product q = A w with it:

    r0 = b - A x0;  w0 = A r0
    loop i:
      gamma = (r, r);  delta = (w, r)        # one fused reduction
      q = A w
      beta  = 0 (i=0) else gamma/gamma_prev
      alpha = gamma/delta (i=0) else gamma / (delta - beta * gamma / alpha_prev)
      z = q + beta z;  s = w + beta s;  p = r + beta p
      x += alpha p;  r -= alpha s;  w -= alpha z

Every ``replace_every`` iterations the true residual r = b - A x and the
auxiliary recurrences w, s, z are recomputed from scratch (periodic residual
replacement, Ghysels & Vanroose §4: four extra products per period), which
bounds the recurrence's drift; the attainable accuracy of the pipelined
recurrence in f32 stays above tight tolerances at high condition numbers.
Convergence is the recurrence's ``gamma < eps^2`` (of the iteration before),
as in the JAX core: no verification round and no ``floor_hit``.

The loop is host-driven (solvers/_loop.py): frozen iterations keep every
state tensor, one host read per chunk.  The replacement steps fall on
iteration numbers the host knows, so only they run the extra products.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..formats.reorder import reorder_hoisted
from ..ops.spmv import as_operator, matvec_fn
from . import _loop
from .types import RUNNING, SolveResult, SolverStatus, harmonize_dtypes, resolve_max_iterations

__all__ = ["cg_pipelined", "cg_pipelined_core"]


def _dot2_local(u1, v1, u2, v2):
    """Two dots on one device."""
    return torch.dot(u1, v1), torch.dot(u2, v2)


@reorder_hoisted
def cg_pipelined(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    record_residuals: bool = False,
    replace_every: int = 50,
) -> SolveResult:
    """Solve SPD ``a @ x = b`` with pipelined CG.  ``replace_every``: the
    true-residual replacement period (0 disables it)."""
    a = as_operator(a)
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    return cg_pipelined_core(matvec_fn(a), _dot2_local, b, x0, epsilon, maxiter,
                             record_residuals, replace_every=int(replace_every))


def cg_pipelined_core(matvec, dot2fn, b, x0, eps, maxiter: int, record: bool,
                      replace_every: int = 50) -> SolveResult:
    """Algorithm core; ``dot2fn(u1, v1, u2, v2) -> (d1, d2)`` computes both
    inner products (a distributed layer supplies one fused reduction)."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    r = b - matvec(x0)
    w = matvec(r)
    gamma0, _ = dot2fn(r, r, w, r)
    trace = _loop.new_trace(torch.sqrt(gamma0), maxiter, record)
    zero = torch.zeros_like(b)
    x, p, s, z = x0, zero, zero, zero
    gamma_prev = torch.ones((), dtype=b.dtype, device=b.device)
    alpha_prev = gamma_prev
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    status = torch.where(gamma0 < eps2, int(SolverStatus.SUCCESS), RUNNING)

    def active_now():
        return (status == RUNNING) & (k < maxiter)

    active = active_now()
    k_h = 0  # k at the start of each chunk: every earlier iteration ran
    while _loop.running(active):
        for i in range(_loop.CHUNK):
            gamma, delta = dot2fn(r, r, w, r)  # one fused reduction
            q = matvec(w)
            first = k == 0
            beta = torch.where(first, 0.0, gamma / gamma_prev)
            alpha = gamma / torch.where(first, delta, delta - beta * gamma / alpha_prev)
            z_n = q + beta * z
            s_n = w + beta * s
            p_n = r + beta * p
            x_n = x + alpha * p_n
            if replace_every > 0 and (k_h + i + 1) % replace_every == 0:
                # periodic true-residual replacement
                r_n = b - matvec(x_n)
                w_n = matvec(r_n)
                s_n = matvec(p_n)
                z_n = matvec(s_n)
            else:
                r_n = r - alpha * s_n
                w_n = w - alpha * z_n
            new_status = torch.where(
                ~torch.isfinite(gamma), int(SolverStatus.DIVERGED),
                torch.where(gamma < eps2, int(SolverStatus.SUCCESS), RUNNING))
            _loop.record_step(trace, k, active, torch.sqrt(gamma), maxiter)
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            w = torch.where(active, w_n, w)
            p = torch.where(active, p_n, p)
            s = torch.where(active, s_n, s)
            z = torch.where(active, z_n, z)
            gamma_prev = torch.where(active, gamma, gamma_prev)
            alpha_prev = torch.where(active, alpha, alpha_prev)
            status = torch.where(active, new_status, status)
            k = k + active
            active = active_now()
        k_h += _loop.CHUNK
    rr, _ = dot2fn(r, r, r, r)
    status_h, k_h = _loop.read(status, k)
    status_h = int(status_h)
    if status_h == RUNNING:
        status_h = int(SolverStatus.MAX_ITERATIONS_REACHED)
    return SolveResult(x=x, status=status_h, iterations=int(k_h), residual_norm=torch.sqrt(rr),
                       residual_trace=trace)
