"""Chebyshev semi-iteration: the Krylov-type solver with no inner reductions.

Port of ``sparse_matrix_math_tpu/solvers/chebyshev.py`` (no reference
equivalent).  Every CG iteration needs two reductions (two collectives on a
mesh); the Chebyshev recurrence needs none, only its periodic convergence
check reduces.  The price is a spectrum interval [lmin, lmax] of the SPD
``A``, estimated by Lanczos (:func:`lanczos_extremal`, widened by
:func:`widen_eig_bounds`) when not given.  Both helpers live in
``precond/cheby_poly.py``, which the polynomial preconditioner shares; its
Lanczos start vector is NumPy's ``default_rng(seed)``, so auto-bounded runs
differ from the JAX package's in that vector alone.

Recurrence (Saad §12.1):

    theta = (lmax + lmin)/2,  delta = (lmax - lmin)/2
    d_0 = r_0 / theta;  rho_0 = delta / theta
    x_{k+1} = x_k + d_k;  r_{k+1} = b - A x_{k+1}
    rho_{k+1} = 1 / (2/rho_0 - rho_k)
    d_{k+1} = rho_{k+1} rho_k d_k + (2 rho_{k+1} / delta) r_{k+1}

The loop is host-driven (solvers/_loop.py): each check runs ``check_every``
steps (fewer at the cap) and one ``r . r``; a chunk of checks runs between
host reads, and a check after the solve stopped keeps the state as it was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..formats.reorder import reorder_hoisted
from ..ops.spmv import as_operator, matvec_fn
from ..ops.vector import dot
from ..precond.cheby_poly import lanczos_extremal, widen_eig_bounds
from . import _loop
from .types import RUNNING, SolveResult, SolverStatus, harmonize_dtypes, resolve_max_iterations

__all__ = ["chebyshev", "chebyshev_core", "lanczos_extremal", "widen_eig_bounds"]


@reorder_hoisted
def chebyshev(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    eig_bounds: Optional[Tuple[float, float]] = None,
    check_every: int = 10,
    record_residuals: bool = False,
) -> SolveResult:
    """Solve SPD ``a @ x = b`` by Chebyshev semi-iteration.

    ``eig_bounds``: (lmin, lmax) containing the spectrum; None estimates them
    by Lanczos, widened.  ``check_every``: the residual norm (the only
    reduction) is evaluated every this many iterations.
    """
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    if eig_bounds is None:
        eig_bounds = widen_eig_bounds(*lanczos_extremal(a, k=min(32, n), n=n,
                                                        device=b.device))
    return chebyshev_core(matvec_fn(a), dot, b, x0, epsilon, float(eig_bounds[0]),
                          float(eig_bounds[1]), maxiter, int(check_every), record_residuals)


def chebyshev_core(matvec, dotfn, b, x0, eps, lmin: float, lmax: float, maxiter: int,
                   check_every: int, record: bool) -> SolveResult:
    """Algorithm core over ``matvec`` and ``dotfn``; the ``check_every``-step
    inner recurrence performs no reductions."""
    dtype, dev = b.dtype, b.device
    theta = torch.tensor((lmax + lmin) / 2.0, dtype=dtype, device=dev)
    delta = torch.tensor((lmax - lmin) / 2.0, dtype=dtype, device=dev)
    eps = torch.as_tensor(eps, dtype=dtype, device=dev)
    eps2 = eps * eps
    r = b - matvec(x0)
    rr0 = dotfn(r, r)
    trace = None
    if record:
        trace = torch.full((-(-maxiter // check_every) + 1,), float("nan"), dtype=dtype,
                           device=dev)
        trace[0] = torch.sqrt(rr0)
    x, d, rho = x0, r / theta, delta / theta
    status = torch.where(rr0 < eps2, int(SolverStatus.SUCCESS), RUNNING)
    per_chunk = max(1, _loop.CHUNK // check_every)
    k = 0  # iterations at the start of each chunk: every earlier check ran
    k_run = torch.zeros((), dtype=torch.int64, device=dev)
    active = status == RUNNING
    while k < maxiter and _loop.running(active):
        for _ in range(per_chunk):
            steps = min(check_every, maxiter - k)
            if steps <= 0:
                break
            xn, rn, dn, rhon = x, r, d, rho
            for _ in range(steps):
                # x update, then the fresh residual by one product
                xn = xn + dn
                rn = b - matvec(xn)
                new_rho = 1.0 / (2.0 / (delta / theta) - rhon)
                dn = new_rho * rhon * dn + (2.0 * new_rho / delta) * rn
                rhon = new_rho
            rr = dotfn(rn, rn)  # the only reduction
            new_status = torch.where(
                ~torch.isfinite(rr), int(SolverStatus.DIVERGED),
                torch.where(rr < eps2, int(SolverStatus.SUCCESS), RUNNING))
            if trace is not None:
                i = k // check_every + 1
                trace[i] = torch.where(active, torch.sqrt(rr), trace[i])
            x = torch.where(active, xn, x)
            r = torch.where(active, rn, r)
            d = torch.where(active, dn, d)
            rho = torch.where(active, rhon, rho)
            status = torch.where(active, new_status, status)
            k_run = k_run + active * steps
            active = status == RUNNING
            k += steps
    rr = dotfn(r, r)
    status_h, k_h = _loop.read(status, k_run)
    status_h = int(status_h)
    if status_h == RUNNING:
        status_h = int(SolverStatus.MAX_ITERATIONS_REACHED)
    return SolveResult(x=x, status=status_h, iterations=int(k_h), residual_norm=torch.sqrt(rr),
                       residual_trace=trace)
