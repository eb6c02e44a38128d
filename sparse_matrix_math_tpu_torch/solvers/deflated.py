"""Deflated CG: the lowest modes removed from the Krylov iteration.

Port of ``sparse_matrix_math_tpu/solvers/deflated.py`` (no reference
equivalent).  CG's iteration count on an ill-conditioned SPD system is set
by its lowest eigenvalues.  Deflation handles k of those modes directly with
a small dense solve and runs CG in the A-orthogonal complement, so the
effective condition number becomes lambda_max / lambda_{k+1} (Saad, Yeung,
Erhel & Guyomarc'h, SISC 21(5), 2000):

* :func:`lanczos_deflation_basis`: m Lanczos steps with full
  reorthogonalisation (one ``(n, m)`` panel; the m x m tridiagonal eigen
  solve on the host), returning the k lowest converged Ritz vectors;
* :func:`deflated_cg`: init-CG.  The W-component of the initial residual is
  eliminated by one (k, k) Cholesky solve, and every search direction is
  A-orthogonalised against W (``P z = z - W G^{-1} (AW)^T z``), which keeps
  ``W^T r = 0``; the residual is re-projected every iteration, and a final
  small solve removes what rounding left in the deflated space.

The Lanczos start vector is NumPy's ``default_rng(seed)`` standard normal
(the port's precedent, ``precond/cheby_poly.py``); :func:`_lanczos_panel`
takes the vector, so it can be handed any.  The loop is host-driven
(solvers/_loop.py): frozen iterations keep the state, one read per chunk.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..formats.reorder import ReorderedMatrix
from ..ops.spmv import as_operator, matvec_fn
from . import _loop
from .types import RUNNING, SolveResult, SolverStatus, resolve_max_iterations

__all__ = ["lanczos_deflation_basis", "deflated_cg"]


def lanczos_deflation_basis(a, n_vectors: int = 8, steps: Optional[int] = None, seed: int = 0,
                            n: Optional[int] = None, residual_rtol: float = 0.1,
                            device=None) -> torch.Tensor:
    """Up to ``n_vectors`` converged lowest Ritz vectors of SPD ``a`` as an
    ``(n, k)`` panel, from ``steps`` (default ``4 * n_vectors``, at most n)
    Lanczos steps with full reorthogonalisation.

    Only Ritz pairs whose residual estimate ``|beta_m * Y[m-1, i]|`` is below
    ``residual_rtol * lambda_i`` are kept (a ``RuntimeWarning`` names how many
    converged): deflating with an unconverged pair re-injects its residual,
    scaled by ``1/lambda_i``, every iteration.  Clustered low spectra (a 1-D
    Laplacian's) may give k = 0; use an exact basis, or more ``steps``.  For a
    callable ``a`` pass ``n`` and ``device``.
    """
    a = as_operator(a)
    if n is None:
        if not hasattr(a, "shape"):
            raise ValueError("lanczos_deflation_basis needs n= for callable operators")
        n = a.shape[0]
    if steps is not None:
        m = int(steps)
        if m > n:
            raise ValueError(f"steps={m} exceeds the system size n={n}")
    else:
        m = min(4 * int(n_vectors), n)
    m = max(min(m, n), 1)
    dtype = getattr(a, "dtype", torch.float32)
    device = getattr(a, "device", device)
    v0 = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(
        device=device, dtype=dtype)
    V, alphas, betas = _lanczos_panel(a, v0, m)

    al = alphas.double().cpu().numpy()
    be = betas.double().cpu().numpy()
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    evals, evecs = np.linalg.eigh(t)  # ascending
    res = np.abs(be[-1] * evecs[-1, :])  # per-pair residual estimates
    cand = np.arange(min(int(n_vectors), m))
    keep = cand[res[cand] < residual_rtol * np.maximum(evals[cand], 0.0)]
    if keep.shape[0] < int(n_vectors):
        warnings.warn(
            f"lanczos_deflation_basis: only {keep.shape[0]} of {int(n_vectors)} requested "
            f"Ritz pairs converged after {m} steps (residual < {residual_rtol}*lambda); "
            "deflating with the converged subset.  More steps, or an exact basis, recover "
            "the rest.", RuntimeWarning, stacklevel=2)
    y = torch.from_numpy(evecs[:, keep]).to(device=V.device, dtype=V.dtype)
    w = V @ y  # (n, k) Ritz vectors, orthonormal up to Lanczos accuracy
    return w / torch.clamp(torch.linalg.norm(w, dim=0, keepdim=True), min=1e-30)


def _lanczos_panel(a, v0: torch.Tensor, m: int):
    """``m`` Lanczos steps from ``v0`` (normalised here) with two classical
    Gram-Schmidt passes against the stored panel per step: the ``(n, m)``
    panel, the alphas and the betas."""
    matvec = matvec_fn(a)
    v0 = v0 / torch.linalg.norm(v0)
    V = torch.zeros((v0.shape[0], m), dtype=v0.dtype, device=v0.device)
    V[:, 0] = v0
    beta = torch.zeros((), dtype=v0.dtype, device=v0.device)
    alphas, betas = [], []
    for j in range(m):
        v = V[:, j]
        w = matvec(v.contiguous())
        if j > 0:
            w = w - beta * V[:, j - 1]
        alpha = torch.dot(v, w)
        w = w - alpha * v
        # columns past j are zero, so the whole-panel product is exact
        for _ in range(2):
            w = w - V @ (V.T @ w)
        beta = torch.linalg.norm(w)
        if j + 1 < m:
            V[:, j + 1] = w / torch.clamp(beta, min=1e-30)
        alphas.append(alpha)
        betas.append(beta)
    return V, torch.stack(alphas), torch.stack(betas)


def deflated_cg(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    deflation_basis: Optional[torch.Tensor] = None,
    n_deflate: int = 8,
    preconditioner=None,
) -> SolveResult:
    """Solve SPD ``a @ x = b`` with the lowest modes deflated.

    ``deflation_basis`` is an ``(n, k)`` panel W (build it once with
    :func:`lanczos_deflation_basis` and reuse it across solves with the same
    operator); None builds one of ``n_deflate`` vectors.  ``preconditioner``
    composes as in :func:`~.cg.cg`.
    """
    a = as_operator(a)
    if isinstance(a, ReorderedMatrix):
        # the permutation is hoisted here, not by reorder_hoisted: the
        # basis rows must be permuted along with b and x0
        res = deflated_cg(
            a.inner, a.to_permuted(b), None if x0 is None else a.to_permuted(x0),
            max_iterations, epsilon,
            deflation_basis=(None if deflation_basis is None
                             else a.to_permuted(deflation_basis)),
            n_deflate=n_deflate, preconditioner=preconditioner)
        return dataclasses.replace(res, x=a.from_permuted(res.x))
    n = b.shape[0]
    w = deflation_basis
    if w is None:
        w = lanczos_deflation_basis(a, n_vectors=n_deflate, n=n, device=b.device)
    if w.ndim != 2 or w.shape[0] != n:
        raise ValueError(f"deflation basis must be (n, k) = ({n}, *), got {tuple(w.shape)}")
    if w.shape[1] == 0:
        # nothing converged to deflate with: plain (P)CG, same result contract
        from .cg import conjugate_gradient

        return conjugate_gradient(a, b, x0, max_iterations, epsilon,
                                  preconditioner=preconditioner)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    mapply = (lambda r: r) if preconditioner is None else preconditioner.apply
    return _deflated_cg_loop(matvec_fn(a), mapply, w, b, x0, epsilon, maxiter)


def _deflated_cg_loop(matvec, mapply, w, b, x0, eps, maxiter: int) -> SolveResult:
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    aw = matvec(w)  # (n, k): the products take panels
    chol, info = torch.linalg.cholesky_ex(w.T @ aw)  # the (k, k) SPD Gram matrix
    chol = torch.where(info != 0, float("nan"), chol)

    def gsolve(u):
        return torch.cholesky_solve(u[:, None], chol)[:, 0]

    def project(z):
        # P z = z - W G^{-1} (AW)^T z, so that (AW)^T P z = 0
        return z - w @ gsolve(aw.T @ z)

    # init-CG: the W-component of the initial residual goes by one small
    # dense solve; afterwards W^T r = 0 and the projected directions keep it
    r = b - matvec(x0)
    x = x0 + w @ gsolve(w.T @ r)
    r = b - matvec(x)
    z = mapply(r)
    rz = torch.dot(r, z)
    rr = torch.dot(r, r)
    p = project(z)
    status = torch.where(rr <= eps2, int(SolverStatus.SUCCESS), RUNNING)
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    def active_now():
        return (status == RUNNING) & (k < maxiter)

    active = active_now()
    while _loop.running(active):
        for _ in range(_loop.CHUNK):
            ap = matvec(p)
            alpha = rz / torch.dot(p, ap)
            x_n = x + alpha * p
            r_n = r - alpha * ap
            # the residual re-projected every iteration: in f32 the G^{-1}
            # amplification (1/lambda_min) lets rounding re-grow the
            # deflated component until the solve diverges
            r_n = r_n - aw @ gsolve(w.T @ r_n)
            z = mapply(r_n)
            new_rz = torch.dot(r_n, z)
            rr = torch.dot(r_n, r_n)
            new_status = torch.where(
                ~torch.isfinite(rr), int(SolverStatus.DIVERGED),
                torch.where(rr <= eps2, int(SolverStatus.SUCCESS), RUNNING))
            p_n = project(z) + (new_rz / rz) * p
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, new_rz, rz)
            status = torch.where(active, new_status, status)
            k = k + active
            active = active_now()
    # the final W-component correction: whatever deflated-space residual
    # rounding accumulated goes by one more small dense solve
    rfin = b - matvec(x)
    coef = gsolve(w.T @ rfin)
    x = x + w @ coef
    rfin = rfin - aw @ coef
    status_h, k_h = _loop.read(status, k)
    status_h = int(status_h)
    if status_h == RUNNING:
        status_h = int(SolverStatus.MAX_ITERATIONS_REACHED)
    return SolveResult(x=x, status=status_h, iterations=int(k_h),
                       residual_norm=torch.sqrt(torch.dot(rfin, rfin)))
