"""CG and BiCGStab in double-word f32 arithmetic.

Port of ``sparse_matrix_math_tpu/solvers/df64.py``.  The reference solves in
``double`` (include/sparse_matrix_math.h:2316-2398) to a 1e-8 residual
(test/include/test_common.h:30-38).  These solvers run the whole recurrence —
operator, vectors, dots and scalars — as (hi, lo) pairs of float32
(ops/df32.py), the JAX package's way to reach that contract on a TPU, which
has no float64.  On a DIA operator each matvec is the kernel K9; the vector
ops are plain PyTorch, as the JAX package leaves them to XLA.

The ``while_loop``s of ``_cg_df_core`` (:129-179) and ``_bicgstab_df_core``
(:182-260) run host-driven (solvers/_loop.py): a chunk of iterations at a
time, a finished iteration frozen by ``torch.where`` on both words of every
carry, so the statuses and iteration counts are the JAX cores'.  The retries
after a Mosaic refusal (:289-302, :340-353) exist only on the TPU and are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.stencil import GridStencilMatrix
from ..ops.df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    DfGridStencil,
    df_div,
    df_dot,
    df_dots,
    df_from_host,
    df_matvec_fn,
    df_mul,
    df_norm2,
    df_operator_from_host_csr,
    df_scale_add,
    df_sub,
    df_to_host,
)
from . import _loop
from .types import RUNNING, SolverStatus, resolve_max_iterations

__all__ = ["DfSolveResult", "bicgstab_df64", "cg_df64"]

Df = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DfSolveResult:
    """Result of a double-word solve; ``x_hi + x_lo`` is the f64-grade
    solution (:meth:`x_f64` recombines it on the host).

    ``x_hi``, ``x_lo`` and ``residual_norm2`` (the hi word of the final
    ``||r||^2``, a 0-d float32 tensor) stay on the device; ``status``,
    ``iterations`` and ``outer_rounds`` (the refinement rounds of
    ``cg_ir_df64``/``bicgstab_ir_df64``, each one double-word SpMV on top of
    ``iterations`` inner f32 steps) are Python ints."""

    x_hi: torch.Tensor
    x_lo: torch.Tensor
    status: int
    iterations: int
    residual_norm2: torch.Tensor
    outer_rounds: Optional[int] = None

    @property
    def x(self) -> torch.Tensor:
        return self.x_hi

    def x_f64(self) -> np.ndarray:
        return df_to_host((self.x_hi, self.x_lo))

    def status_enum(self) -> SolverStatus:
        return SolverStatus(int(self.status))

    @property
    def success(self) -> bool:
        return int(self.status) == SolverStatus.SUCCESS

    def __repr__(self) -> str:
        return (f"DfSolveResult(status={self.status_enum().name}, "
                f"iterations={int(self.iterations)}, "
                f"residual_norm={float(self.residual_norm2) ** 0.5:.3e})")


def _as_df_operator(a):
    """A double-word operator as it is, or one built from a CSR matrix or a
    grid stencil on its device: float64 values keep 2^-48, float32 ones give
    zero lo planes (an f32-accurate operator, a double-word recurrence)."""
    if isinstance(a, (DfEllMatrix, DfDiaMatrix, DfGridStencil)):
        return a
    if isinstance(a, GridStencilMatrix):
        return DfGridStencil.from_stencil(a)
    if isinstance(a, CSRMatrix):
        return df_operator_from_host_csr(a.data.cpu().numpy(), a.indices.cpu().numpy(),
                                         a.indptr.cpu().numpy(), a.shape, device=a.device)
    raise TypeError(
        "a double-word solve needs a DfDiaMatrix/DfEllMatrix/DfGridStencil "
        "(load_matrix_df / df_operator_from_host_csr), a CSRMatrix or a "
        "GridStencilMatrix; got " + type(a).__name__
    )


def _as_df_vector(b, device) -> Df:
    """``b`` as an (hi, lo) pair on ``device``: a pair as given, float64
    values (NumPy or tensor) split exactly, anything else rounded to float32
    with a zero lo word."""
    if isinstance(b, tuple) and len(b) == 2:
        return tuple(torch.as_tensor(w, device=device).to(torch.float32) for w in b)
    if (isinstance(b, np.ndarray) and b.dtype == np.float64) or (
            isinstance(b, torch.Tensor) and b.dtype == torch.float64):
        return df_from_host(b, device=device)
    b = torch.as_tensor(b, device=device).to(torch.float32)
    return b, torch.zeros_like(b)


def _setup(a, b, x0, max_iterations, epsilon):
    a = _as_df_operator(a)
    b = _as_df_vector(b, a.device)
    n = b[0].shape[0]
    x0 = ((b[0].new_zeros(n), b[0].new_zeros(n)) if x0 is None
          else _as_df_vector(x0, a.device))
    maxiter = resolve_max_iterations(max_iterations, n)
    eps2 = torch.tensor(float(epsilon) ** 2, dtype=torch.float32, device=a.device)
    return a, b, x0, maxiter, eps2


def _freeze(active: torch.Tensor, new: Df, old: Df) -> Df:
    return torch.where(active, new[0], old[0]), torch.where(active, new[1], old[1])


def _status(done, failed, k, maxiter: int) -> torch.Tensor:
    """SUCCESS if ``done``, else DIVERGED if ``failed``, else
    MAX_ITERATIONS_REACHED at ``k >= maxiter``, else RUNNING."""
    running = torch.where(k >= maxiter, int(SolverStatus.MAX_ITERATIONS_REACHED), RUNNING)
    return torch.where(done, int(SolverStatus.SUCCESS),
                       torch.where(failed, int(SolverStatus.DIVERGED), running))


def _status0(rr_hi: torch.Tensor, eps2, maxiter: int) -> torch.Tensor:
    """The status before the first iteration."""
    other = int(SolverStatus.MAX_ITERATIONS_REACHED) if maxiter == 0 else RUNNING
    return torch.where(rr_hi <= eps2, int(SolverStatus.SUCCESS), other)


def _cg_df_core(mv, b: Df, x0: Df, maxiter: int, eps2):
    """Double-word CG (the recurrence of solvers/cg.py's core, every
    quantity an (hi, lo) pair); returns (x, ||r||^2, k, status)."""
    x = x0
    r = df_sub(b, mv(x0))
    rr = df_norm2(r)
    p = r
    k = torch.zeros((), dtype=torch.int64, device=b[0].device)
    status = _status0(rr[0], eps2, maxiter)
    active = status == RUNNING
    while _loop.running(active):
        for _ in _loop.chunk():
            ap = mv(p)
            pap = df_dot(p, ap)
            alpha = df_div(rr, pap)
            x_n = df_scale_add(x, alpha, p)
            r_n = df_scale_add(r, (-alpha[0], -alpha[1]), ap)
            rr_n = df_norm2(r_n)
            beta = df_div(rr_n, rr)
            p_n = df_scale_add(r_n, beta, p)  # p = r + beta p
            k_n = k + 1
            finite = torch.isfinite(rr_n[0]) & torch.isfinite(pap[0]) & (pap[0] != 0.0)
            st = _status(rr_n[0] <= eps2, ~finite, k_n, maxiter)
            x, r, p, rr = (_freeze(active, n, o) for n, o in
                           ((x_n, x), (r_n, r), (p_n, p), (rr_n, rr)))
            k = torch.where(active, k_n, k)
            status = torch.where(active, st, status)
            active = status == RUNNING
    return x, rr, k, status


def _bicgstab_df_core(mv, b: Df, x0: Df, maxiter: int, eps2):
    """Double-word BiCGStab (solvers/bicgstab.py's recurrence,
    unpreconditioned, every quantity an (hi, lo) pair).  At ~2^-47 the
    recurrence residual does not drift from b - A x, so there is no restart
    machinery; the exit recomputes the true residual once and the reported
    norm and SUCCESS rest on it.  Returns (x, ||b - A x||^2, k, status)."""
    tiny = torch.finfo(torch.float32).tiny
    x = x0
    r = df_sub(b, mv(x0))
    r0 = r
    rr0, rr = df_dots(r, (r0, r))
    p = r
    k = torch.zeros((), dtype=torch.int64, device=b[0].device)
    status = _status0(rr[0], eps2, maxiter)
    active = status == RUNNING
    while _loop.running(active):
        for _ in _loop.chunk():
            ap = mv(p)
            denom = df_dot(ap, r0)
            bd1 = torch.abs(denom[0]) < tiny
            alpha = df_div(rr0, denom)
            sv = df_scale_add(r, (-alpha[0], -alpha[1]), ap)
            asv = mv(sv)
            asv_sv, asas = df_dots(asv, (sv, asv))
            bd2 = torch.abs(asas[0]) < tiny
            omega = df_div(asv_sv, asas)
            x_n = df_scale_add(df_scale_add(x, alpha, p), omega, sv)
            r_n = df_scale_add(sv, (-omega[0], -omega[1]), asv)
            rr_n, rr0_n = df_dots(r_n, (r_n, r0))
            bd3 = (torch.abs(rr0[0]) < tiny) | (torch.abs(omega[0]) < tiny)
            beta = df_div(df_mul(rr0_n, alpha), df_mul(rr0, omega))
            t = df_scale_add(p, (-omega[0], -omega[1]), ap)
            p_n = df_scale_add(r_n, beta, t)
            k_n = k + 1
            failed = bd1 | bd2 | bd3 | ~torch.isfinite(rr_n[0])
            st = _status(rr_n[0] <= eps2, failed, k_n, maxiter)
            x, r, p, rr0, rr = (_freeze(active, n, o) for n, o in
                                ((x_n, x), (r_n, r), (p_n, p), (rr0_n, rr0), (rr_n, rr)))
            k = torch.where(active, k_n, k)
            status = torch.where(active, st, status)
            active = status == RUNNING
    rr_true = df_norm2(df_sub(b, mv(x)))
    refuted = (status == int(SolverStatus.SUCCESS)) & (rr_true[0] > eps2)
    status = torch.where(refuted, int(SolverStatus.MAX_ITERATIONS_REACHED), status)
    return x, rr_true, k, status


def _result(x: Df, rr: Df, k, status) -> DfSolveResult:
    status_h, k_h = _loop.read(status, k)
    return DfSolveResult(x_hi=x[0], x_lo=x[1], status=int(status_h), iterations=int(k_h),
                         residual_norm2=rr[0])


def cg_df64(a, b, x0=None, max_iterations: int = -1, epsilon: float = 1e-8) -> DfSolveResult:
    """Solve ``a @ x = b`` for SPD ``a`` in double-word arithmetic, on the
    operator's device.

    Args:
      a: :class:`~..ops.df32.DfDiaMatrix` / :class:`~..ops.df32.DfEllMatrix`
        (``load_matrix_df`` or ``df_operator_from_host_csr`` keep float64
        values), or a ``CSRMatrix``.
      b: float64 values (NumPy or tensor, split exactly), an (hi, lo) pair,
        or anything else (rounded to float32, zero lo word).
      x0: optional initial guess, same conventions as ``b``.
      max_iterations: -1 means n (reference convention, h:2345-2347).
      epsilon: threshold on ``||r||``; the hi word of ``||r||^2`` is held to
        ``epsilon**2`` rounded to float32.
    """
    a, b, x0, maxiter, eps2 = _setup(a, b, x0, max_iterations, epsilon)
    return _result(*_cg_df_core(df_matvec_fn(a), b, x0, maxiter, eps2))


def bicgstab_df64(a, b, x0=None, max_iterations: int = -1,
                  epsilon: float = 1e-8) -> DfSolveResult:
    """Solve ``a @ x = b`` (general square ``a``) in double-word arithmetic:
    the nonsymmetric counterpart of :func:`cg_df64`, with the same operator
    and vector conventions (reference BiCGStab, h:2191-2303).  Breakdowns
    end in DIVERGED."""
    a, b, x0, maxiter, eps2 = _setup(a, b, x0, max_iterations, epsilon)
    return _result(*_bicgstab_df_core(df_matvec_fn(a), b, x0, maxiter, eps2))
