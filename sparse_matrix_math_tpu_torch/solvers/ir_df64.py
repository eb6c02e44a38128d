"""Iterative refinement to the f64 contract at f32 iteration cost.

Port of ``sparse_matrix_math_tpu/solvers/ir_df64.py``.  Classical
mixed-precision refinement (Wilkinson; Carson & Higham, SIAM J. Sci.
Comput. 2018):

* the outer loop keeps ``x`` as a double-word (hi, lo) pair and computes the
  true residual ``r = b - A x`` with the double-word operator (kernel K9 on a
  DIA operator);
* each round solves ``A d = r / ||r||`` with a lean float32 CG or BiCGStab
  on the hi-plane operator to a relative reduction ``inner_rho``;
* ``x <- x (+df) ||r|| d``; convergence is judged on the double-word true
  residual alone.  A round that makes it worse is reverted; one that fails
  to shrink ``||r||^2`` 4x (and was not cut by the round cap) reports the
  precision floor as MAX_ITERATIONS_REACHED.

With a DIA inner operator, and no preconditioner, Jacobi, or a
:class:`~..precond.padded_sgs.PaddedSGS` of the matrix's layout, the inner
solve runs in the padded layout on every device: each matvec is one K2
launch and each SGS apply one K4 launch on a card, as in ``padded_solve``.
Any other preconditioner applies to logical vectors through ``apply``, as
the JAX package's ``obj`` branch does.

The JAX package nests both loops as ``lax.while_loop``s inside one jit.
Here both are host-driven: the outer round on the host, one host read per
round; the inner solve in chunks of iterations, a finished iteration frozen
by ``torch.where`` (solvers/_loop.py).  The retry after a Mosaic refusal
(:459-475) exists only on the TPU and is not ported.  With a grid-stencil
inner operator and no preconditioner or Jacobi, the inner solve keeps its
carries in the grid layout (:218-228), as ``solvers/_stencil.py`` does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..formats.dia import DIAMatrix
from ..formats.ell import ELLMatrix
from ..formats.stencil import GridStencilMatrix
from ..ops.df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    DfGridStencil,
    df_matvec_fn,
    df_norm2,
    df_scale_add,
    df_sub,
)
from ..ops.dia_spmv import dia_spmv_padded, pad_dia
from ..ops.spmv import matvec_fn
from ..precond.padded_sgs import PaddedSGS
from ..precond.preconditioners import JacobiPreconditioner
from . import _loop
from .df64 import DfSolveResult, _setup
from .types import SolverStatus

__all__ = ["bicgstab_ir_df64", "cg_ir_df64", "hi_operator"]


def hi_operator(a_df):
    """The float32 (hi-plane) operator of a double-word matrix: the inner
    solves run on it, and the outer double-word residual corrects its
    2^-24 rounding."""
    if isinstance(a_df, DfGridStencil):
        return GridStencilMatrix(coeffs=a_df.coeffs_hi, doffs=a_df.doffs, dims=a_df.dims,
                                 shape=a_df.shape, nnz=a_df.nnz)
    if isinstance(a_df, DfDiaMatrix):
        return DIAMatrix(diags=a_df.diags_hi, offsets=a_df.offsets, shape=a_df.shape,
                         nnz=a_df.nnz)
    if isinstance(a_df, DfEllMatrix):
        return ELLMatrix(vals=a_df.vals_hi, cols=a_df.cols, shape=a_df.shape, nnz=a_df.nnz)
    raise TypeError(f"no hi-plane operator for {type(a_df).__name__}; pass inner_matrix=")


def _inner_cg(matvec, apply_, dotfn, bu, rho2, cap: int):
    """Lean (P)CG: reduce ``||bu - A d||`` below ``sqrt(rho2)`` (``bu`` has
    unit norm) or stop at ``cap`` iterations or a breakdown.  Unverified on
    purpose: the outer loop judges the double-word true residual.  Returns
    (d, iterations as a 0-d tensor)."""
    d = torch.zeros_like(bu)
    r = bu
    z = r if apply_ is None else apply_(r)
    rz, rr = dotfn(r, z), dotfn(r, r)
    p = z
    k = torch.zeros((), dtype=torch.int64, device=bu.device)
    alive = (rr > rho2) & (cap > 0)
    while _loop.running(alive):
        for _ in _loop.chunk():
            ap = matvec(p)
            pap = dotfn(p, ap)
            # guard before the division: a step with pap <= 0 adds nothing
            alpha = torch.where(pap > 0.0, rz / pap, 0.0)
            d_n = d + alpha * p
            r_n = r - alpha * ap
            rr_n = dotfn(r_n, r_n)
            if apply_ is None:
                z, rz_n = r_n, rr_n
            else:
                z = apply_(r_n)
                rz_n = dotfn(r_n, z)
            p_n = z + (rz_n / rz) * p
            k_n = k + 1
            ok = torch.isfinite(rr_n) & (pap > 0.0) & (rz_n != 0.0)
            d, r, p, rz, rr, k = (torch.where(alive, n, o) for n, o in
                                  ((d_n, d), (r_n, r), (p_n, p), (rz_n, rz), (rr_n, rr), (k_n, k)))
            alive = alive & ok & (rr_n > rho2) & (k_n < cap)
    return d, k


def _inner_bicgstab(matvec, apply_, dotfn, bu, rho2, cap: int):
    """Lean BiCGStab: reduce ``||bu - A d||`` below ``sqrt(rho2)`` relative
    to the preconditioned right-hand side, or stop at ``cap`` or a
    breakdown.  Every matvec result passes through M^{-1} (the reference's
    residual form, h:2233-2257).  Returns the best iterate by the recurrence
    residual, so a late f32 explosion within a round cannot hand the outer
    loop garbage, and the iterations as a 0-d tensor."""
    pre = (lambda v: v) if apply_ is None else apply_
    tiny = torch.finfo(bu.dtype).tiny
    d = torch.zeros_like(bu)
    r = pre(bu)
    r0 = r
    rr0, rr = dotfn(r, r0), dotfn(r, r)
    rho2s = rho2 * rr  # relative to the M^{-1}-normed right-hand side
    p, best_d, best_rr = r, d, rr
    k = torch.zeros((), dtype=torch.int64, device=bu.device)
    alive = (rr > rho2s) & (cap > 0)
    while _loop.running(alive):
        for _ in _loop.chunk():
            ap = pre(matvec(p))
            denom = dotfn(ap, r0)
            bd1 = torch.abs(denom) < tiny
            alpha = torch.where(bd1, 0.0, rr0 / denom)
            sv = r - alpha * ap
            asv = pre(matvec(sv))
            asas = dotfn(asv, asv)
            bd2 = torch.abs(asas) < tiny
            omega = torch.where(bd2, 0.0, dotfn(asv, sv) / asas)
            d_n = d + alpha * p + omega * sv
            r_n = sv - omega * asv
            rr_n = dotfn(r_n, r_n)
            rr0_n = dotfn(r_n, r0)
            bd3 = (torch.abs(rr0) < tiny) | (torch.abs(omega) < tiny)
            beta = torch.where(bd3, 0.0, (rr0_n * alpha) / (rr0 * omega))
            p_n = r_n + beta * (p - omega * ap)
            k_n = k + 1
            better = rr_n < best_rr
            best_d_n = torch.where(better, d_n, best_d)
            best_rr_n = torch.where(better, rr_n, best_rr)
            ok = torch.isfinite(rr_n) & ~(bd1 | bd2 | bd3)
            d, r, p, rr0, rr, best_d, best_rr, k = (
                torch.where(alive, n, o) for n, o in
                ((d_n, d), (r_n, r), (p_n, p), (rr0_n, rr0), (rr_n, rr), (best_d_n, best_d),
                 (best_rr_n, best_rr), (k_n, k)))
            alive = alive & ok & (rr_n > rho2s) & (k_n < cap)
    return best_d, k


_INNER = {"cg": _inner_cg, "bicgstab": _inner_bicgstab}


def ir_df_core(true_residual, matvec, apply_, dotfn, lift, drop, b, x0, eps2, rho2,
               maxiter: int, max_outer: int, inner_kind: str, round_cap: int = 0):
    """The refinement loop over its closures: ``true_residual(x_df) ->
    (r_df, hi word of ||r||^2)`` in double-word, ``matvec``/``apply_``/
    ``dotfn`` the f32 inner machinery, ``lift``/``drop`` the hops into and
    out of the inner domain.  ``round_cap`` (0 = none) bounds the inner
    iterations of one round: a capped round is exempt from the stall test.

    Returns (x_hi, x_lo, ||r||^2 hi word, total inner iterations, rounds,
    status)."""
    cap = round_cap if round_cap and round_cap > 0 else maxiter
    x_hi, x_lo = x0
    (r_hi, _), rn2 = true_residual(x0)
    rn2_h, eps2_h = _loop.read(rn2, eps2)
    total = outer = 0
    status = (SolverStatus.SUCCESS if rn2_h <= eps2_h
              else SolverStatus.MAX_ITERATIONS_REACHED if maxiter == 0 else None)
    while status is None:
        rn = torch.sqrt(rn2)
        d_l, k_in = _INNER[inner_kind](matvec, apply_, dotfn, lift(r_hi / rn), rho2,
                                       min(maxiter - total, cap))
        d = drop(d_l)
        nx = df_scale_add((x_hi, x_lo), (rn, torch.zeros_like(rn)), (d, torch.zeros_like(d)))
        (nr_hi, _), rn2_new = true_residual(nx)
        k_h, new_h = _loop.read(k_in, rn2_new)
        total += int(k_h)
        outer += 1
        # a round that made the true residual worse is reverted: the
        # returned iterate is always the best seen
        worse = not new_h <= rn2_h or not math.isfinite(new_h)
        stalled = worse or (new_h > 0.25 * rn2_h and k_h < cap)
        if not worse:
            x_hi, x_lo = nx
            r_hi, rn2, rn2_h = nr_hi, rn2_new, new_h
        if rn2_h <= eps2_h:
            status = SolverStatus.SUCCESS
        elif not math.isfinite(rn2_h):  # only when the start was not finite
            status = SolverStatus.DIVERGED
        elif stalled or total >= maxiter or outer >= max_outer:
            status = SolverStatus.MAX_ITERATIONS_REACHED
    return x_hi, x_lo, rn2, total, outer, status


def _ir_front(inner_kind, a, b, x0, max_iterations, epsilon, preconditioner, inner_rho,
              max_outer, inner_matrix, round_cap=None) -> DfSolveResult:
    """The refinement front door shared by :func:`cg_ir_df64` and
    :func:`bicgstab_ir_df64`; ``inner_kind`` picks the correction solver."""
    if not float(epsilon) ** 2 > 0.0 or float(epsilon) < 2e-19:
        raise ValueError(f"epsilon must satisfy eps^2 > f32 tiny (eps >= ~2e-19); got {epsilon!r}")
    a_df, b, x0, maxiter, eps2 = _setup(a, b, x0, max_iterations, epsilon)
    rho2 = torch.tensor(float(inner_rho) ** 2, dtype=torch.float32, device=a_df.device)
    a_in = inner_matrix if inner_matrix is not None else hi_operator(a_df)

    pre, pre_kind = preconditioner, "none"
    if isinstance(pre, JacobiPreconditioner):
        pre_kind = "jacobi"
    elif isinstance(pre, PaddedSGS):
        pre_kind = "sgs"
    elif pre is not None:
        if not hasattr(pre, "apply"):
            raise TypeError(f"preconditioner must expose apply(r) -> z; got {type(pre).__name__}")
        pre_kind = "obj"

    pdia = pad_dia(a_in) if isinstance(a_in, DIAMatrix) and pre_kind != "obj" else None
    if pre_kind == "sgs" and (pdia is None or (pre.shape, pre.lead, pre.n_total)
                              != (a_in.shape, pdia.lead, pdia.n_total)):
        # another layout: PaddedSGS.apply takes logical vectors, so the inner
        # solve runs on them too
        pre_kind, pdia = "obj", None

    dotfn = torch.dot
    if pdia is not None:
        matvec = lambda v: dia_spmv_padded(pdia, v)  # noqa: E731
        lift, drop = pdia.to_padded, pdia.from_padded
    elif isinstance(a_in, GridStencilMatrix) and pre_kind in ("none", "jacobi"):
        # grid-resident inner solve; a preconditioner object applies to flat
        # vectors, so it stays on the generic branch below
        a_grid = a_in if a_in.dtype == torch.float32 else a_in.astype(torch.float32)
        matvec = a_grid.apply_grid
        lift, drop = a_grid.to_grid, a_grid.from_grid
        dotfn = lambda u, v: torch.sum(u * v)  # noqa: E731
    else:
        matvec = matvec_fn(a_in)
        lift = drop = lambda v: v  # noqa: E731
    if pre_kind == "jacobi":
        invp = lift(pre.inv_diag.to(torch.float32))  # guard zeros stay 0
        apply_ = lambda r: r * invp  # noqa: E731
    elif pre_kind == "sgs":
        apply_ = (pre if pre.dtype == torch.float32 else pre.astype(torch.float32)).apply_padded
    elif pre_kind == "obj":
        apply_ = lambda r: pre.apply(r).to(r.dtype)  # noqa: E731
    else:
        apply_ = None

    # per-round inner budget: none for CG; 256 for BiCGStab, whose f32
    # recurrence can explode inside a long round
    if round_cap is None:
        round_cap = 0 if inner_kind == "cg" else 256
    df_mv = df_matvec_fn(a_df)

    def true_residual(x):
        r = df_sub(b, df_mv(x))
        return r, df_norm2(r)[0]

    x_hi, x_lo, rn2, total, outer, status = ir_df_core(
        true_residual, matvec, apply_, dotfn, lift, drop, b, x0, eps2, rho2, maxiter,
        int(max_outer), inner_kind, int(round_cap))
    return DfSolveResult(x_hi=x_hi, x_lo=x_lo, status=int(status), iterations=total,
                         residual_norm2=rn2, outer_rounds=outer)


def cg_ir_df64(a, b, x0=None, max_iterations: int = -1, epsilon: float = 1e-8, *,
               preconditioner=None, inner_rho: float = 1e-2, max_outer: int = 60,
               inner_matrix=None, round_cap: Optional[int] = None) -> DfSolveResult:
    """Solve ``a @ x = b`` (SPD ``a``) to f64 accuracy at ~f32 cost.

    Same operator and vector conventions and accuracy bar as
    :func:`~.df64.cg_df64`, but each iteration is a plain f32 CG step: only
    the true residual of each round runs in double-word.

    Args:
      a: ``DfDiaMatrix`` / ``DfEllMatrix`` or a ``CSRMatrix``.
      b, x0: as for ``cg_df64``.
      max_iterations: cap on the total inner iterations; -1 means n.
      epsilon: threshold on the double-word true residual ``||b - A x||``.
      preconditioner: of the inner solve — ``JacobiPreconditioner``, a
        ``PaddedSGS`` of the inner operator's layout (one K4 launch per
        apply on a card), or any object with ``apply(r) -> z``.
      inner_rho: relative reduction each inner solve aims at.
      max_outer: cap on refinement rounds (the stall test usually ends first).
      inner_matrix: the inner operator (default: ``hi_operator(a)``).
      round_cap: inner iterations per round; None means none for CG.
    """
    return _ir_front("cg", a, b, x0, max_iterations, epsilon, preconditioner, inner_rho,
                     max_outer, inner_matrix, round_cap)


def bicgstab_ir_df64(a, b, x0=None, max_iterations: int = -1, epsilon: float = 1e-8, *,
                     preconditioner=None, inner_rho: float = 1e-2, max_outer: int = 60,
                     inner_matrix=None, round_cap: Optional[int] = None) -> DfSolveResult:
    """Solve ``a @ x = b`` (general square ``a``) to f64 accuracy at ~f32
    cost: :func:`cg_ir_df64` with f32 BiCGStab correction solves (the
    reference's BiCGStab, h:2191-2303).  The inner solve applies the
    preconditioner after every matvec and keeps its best iterate; the round
    cap defaults to 256 iterations."""
    return _ir_front("bicgstab", a, b, x0, max_iterations, epsilon, preconditioner,
                     inner_rho, max_outer, inner_matrix, round_cap)
