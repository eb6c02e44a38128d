"""Multi-RHS (blocked) CG: one panel product feeds every right-hand side.

Port of ``sparse_matrix_math_tpu/solvers/block.py`` (``cg_multi``,
``MultiSolveResult``, ``_cg_multi_loop``).  The reference solves one
right-hand side per call (include/sparse_matrix_math.h:2316-2320); this
runs m independent CG recurrences ("batched CG", not O'Leary's block CG)
through one loop:

* one panel product ``A @ P`` per iteration instead of m products — on a
  W-SELL matrix one launch of K8 (``csrc/sell_spmv.cu``'s panel
  instantiation) per 8 columns, each slot read once for every column;
* per-column dots and axpys as reductions over the panel;
* per-column freeze masks: a column that converged or broke down stops
  updating while the rest go on; a broken column keeps its last finite
  iterate.

The contract is the JAX loop's (:145-422): the inner recurrence exits when
any active column claims convergence (``rr <= eps^2``), breaks down, or
the cap is reached; each outer round computes ONE panel true residual that
serves every verdict (verified, refuted and restarted from the true
residual, stalled at its precision floor, broken); columns that stop at the
cap get their true residual at the end.  Column j equals its own
:func:`~.cg.cg` run up to the dots' summation order.

What differs from the JAX package, and why:

* **The loop** is the port's host-driven chunked loop (``solvers/_loop.py``)
  in place of the nested ``lax.while_loop``: an iteration whose loop
  condition is false keeps every state tensor bit for bit, so the iteration
  counts are the JAX loop's; the host reads one flag per chunk and per outer
  round.
* **The panel layout.**  JAX carries panels column-index-leading, ``(m, n)``,
  because TPU tiling pads an ``(n, m)`` panel's lane axis to 128 (JAX
  :160-169), and batches the operator by ``jax.vmap`` or a transpose
  sandwich chosen by ``_probe_mode`` (:130-142, 210-228).  The card has no
  lane padding, and K8 reads row-major ``(n, m)`` panels (one column word
  fetches k contiguous values), so the port carries the user-facing
  ``(n, m)`` panel on the DIA branch and for every other operator, whose
  2-D ``rmult`` takes it as it is (W-SELL: K8; ELL: the same panel kernel;
  R-SELL: one chain per column, as JAX ``ops/spmv.py:_rmult_routed``).  The
  grid-stencil branch keeps JAX's leading-batch grid layout ``(m, *dims)``
  for ``GridStencilMatrix.apply_batched`` (JAX :172-183).  A callable
  operator is applied column by column.
* **The preconditioner** gets the ``(n, m)`` panel: the applies of
  ``precond/preconditioners.py`` take one; the padded DIA applies
  (``PaddedSGS``, ``PaddedTriPair``) take a vector and run column by column.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..formats.reorder import reorder_hoisted
from ..ops.spmv import as_operator, rmult
from . import _loop
from .types import (
    RUNNING,
    SolveResult,
    SolverStatus,
    harmonize_dtypes,
    resolve_max_iterations,
)

__all__ = ["cg_multi", "MultiSolveResult"]

_SUCCESS = int(SolverStatus.SUCCESS)
_DIVERGED = int(SolverStatus.DIVERGED)
_MAX_ITERATIONS = int(SolverStatus.MAX_ITERATIONS_REACHED)

# Instrumentation, beside _loop.host_syncs; no user reads it: what the loops
# ran since the last reset, outer rounds, iterations run by the chunks
# (frozen ones included; each is one panel product) and final
# true-residual fixes.  The panel products of a solve are steps + rounds + 1
# (the initial residual) + residual_fixes; a preconditioner adds its apply
# to each step and round and one for the initial residual.  chip_smoke.py
# and the card tests predict K8's launches from it.
loop_counts = {"rounds": 0, "steps": 0, "residual_fixes": 0}


def reset_loop_counts() -> None:
    for name in loop_counts:
        loop_counts[name] = 0


@dataclasses.dataclass(frozen=True)
class MultiSolveResult:
    """Per-column outcome of a multi-RHS solve.

    ``x`` is ``(n, m)``; ``status`` (int32 :class:`SolverStatus` values),
    ``iterations`` (int32, the count at the column's freeze) and
    ``residual_norm`` (the true ``||b_j - A x_j||``) are ``(m,)`` tensors on
    the solve's device.  ``residual_trace`` is the ``(maxiter + 1, m)``
    per-column ``||r||`` history (NaN beyond a column's freeze), or None.
    """

    x: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor
    residual_norm: torch.Tensor
    residual_trace: Optional[torch.Tensor] = None

    def __getitem__(self, j: int) -> SolveResult:
        """The j-th column's outcome as a plain :class:`SolveResult`."""
        return SolveResult(
            x=self.x[:, j],
            status=int(self.status[j]),
            iterations=int(self.iterations[j]),
            residual_norm=self.residual_norm[j],
            residual_trace=None if self.residual_trace is None else self.residual_trace[:, j],
        )


@reorder_hoisted
def cg_multi(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    preconditioner=None,
    record_residuals: bool = False,
) -> MultiSolveResult:
    """Solve ``a @ X = B`` for SPD ``a`` and ``B`` of shape ``(n, m)``.

    Equivalent to m independent :func:`~.cg.cg` runs (the same iterates per
    column), at about the cost of the slowest column: every iteration is one
    panel product and per-column reductions.  ``preconditioner`` is any
    object whose ``apply`` takes an ``(n, m)`` panel (every preconditioner
    of ``precond/`` does); each column then runs the PCG recurrence.
    """
    a = as_operator(a)
    if b.ndim != 2:
        raise ValueError(f"cg_multi expects B of shape (n, m), got {tuple(b.shape)}")
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, b.shape[0])
    return _cg_multi_loop(_Panel.of(a, preconditioner, b.shape[1]), b, x0, epsilon, maxiter,
                          bool(record_residuals))


@dataclasses.dataclass(frozen=True)
class _Panel:
    """How the loop carries and applies a panel: the carried layout
    (``lift`` from and ``drop`` to the user's ``(n, m)``), the operator and
    preconditioner on it, a per-column ``(m,)`` vector broadcast over it
    (``cb``) and the per-column dot (``coldot``)."""

    lift: object
    drop: object
    matvec: object
    mapply: object
    cb: object
    coldot: object

    @classmethod
    def of(cls, a, precond, m: int) -> "_Panel":
        from ..formats.dia import DIAMatrix
        from ..formats.stencil import GridStencilMatrix

        apply = None if precond is None else _panel_apply(precond)
        if isinstance(a, GridStencilMatrix):
            dims = a.dims
            axes = tuple(range(1, len(dims) + 1))

            def lift(b2):  # (n, m) -> (m, *dims)
                return b2.T.reshape((m,) + dims)

            def drop(xg):
                return xg.reshape(m, -1).T.contiguous()

            mapply = None if apply is None else (lambda rg: lift(apply(drop(rg))))
            return cls(lift, drop, a.apply_batched, mapply,
                       lambda v: v.reshape((m,) + (1,) * len(dims)),
                       lambda u, v: (u * v).sum(dim=axes))
        if isinstance(a, DIAMatrix) and a.offsets:
            matvec = _dia_panel_matvec(a)
        elif callable(a):  # a matvec of one vector
            def matvec(xs):
                return torch.stack([a(xs[:, j]) for j in range(xs.shape[1])], dim=1)
        else:  # a matrix of the port's formats or a dense tensor: its panel rmult
            def matvec(xs):
                return rmult(a, xs)
        return cls(_same, _same, matvec, apply, lambda v: v.reshape(1, m),
                   lambda u, v: (u * v).sum(dim=0))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _dia_panel_matvec(a):
    """The explicit shifted-slice DIA apply on an ``(n_cols, m)`` panel (JAX
    :184-209): rows padded once, then one slice and one multiply-add per
    stored diagonal, in offset order.  Plain torch ops, as JAX's is XLA."""
    n_rows, n_cols = a.shape
    lpad = max(-min(a.offsets), 0)
    rpad = max(max(a.offsets) + n_rows - n_cols, 0)

    def matvec(xs):
        dtype = torch.promote_types(a.dtype, xs.dtype)
        xp = torch.nn.functional.pad(xs.to(dtype), (0, 0, lpad, rpad))
        y = torch.zeros((n_rows, xs.shape[1]), dtype=dtype, device=xs.device)
        for d, off in enumerate(a.offsets):
            y = y + a.diags[d].to(dtype)[:, None] * xp[lpad + off:lpad + off + n_rows]
        return y

    return matvec


def _panel_apply(precond):
    """``precond.apply`` on an ``(n, m)`` panel; the padded DIA applies take
    one vector, so they run column by column."""
    from ..precond.padded_sgs import PaddedSGS
    from ..precond.padded_tri import PaddedTriPair

    if isinstance(precond, (PaddedSGS, PaddedTriPair)):
        return lambda rs: torch.stack([precond.apply(rs[:, j].contiguous())
                                       for j in range(rs.shape[1])], dim=1)
    return precond.apply


def _record(trace, k, go, upd, value, maxiter: int) -> None:
    """``trace[k + 1] = value`` where ``upd``, NaN elsewhere, in an
    iteration that runs (``go``); a frozen iteration writes nothing."""
    if trace is None:
        return
    idx = torch.clamp(k + 1, max=maxiter).reshape(1).long()
    row = torch.where(upd, value, torch.full_like(value, math.nan))
    trace.index_put_((idx,), torch.where(go, row, trace[idx][0]).unsqueeze(0))


def _cg_multi_loop(pn: _Panel, b, x0, epsilon, maxiter: int, record: bool) -> MultiSolveResult:
    dev, m = b.device, b.shape[1]
    eps = torch.as_tensor(epsilon, dtype=b.dtype, device=dev)
    eps2 = eps * eps
    matvec, mapply, cb, coldot = pn.matvec, pn.mapply, pn.cb, pn.coldot
    has_z = mapply is not None

    b_l, x = pn.lift(b), pn.lift(x0)
    r = b_l - matvec(x)
    rr = coldot(r, r)
    status = torch.where(rr <= eps2, _SUCCESS, RUNNING).to(torch.int32)
    trace = None
    if record:
        trace = torch.full((maxiter + 1, m), math.nan, dtype=b.dtype, device=dev)
        trace[0] = torch.sqrt(rr)
    z = mapply(r) if has_z else r
    rz = coldot(r, z) if has_z else rr
    p = z
    k = torch.zeros((), dtype=torch.int32, device=dev)
    iters = torch.zeros(m, dtype=torch.int32, device=dev)
    floor_rr = torch.full((m,), math.inf, dtype=rr.dtype, device=dev)

    while _loop.running(torch.any(status == RUNNING) & (k < maxiter)):
        loop_counts["rounds"] += 1
        broken = torch.zeros(m, dtype=torch.bool, device=dev)

        def go_now():
            # the inner loop's condition: no active column claims or broke
            active = status == RUNNING
            claim_or_break = active & ((rr <= eps2) | broken | ~torch.isfinite(rr))
            return torch.any(active) & ~torch.any(claim_or_break) & (k < maxiter)

        go = go_now()
        while _loop.running(go):
            for _ in _loop.chunk():
                loop_counts["steps"] += 1
                active = (status == RUNNING) & ~broken & go
                ap = matvec(p)
                denom = coldot(ap, p)
                raw_alpha = rz / denom
                now_broken = active & (~torch.isfinite(denom) | ~torch.isfinite(raw_alpha)
                                       | ((denom == 0) & (rr > eps2)))
                upd = active & ~now_broken
                alpha = torch.where(upd, raw_alpha, 0)
                x = torch.where(go, x + cb(alpha) * p, x)
                r = torch.where(cb(upd), r - cb(alpha) * ap, r)
                new_rr = torch.where(upd, coldot(r, r), rr)
                if has_z:
                    z = torch.where(cb(upd), mapply(r), z)
                    new_rz = torch.where(upd, coldot(r, z), rz)
                else:
                    z, new_rz = r, new_rr
                beta = torch.where(upd, new_rz / torch.where(rz == 0, 1, rz), 0)
                p = torch.where(cb(upd), z + cb(beta) * p, p)
                iters = torch.where(upd, k + 1, iters)
                _record(trace, k, go, upd, torch.sqrt(new_rr), maxiter)
                rr, rz = new_rr, torch.where(upd, new_rz, rz)
                broken = broken | now_broken
                k = k + go
                go = go_now()

        active = status == RUNNING
        broken = active & (broken | ~torch.isfinite(rr))
        claimed = active & (rr <= eps2) & ~broken
        # one panel true residual serves every verdict of this round
        r_t = b_l - matvec(x)
        t_rr = coldot(r_t, r_t)
        verified = claimed & (t_rr <= eps2)
        refuted = claimed & ~verified
        stalled = refuted & (t_rr > floor_rr * 0.25)
        floor_rr = torch.where(refuted, t_rr, floor_rr)
        status = torch.where(
            broken, _DIVERGED,
            torch.where(verified, _SUCCESS,
                        torch.where(stalled | (active & (k >= maxiter)), _MAX_ITERATIONS,
                                    status))).to(torch.int32)
        # refuted columns restart from the true residual; finished columns
        # freeze their r at it, so residual_norm is the true one
        reset = refuted | verified | stalled | broken
        r = torch.where(cb(reset), r_t, r)
        z_t = mapply(r_t) if has_z else r_t
        z = torch.where(cb(reset), z_t, z) if has_z else r
        p = torch.where(cb(refuted), z_t, p)
        rz = torch.where(refuted, coldot(r_t, z_t) if has_z else t_rr, rz)
        rr = torch.where(reset, t_rr, rr)

    status = torch.where(status == RUNNING, _MAX_ITERATIONS, status).to(torch.int32)
    # a column that stopped at the cap inside the recurrence carries a
    # recurrence residual: then the panel's true residual, once
    rr = coldot(r, r)
    if _loop.running(torch.any(status == _MAX_ITERATIONS)):
        loop_counts["residual_fixes"] += 1
        r_t = b_l - matvec(x)
        rr = coldot(r_t, r_t)
    return MultiSolveResult(x=pn.drop(x), status=status, iterations=iters,
                            residual_norm=torch.sqrt(rr), residual_trace=trace)
