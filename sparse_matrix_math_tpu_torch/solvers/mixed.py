"""Mixed-precision CG: the matrix stored in bfloat16, float32 vectors,
true-residual iterative refinement.

Port of ``sparse_matrix_math_tpu/solvers/mixed.py:48-235``.  The padded DIA
product is bound by bytes and the diagonal planes are most of them, so the
matrix is stored in ``matrix_dtype`` (bfloat16 by default) while every
vector, dot and axpy stays float32.  The inner CG runs on the rounded
operator ``Ã`` through the bf16-diagonal call shape of K2
(``csrc/dia_spmv.cu``: each value widened exactly, products and sums in
float32); for matrices whose values bfloat16 holds exactly (small-integer
stencils) ``Ã == A``.

The accuracy contract:

* the outer loop is classical iterative refinement: each round recomputes
  ``r = b - A x`` with the float32 operator, solves ``Ã d = r / ||r||`` to a
  relative ``inner_rho`` with the lean CG of ``solvers/ir_df64.py``
  (``_inner_cg``, as the JAX package imports its own, ``mixed.py:87``), and
  sets ``x += ||r|| d``;
* convergence is judged only on the true float32-operator residual, so
  ``status`` and ``residual_norm`` mean what they mean everywhere else;
* a round that fails to shrink ``||r||^2`` 4-fold (the bfloat16 floor
  above ``epsilon``) ends at MAX_ITERATIONS_REACHED, a non-finite residual
  at DIVERGED.

``iterations`` counts inner iterations; each round adds two float32
products, the entry recompute and the post-round true residual.  The JAX
package nests both loops in one jitted ``while_loop``.  Here the outer loop
runs on the host with one scalar readback per round, as ``ir_df_core``
(``solvers/ir_df64.py``) does, and the inner solve in chunks
(``solvers/_loop.py``).

Not ported: the ``except Exception`` fallback of ``mixed_cg`` and
``_mixed_cg_xla_jit`` (JAX ``mixed.py:184-199, 238-257``).  They exist for
Mosaic refusals on the TPU; on the card a failed build or launch raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..formats.dia import DIAMatrix
from ..formats.triplet import torch_dtype
from ..ops.dia_spmv import dia_spmv_padded, pad_dia
from . import _loop
from .ir_df64 import _inner_cg
from .types import SolveResult, SolverStatus, resolve_max_iterations

__all__ = ["mixed_cg", "ir_core", "loop_counts", "reset_loop_counts"]

# Refinement rounds run since the last reset: each costs two float32
# products, so a solve launches 1 + 2 * rounds of them (chip_smoke.py and
# the card tests predict the float32 K2 launches from it).
loop_counts = {"rounds": 0}


def reset_loop_counts() -> None:
    for name in loop_counts:
        loop_counts[name] = 0


def ir_core(matvec_hi, matvec_lo, dotfn, b: torch.Tensor, x0: torch.Tensor, eps: float,
            maxiter: int, *, inner_rho: float = 1.0 / 256.0,
            max_outer: int = 40) -> SolveResult:
    """Iterative refinement: the outer residual in ``matvec_hi``'s
    precision, lean CG correction solves on ``matvec_lo``.

    ``eps`` and ``inner_rho`` are taken in ``b``'s dtype, and every
    comparison of the loop runs on values of that dtype, as in the JAX
    core."""
    dt, dev = b.dtype, b.device
    eps_t = torch.tensor(eps, dtype=dt, device=dev)
    eps2 = float(eps_t * eps_t)
    rho = torch.tensor(inner_rho, dtype=dt, device=dev)
    tiny = torch.tensor(1e-30, dtype=dt, device=dev)

    r0 = b - matvec_hi(x0)
    rr = dotfn(r0, r0)
    del r0
    x, total, outer = x0, 0, 0
    status = SolverStatus.SUCCESS if _loop.read(rr)[0] < eps2 else None
    while status is None and total < maxiter and outer < max_outer:
        # the entry recompute keeps nothing but x between rounds; the rhs
        # goes in at unit norm, so the inner solve needs a relative cut
        r = b - matvec_hi(x)
        rr_e = dotfn(r, r)
        rn = torch.sqrt(rr_e)
        bu = r / torch.maximum(rn, tiny)
        # past eps on the final round, a fixed relative cut before it
        rho_eff = torch.maximum(rho, eps_t * 0.5 / torch.maximum(rn, eps_t))
        d, k_in = _inner_cg(matvec_lo, None, dotfn, bu, rho_eff * rho_eff, maxiter - total)
        x = x + rn * d
        r2 = b - matvec_hi(x)  # the true residual: float32 operator
        rr = dotfn(r2, r2)
        k_h, new_h, rre_h = _loop.read(k_in, rr, rr_e)
        total += int(k_h)
        outer += 1
        loop_counts["rounds"] += 1
        if not math.isfinite(new_h):
            status = SolverStatus.DIVERGED
        elif new_h < eps2:
            status = SolverStatus.SUCCESS
        elif new_h > rre_h * 0.25:
            # the inner solve no longer shrinks the true residual: the
            # low-precision floor lies above eps
            status = SolverStatus.MAX_ITERATIONS_REACHED
    if status is None:
        status = SolverStatus.MAX_ITERATIONS_REACHED
    return SolveResult(x=x, status=int(status), iterations=total, residual_norm=torch.sqrt(rr))


def mixed_cg(a, b: torch.Tensor, x0: Optional[torch.Tensor] = None, max_iterations: int = -1,
             epsilon: float = 1e-8, *, matrix_dtype=torch.bfloat16,
             inner_rho: float = 1.0 / 256.0, max_outer: int = 40) -> SolveResult:
    """CG with the matrix streamed in ``matrix_dtype`` (default bfloat16),
    on ``a``'s device.

    ``a`` must be a :class:`DIAMatrix` (the bfloat16 win is the diagonal
    stream; build one with ``try_dia_from_csr``).  ``b`` is float32: the
    vectors, the dots and the reported residual stay in it, and the narrow
    kernel takes a float32 x.  ``inner_rho`` is the relative reduction of
    each refinement round; ``max_outer`` caps the rounds.
    """
    if not isinstance(a, DIAMatrix):
        raise ValueError("mixed_cg needs a DIA-format matrix (the bf16 win is the "
                         "diagonal-plane stream); build one with try_dia_from_csr")
    if b.dtype != torch.float32:
        raise TypeError(f"mixed_cg keeps its vectors in float32; b is {b.dtype}")
    lo_dtype = torch_dtype(matrix_dtype)
    if not lo_dtype.is_floating_point:
        raise TypeError(f"matrix_dtype {matrix_dtype!r} is no floating dtype")
    n = b.shape[0]
    if x0 is None:
        x0 = torch.zeros_like(b)
    maxiter = resolve_max_iterations(max_iterations, n)
    pdia_hi = pad_dia(a if a.dtype == b.dtype else a.astype(b.dtype))
    pdia_lo = dataclasses.replace(pdia_hi, diags_p=pdia_hi.diags_p.to(lo_dtype))

    res = ir_core(lambda v: dia_spmv_padded(pdia_hi, v),
                  lambda v: dia_spmv_padded(pdia_lo, v), torch.dot,
                  pdia_hi.to_padded(b), pdia_hi.to_padded(x0.to(b.dtype)), float(epsilon),
                  maxiter, inner_rho=float(inner_rho), max_outer=int(max_outer))
    return dataclasses.replace(res, x=pdia_hi.from_padded(res.x))
