"""Differentiable solves by implicit differentiation.

Port of ``sparse_matrix_math_tpu/solvers/implicit.py`` (no reference
equivalent).  The solution ``x = A^{-1} b`` of an SPD system is made
differentiable by the implicit function theorem instead of through the
Krylov loop:

    dL/db    = A^{-1} g           (one more CG solve, A symmetric)
    dL/dA_ij = -(A^{-1} g)_i x_j  at the stored positions only

JAX returns the matrix cotangent as a ``CSRMatrix``/``DIAMatrix``; here it
lands, as PyTorch's idiom has it, on the matrix's value tensor: ``a.data``
(CSR) or ``a.diags`` (DIA), when that tensor requires grad.  Other formats
solve forward and raise the JAX package's ``TypeError`` in the backward pass.
"""

from __future__ import annotations

import torch

from ..formats.csr import CSRMatrix
from ..formats.dia import DIAMatrix
from .cg import conjugate_gradient

__all__ = ["cg_solve"]


def _values(a):
    if isinstance(a, CSRMatrix):
        return a.data
    if isinstance(a, DIAMatrix):
        return a.diags
    return None


class _CGSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, b, a, epsilon, max_iterations):
        x = conjugate_gradient(a, b, epsilon=epsilon, max_iterations=max_iterations).x
        ctx.a, ctx.epsilon, ctx.max_iterations = a, epsilon, max_iterations
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        a = ctx.a
        if not isinstance(a, (CSRMatrix, DIAMatrix)):
            raise TypeError(f"cg_solve gradients support CSR/DIA, got {type(a).__name__}")
        # the adjoint solve: A lam = g (A symmetric)
        lam = conjugate_gradient(a, g.contiguous(), epsilon=ctx.epsilon,
                                 max_iterations=ctx.max_iterations).x
        grad_values = None
        if ctx.needs_input_grad[0]:
            if isinstance(a, CSRMatrix):
                grad_values = -lam[a.row_ids] * x[a.indices]
            else:
                n_rows, n_cols = a.shape
                idx = torch.arange(n_rows, device=x.device)
                rows = []
                for off in a.offsets:
                    cols = idx + off
                    valid = (cols >= 0) & (cols < n_cols)
                    xs = x[torch.clamp(cols, 0, n_cols - 1)]
                    rows.append(torch.where(valid, -lam * xs, 0.0))
                grad_values = torch.stack(rows)
        return grad_values, lam, None, None, None


def cg_solve(a, b: torch.Tensor, epsilon: float = 1e-8, max_iterations: int = -1
             ) -> torch.Tensor:
    """Differentiable ``x = A^{-1} b`` for SPD ``a`` (CSR or DIA).

    Forward: :func:`~.cg.conjugate_gradient`; backward: one adjoint CG solve.
    Returns only ``x``; call :func:`~.cg.cg` for the status and iterations
    (which are not differentiable).
    """
    return _CGSolve.apply(_values(a), b, a, epsilon, max_iterations)
