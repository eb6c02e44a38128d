"""Grid-resident solve path for matrix-free stencils.

Port of ``sparse_matrix_math_tpu/solvers/_stencil.py``, the twin of
:mod:`._padded` for :class:`~..formats.stencil.GridStencilMatrix` operators:
every solver vector stays in the N-D grid layout for the whole solve (one
reshape before the loop, one after), so an iteration is the stencil pass plus
the vector ops.  The cores take any layout (matvec and dotfn are parameters);
this module is plumbing.  No kernel here, as in the JAX package (plain XLA
there, :12): the stencil pass is plain torch ops.

The JAX module has a second CG loop for large n, ``_cg_hbm`` (:175-253):
the recurrence in one jit whose carries enter as arguments, and the
verify/restart/floor logic on the host, because XLA's memory-space assignment
otherwise pins the wrong carry in the TPU's VMEM (``_HBM_REGIME_BYTES``,
:36-47).  That is a TPU mechanism.  The port's cores are host-driven at every
size (solvers/_loop.py) with ``_cg_hbm``'s result contract (status,
iterations, true residual, ``floor_hit``), so one path serves both regimes.
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.stencil import GridStencilMatrix
from ..precond.cheby_poly import ChebyshevPreconditioner, cheby_apply_fn
from ..precond.preconditioners import JacobiPreconditioner
from ..utils.profiling import span, spanned
from .bicg_symmetric import bicg_symmetric_core
from .bicgstab import bicgstab_core
from .cg import cg_core, pcg_core
from .cgs import cgs_core
from .types import SolveResult

__all__ = ["eligible", "stencil_solve"]

_CORES = {
    "cg": cg_core,
    "bicg_symmetric": bicg_symmetric_core,
    "cgs": cgs_core,
    "bicgstab": bicgstab_core,
}


def eligible(a, preconditioner=None) -> bool:
    """Take the grid path?  A GridStencilMatrix with a preconditioner the
    grid layout represents: none, Jacobi (its inverse diagonal reshapes), or
    a Chebyshev polynomial of ``a`` itself (its apply is stencil passes)."""
    if not isinstance(a, GridStencilMatrix):
        return False
    pre = preconditioner
    if pre is None or isinstance(pre, JacobiPreconditioner):
        return True
    return isinstance(pre, ChebyshevPreconditioner) and pre.a is a


def stencil_solve(core_name: str, a: GridStencilMatrix, b: torch.Tensor, x0: torch.Tensor, eps,
                  maxiter: int, record: bool, preconditioner=None) -> SolveResult:
    """Run the solve with every carry in the grid layout, with a
    preconditioner :func:`eligible` admits."""
    if core_name not in _CORES:
        raise ValueError(f"no grid-resident solve for {core_name!r}")
    if not eligible(a, preconditioner):
        raise ValueError("the preconditioner has no grid-layout form: solve through the "
                         "generic path")
    if a.dtype != b.dtype:
        a = a.astype(b.dtype)  # b carries the harmonized solve dtype

    def matvec(v):
        with span("spmv"):
            return a.apply_grid(v)

    def dotfn(u, v):
        return torch.sum(u * v)

    if isinstance(preconditioner, JacobiPreconditioner):
        invg = a.to_grid(preconditioner.inv_diag.to(b.dtype))
        apply_ = lambda r: r * invg  # noqa: E731
    elif isinstance(preconditioner, ChebyshevPreconditioner):
        apply_ = cheby_apply_fn(matvec, preconditioner.lmin, preconditioner.lmax,
                                preconditioner.degree)
    else:
        apply_ = None
    apply_ = spanned("precond_apply", apply_)

    bg, x0g = a.to_grid(b), a.to_grid(x0)
    if core_name == "bicgstab":
        res = bicgstab_core(matvec, apply_ or (lambda v: v), dotfn, bg, x0g, eps, maxiter,
                            record)
    elif apply_ is not None:
        if core_name != "cg":
            raise ValueError(f"{core_name} does not take a preconditioner")
        res = pcg_core(matvec, apply_, dotfn, bg, x0g, eps, maxiter, record)
    else:
        res = _CORES[core_name](matvec, dotfn, bg, x0g, eps, maxiter, record)
    return dataclasses.replace(res, x=a.from_grid(res.x))
