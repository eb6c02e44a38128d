"""Padded-domain solve path for DIA (stencil) matrices.

Port of ``sparse_matrix_math_tpu/solvers/_padded.py:44-206``.  Every solver
vector lives in the :class:`~..ops.dia_spmv.PaddedDIA` layout for the whole
solve: pad once before the loop, unpad once after.  The guard elements hold
exact zeros through the SpMV, axpys and dots, so the dots equal the
unpadded ones.  The matvec is the padded kernel (K2) on a CUDA device and
its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.dia import DIAMatrix
from ..ops.dia_spmv import dia_spmv_padded, pad_dia
from ..precond.preconditioners import JacobiPreconditioner
from .bicgstab import bicgstab_core
from .cg import cg_core, pcg_core
from .types import SolveResult

__all__ = ["eligible", "padded_solve"]


def eligible(a, preconditioner=None) -> bool:
    """Take the padded path?  A DIA matrix, on any device, with no
    preconditioner or with Jacobi (the one that needs no kernel of its own
    in the padded domain)."""
    return isinstance(a, DIAMatrix) and (
        preconditioner is None or isinstance(preconditioner, JacobiPreconditioner)
    )


def padded_solve(core_name: str, a: DIAMatrix, b: torch.Tensor, x0: torch.Tensor, eps,
                 maxiter: int, record: bool, preconditioner=None) -> SolveResult:
    """Run ``cg`` (with or without Jacobi) or ``bicgstab`` in the padded
    layout."""
    if core_name not in ("cg", "bicgstab"):
        raise ValueError(f"no padded solve for {core_name!r}")
    if a.dtype != b.dtype:
        a = a.astype(b.dtype)  # b carries the harmonized solve dtype
    pdia = pad_dia(a)

    def matvec(v):
        return dia_spmv_padded(pdia, v)

    def dotfn(u, v):
        return torch.dot(u, v)

    bp = pdia.to_padded(b)
    x0p = pdia.to_padded(x0)
    apply_ = None
    if isinstance(preconditioner, JacobiPreconditioner):
        invp = pdia.to_padded(preconditioner.inv_diag.to(b.dtype))  # guard zeros stay 0

        def apply_(r):
            return r * invp

    if core_name == "bicgstab":
        res = bicgstab_core(matvec, apply_ or (lambda v: v), dotfn, bp, x0p, eps,
                            maxiter, record)
    elif apply_ is not None:
        res = pcg_core(matvec, apply_, dotfn, bp, x0p, eps, maxiter, record)
    else:
        res = cg_core(matvec, dotfn, bp, x0p, eps, maxiter, record)
    return dataclasses.replace(res, x=pdia.from_padded(res.x).clone())
