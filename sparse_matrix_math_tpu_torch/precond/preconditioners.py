"""Preconditioners of the DIA solve path: Identity and Jacobi.

Port of ``sparse_matrix_math_tpu/precond/preconditioners.py:75-100``.  Each
has ``apply(rhs) -> z`` solving ``M z = rhs``.  SGS, ILU(0) and IC(0) are
not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..formats.csr import CSRMatrix

__all__ = ["IdentityPreconditioner", "JacobiPreconditioner", "FactorizationError"]


class FactorizationError(ValueError):
    """Raised when a preconditioner cannot be built from the matrix (here:
    Jacobi on a zero diagonal entry)."""


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """No-op preconditioner (reference IDPreconditioner, h:1165-1170)."""

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        return rhs


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M = D: one elementwise multiply per apply."""

    inv_diag: torch.Tensor

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        d = self.inv_diag[:, None] if rhs.ndim == 2 else self.inv_diag
        return rhs * d

    @classmethod
    def from_matrix(cls, a: CSRMatrix) -> "JacobiPreconditioner":
        """Inverse diagonal of a square CSR matrix, on its device; a zero or
        missing diagonal entry raises :class:`FactorizationError`."""
        on_diag = a.indices == a.row_ids
        diag = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
        diag[a.row_ids[on_diag]] = a.data[on_diag]
        if bool((diag == 0).any()):
            raise FactorizationError("matrix has zero diagonal entries")
        return cls(inv_diag=1.0 / diag)
