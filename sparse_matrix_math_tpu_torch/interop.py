"""Build the port's objects from plain NumPy arrays.

State crosses from the JAX package as ``np.asarray(...)`` of its objects'
fields; these converters rebuild the matching objects on ``device``.  The
port itself never sees a JAX object.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.csr import CSRMatrix
from .formats.dia import DIAMatrix
from .precond.preconditioners import JacobiPreconditioner

__all__ = ["csr_from_numpy", "dia_from_numpy", "jacobi_from_numpy"]


def csr_from_numpy(indptr, indices, data, shape, device) -> CSRMatrix:
    """A :class:`CSRMatrix` from CSR arrays; ``row_ids`` derive from ``indptr``."""
    indptr = torch.tensor(np.asarray(indptr, dtype=np.int64), device=device)
    n_rows = int(shape[0])
    if indptr.shape != (n_rows + 1,):
        raise ValueError(f"indptr has {indptr.shape[0]} entries, expected {n_rows + 1}")
    row_ids = torch.repeat_interleave(
        torch.arange(n_rows, device=device), torch.diff(indptr)
    )
    return CSRMatrix(
        data=torch.tensor(np.asarray(data), device=device),
        indices=torch.tensor(np.asarray(indices, dtype=np.int64), device=device),
        indptr=indptr, row_ids=row_ids, shape=(n_rows, int(shape[1])),
    )


def dia_from_numpy(diags, offsets, shape, nnz, device) -> DIAMatrix:
    """A :class:`DIAMatrix` from its (ndiags, rows) diagonals and offsets."""
    diags = torch.tensor(np.asarray(diags), device=device)
    offsets = tuple(int(o) for o in offsets)
    if diags.ndim != 2 or diags.shape[0] != len(offsets):
        raise ValueError(f"diags of shape {tuple(diags.shape)} for {len(offsets)} offsets")
    return DIAMatrix(diags=diags, offsets=offsets,
                     shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def jacobi_from_numpy(inv_diag, device) -> JacobiPreconditioner:
    """A :class:`JacobiPreconditioner` from its inverse diagonal."""
    return JacobiPreconditioner(inv_diag=torch.tensor(np.asarray(inv_diag), device=device))
