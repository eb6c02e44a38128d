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
from .precond.preconditioners import (
    IC0Preconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from .precond.trisolve import TriangularMatrix

__all__ = ["csr_from_numpy", "dia_from_numpy", "jacobi_from_numpy", "triangular_from_numpy",
           "sgs_from_numpy", "ic0_from_numpy", "ilu0_from_numpy"]


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


def triangular_from_numpy(fields, device) -> TriangularMatrix:
    """A :class:`TriangularMatrix` from a mapping of its fields: the arrays
    ``data``, ``indices``, ``row_ids``, ``diag`` and ``dense`` (None when
    absent), and ``n``, ``lower``, ``depth``, ``method``, ``sweeps``."""
    def tensor(name, dtype=None):
        return torch.tensor(np.asarray(fields[name], dtype=dtype), device=device)

    return TriangularMatrix(
        data=tensor("data"), indices=tensor("indices", np.int64),
        row_ids=tensor("row_ids", np.int64), diag=tensor("diag"),
        dense=None if fields.get("dense") is None else tensor("dense"),
        n=int(fields["n"]), lower=bool(fields["lower"]), depth=int(fields["depth"]),
        method=str(fields["method"]), sweeps=int(fields["sweeps"]),
    )


def sgs_from_numpy(fwd_fields, bwd_fields, diag, device) -> SGSPreconditioner:
    """An :class:`SGSPreconditioner` from its two factors' fields and diagonal."""
    return SGSPreconditioner(fwd=triangular_from_numpy(fwd_fields, device),
                             bwd=triangular_from_numpy(bwd_fields, device),
                             diag=torch.tensor(np.asarray(diag), device=device))


def ic0_from_numpy(lower_fields, upper_fields, device) -> IC0Preconditioner:
    """An :class:`IC0Preconditioner` from the fields of L and L^T."""
    return IC0Preconditioner(lower=triangular_from_numpy(lower_fields, device),
                             upper=triangular_from_numpy(upper_fields, device))


def ilu0_from_numpy(lower_fields, upper_fields, shift, device) -> ILU0Preconditioner:
    """An :class:`ILU0Preconditioner` from the fields of L and U and its shift."""
    return ILU0Preconditioner(lower=triangular_from_numpy(lower_fields, device),
                              upper=triangular_from_numpy(upper_fields, device),
                              shift=float(shift))
