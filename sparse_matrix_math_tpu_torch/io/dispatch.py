"""Loader dispatch by file extension.

Port of ``sparse_matrix_math_tpu/io/dispatch.py`` (reference ``loadMatrix``
overloads, include/sparse_matrix_math.h:2648-2669): ``.mtx`` is Matrix
Market, ``.smmdt`` the dense-text format, any other extension raises
FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT.  :func:`load_matrix` returns the host
:class:`TripletMatrix`; :func:`load_matrix_csr` a :class:`CSRMatrix` and
:func:`load_matrix_df` a double-word operator, each on the device the caller
names.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from ..formats.csr import CSRMatrix, csr_from_coo, csr_from_triplet
from ..formats.triplet import TripletMatrix
from ..ops.df32 import df_operator_from_host_csr
from .matrix_market import (
    MatrixLoadStatus,
    MatrixMarketError,
    load_matrix_market,
    load_matrix_market_coo,
)
from .smmdt import load_smmdt

__all__ = ["load_matrix", "load_matrix_csr", "load_matrix_df"]


def _extension(path) -> str:
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in (".mtx", ".smmdt"):
        raise MatrixMarketError(
            MatrixLoadStatus.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT,
            f"unknown matrix file extension: {ext!r} (expected .mtx or .smmdt)",
        )
    return ext


def load_matrix(path: Union[str, os.PathLike], *, dtype=torch.float64,
                allow_general: bool = False) -> TripletMatrix:
    """Load a matrix file into a :class:`TripletMatrix`, by extension
    (h:2650-2657)."""
    if _extension(path) == ".mtx":
        return load_matrix_market(path, dtype=dtype, allow_general=allow_general)
    return load_smmdt(path, dtype=dtype)


def load_matrix_csr(path: Union[str, os.PathLike], *, dtype=torch.float64,
                    allow_general: bool = False, device) -> CSRMatrix:
    """Load a matrix file straight to a :class:`CSRMatrix` on ``device``
    (h:2661-2669).  ``.mtx`` takes the bulk path (native parser when its
    library loads, then sorted, duplicate-summed COO), skipping the
    per-entry container."""
    if _extension(path) == ".mtx":
        return csr_from_coo(load_matrix_market_coo(
            path, dtype=dtype, allow_general=allow_general, device=device
        ))
    return csr_from_triplet(load_smmdt(path, dtype=dtype), device=device)


def load_matrix_df(path: Union[str, os.PathLike], *, allow_general: bool = False, device):
    """Load a matrix file into a double-word operator on ``device``: a
    ``DfDiaMatrix`` for stencil patterns, a ``DfEllMatrix`` otherwise.  The
    values are parsed in float64 on the host and split exactly into (hi, lo)
    float32 planes (ops/df32.py), so the operator carries the full float64
    data; pair it with ``cg_df64`` or ``cg_ir_df64``."""
    if _extension(path) == ".mtx":
        coo = load_matrix_market_coo(path, dtype=torch.float64, allow_general=allow_general,
                                     device="cpu")
        rows, cols, vals, shape = coo.rows.numpy(), coo.cols.numpy(), coo.vals.numpy(), coo.shape
    else:
        rows, cols, vals, shape = load_smmdt(path, dtype=torch.float64).to_host_coo()
    n_rows = shape[0]
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return df_operator_from_host_csr(vals, cols, indptr, shape, device=device)
