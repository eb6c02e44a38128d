"""Loader dispatch by file extension.

Port of ``sparse_matrix_math_tpu/io/dispatch.py:46-105`` (reference
``loadMatrix`` overloads, include/sparse_matrix_math.h:2648-2669) for the
``.mtx`` path: to CSR, and to a double-word operator.  Any other extension
raises FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT; the ``.smmdt`` dense-text format
is not ported yet.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from ..formats.csr import CSRMatrix, csr_from_coo
from ..ops.df32 import df_operator_from_host_csr
from .matrix_market import MatrixLoadStatus, MatrixMarketError, load_matrix_market_coo

__all__ = ["load_matrix_csr", "load_matrix_df"]


def _check_extension(path) -> None:
    ext = os.path.splitext(str(path))[1].lower()
    if ext != ".mtx":
        raise MatrixMarketError(
            MatrixLoadStatus.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT,
            f"unknown matrix file extension: {ext!r} (expected .mtx)",
        )


def load_matrix_csr(path: Union[str, os.PathLike], *, dtype=torch.float64,
                    allow_general: bool = False, device) -> CSRMatrix:
    """Load a ``.mtx`` file straight to a :class:`CSRMatrix` on ``device``."""
    _check_extension(path)
    return csr_from_coo(load_matrix_market_coo(
        path, dtype=dtype, allow_general=allow_general, device=device
    ))


def load_matrix_df(path: Union[str, os.PathLike], *, allow_general: bool = False, device):
    """Load a ``.mtx`` file into a double-word operator on ``device``: a
    ``DfDiaMatrix`` for stencil patterns, a ``DfEllMatrix`` otherwise.  The
    values are parsed in float64 on the host and split exactly into (hi, lo)
    float32 planes (ops/df32.py), so the operator carries the full float64
    data; pair it with ``cg_df64`` or ``cg_ir_df64``."""
    _check_extension(path)
    coo = load_matrix_market_coo(path, dtype=torch.float64, allow_general=allow_general,
                                 device="cpu")
    n_rows = coo.shape[0]
    rows = coo.rows.numpy()
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    return df_operator_from_host_csr(coo.vals.numpy(), coo.cols.numpy(), indptr, coo.shape,
                                     device=device)
