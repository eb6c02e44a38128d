"""Loader dispatch by file extension.

Port of ``sparse_matrix_math_tpu/io/dispatch.py:90-105`` (reference
``loadMatrix`` CSR overload, include/sparse_matrix_math.h:2648-2669) for the
``.mtx`` path.  Any other extension raises
FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT; the ``.smmdt`` dense-text format is not
ported yet.
"""

from __future__ import annotations

import os
from typing import Union

import torch

from ..formats.csr import CSRMatrix, csr_from_coo
from .matrix_market import MatrixLoadStatus, MatrixMarketError, load_matrix_market_coo

__all__ = ["load_matrix_csr"]


def load_matrix_csr(path: Union[str, os.PathLike], *, dtype=torch.float64,
                    allow_general: bool = False, device) -> CSRMatrix:
    """Load a ``.mtx`` file straight to a :class:`CSRMatrix` on ``device``."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext != ".mtx":
        raise MatrixMarketError(
            MatrixLoadStatus.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT,
            f"unknown matrix file extension: {ext!r} (expected .mtx)",
        )
    return csr_from_coo(load_matrix_market_coo(
        path, dtype=dtype, allow_general=allow_general, device=device
    ))
