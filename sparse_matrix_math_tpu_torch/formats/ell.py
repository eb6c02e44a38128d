"""ELLPACK: every row padded to the same slot count K.

Port of ``sparse_matrix_math_tpu/formats/ell.py``.  ``vals`` and ``cols``
are ``(rows_padded, K)``, as the JAX format stores them: K is the longest
row, rows are padded to a multiple of 8, and padding slots hold value 0 and
column 0, so ``sum_k vals[:, k] * x[cols[:, k]]`` needs no mask.  The
product is kernel K6 (``ops/ell_spmv.py``), which reads ``sell``: the
slab-sorted SELL-32 layout of the live slots (``formats/sell.py``), derived
from the planes when the matrix is made.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRMatrix
from .sell import SellMatrix, sell_from_ell

__all__ = ["ELLMatrix", "ell_from_csr"]

_ROW_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Padded row-major sparse matrix, derived from a CSR matrix."""

    vals: torch.Tensor  # (rows_padded, K)
    cols: torch.Tensor  # (rows_padded, K) int32
    shape: Tuple[int, int]
    nnz: int
    # K6's layout; derived here when not given, each row's live slots ending
    # before its trailing slots of value 0 and column 0
    sell: Optional[SellMatrix] = None

    def __post_init__(self):
        if self.sell is None:
            object.__setattr__(self, "sell", sell_from_ell(self.vals, self.cols, self.shape,
                                                           self.nnz))

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def rows_padded(self) -> int:
        return int(self.vals.shape[0])

    @property
    def slots(self) -> int:
        return int(self.vals.shape[1])

    @property
    def fill_ratio(self) -> float:
        """nnz / padded slots: the storage efficiency of the padding."""
        total = self.vals.shape[0] * self.vals.shape[1]
        return self.nnz / total if total else 1.0

    def astype(self, dtype: torch.dtype) -> "ELLMatrix":
        return dataclasses.replace(self, vals=self.vals.to(dtype), sell=self.sell.astype(dtype))

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        rows = torch.arange(self.rows_padded, device=self.device)[:, None].expand_as(self.cols)
        out = torch.zeros((self.rows_padded, self.shape[1]), dtype=self.dtype,
                          device=self.device)
        out.index_put_((rows.reshape(-1), self.cols.reshape(-1).long()), self.vals.reshape(-1),
                       accumulate=True)
        return out[:self.shape[0]]


def ell_from_csr(csr: CSRMatrix, *, row_align: int = _ROW_ALIGN) -> ELLMatrix:
    """Pad a CSR matrix into ELL slots on the CSR's device (the layout is
    built on the host from one read of the CSR's arrays)."""
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    indices = csr.indices.cpu().numpy().astype(np.int64)
    data = csr.data.cpu().numpy()
    n_rows, n_cols = csr.shape
    row_nnz = np.diff(indptr)
    k = max(int(row_nnz.max()) if n_rows and row_nnz.size else 0, 1)
    rows_padded = max(-(-n_rows // row_align) * row_align, row_align)
    vals = np.zeros((rows_padded, k), dtype=data.dtype)
    cols = np.zeros((rows_padded, k), dtype=np.int32)
    slot = np.arange(len(indices)) - np.repeat(indptr[:-1], row_nnz)
    row_of = np.repeat(np.arange(n_rows), row_nnz)
    vals[row_of, slot] = data
    cols[row_of, slot] = indices
    vals, cols = torch.from_numpy(vals).to(csr.device), torch.from_numpy(cols).to(csr.device)
    shape = (int(n_rows), int(n_cols))
    sell = sell_from_ell(vals, cols, shape, csr.nnz,
                         row_nnz=torch.from_numpy(row_nnz).to(csr.device))
    return ELLMatrix(vals=vals, cols=cols, shape=shape, nnz=csr.nnz, sell=sell)
