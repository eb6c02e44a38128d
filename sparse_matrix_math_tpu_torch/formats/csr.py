"""CSR (compressed sparse row) matrix on a torch device.

Port of ``sparse_matrix_math_tpu/formats/csr.py:33-300``.  The reference's
three arrays (``values``, ``positions``, ``start``;
include/sparse_matrix_math.h:1243-1255) are ``data``, ``indices`` and
``indptr`` here, plus ``row_ids``, the row of every stored value, so the
product is one gather and one ``index_add_`` with no ragged loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .triplet import COOArrays

__all__ = ["CSRMatrix", "csr_from_coo"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Immutable CSR matrix; every tensor lives on one device.

    * ``data``    — (nnz,) stored values
    * ``indices`` — (nnz,) int64 column indices, ascending within a row
    * ``indptr``  — (rows+1,) int64 row pointers
    * ``row_ids`` — (nnz,) int64 row of each stored value
    """

    data: torch.Tensor
    indices: torch.Tensor
    indptr: torch.Tensor
    row_ids: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x (reference rMult, h:1501-1505)."""
        from ..ops import spmv

        return spmv.rmult(self, x)

    def rmult_add(self, lhs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = lhs + A @ x (reference rMultAdd, h:1507-1510)."""
        from ..ops import spmv

        return spmv.rmult_add(self, lhs, x)

    def rmult_sub(self, lhs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = lhs - A @ x (reference rMultSub, h:1512-1515)."""
        from ..ops import spmv

        return spmv.rmult_sub(self, lhs, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        """Dense scatter (reference toLinearDenseRowMajor, h:1995-2008)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row_ids, self.indices), self.data, accumulate=True)


def _csr_from_sorted(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                     shape: Tuple[int, int]) -> CSRMatrix:
    """Assemble CSR from row-major-sorted COO tensors (a counting sort on
    the tensors' device; the reference's ``fillArrays``, h:1606-1641)."""
    n_rows = int(shape[0])
    counts = torch.bincount(rows, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    return CSRMatrix(data=vals, indices=cols.to(torch.int64), indptr=indptr,
                     row_ids=rows.to(torch.int64), shape=(n_rows, int(shape[1])))


def csr_from_coo(coo: COOArrays, *, needs_sort: bool = False) -> CSRMatrix:
    """CSR from COO tensors, on their device (reference CSRMatrix::init,
    h:1327-1349).  :func:`coo_from_arrays` output is already row-major
    sorted; pass ``needs_sort=True`` for raw arrays."""
    rows, cols, vals = coo.rows, coo.cols, coo.vals
    if needs_sort and rows.numel():
        key = rows.to(torch.int64) * coo.shape[1] + cols
        order = torch.argsort(key, stable=True)
        rows, cols, vals = rows[order], cols[order], vals[order]
    return _csr_from_sorted(rows, cols, vals, coo.shape)
