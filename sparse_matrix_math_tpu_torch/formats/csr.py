"""CSR (compressed sparse row) matrix on a torch device.

Port of ``sparse_matrix_math_tpu/formats/csr.py``.  The reference's
three arrays (``values``, ``positions``, ``start``;
include/sparse_matrix_math.h:1243-1255) are ``data``, ``indices`` and
``indptr`` here, plus ``row_ids``, the row of every stored value.  The
product is one gather and one sum by row over ``indptr`` in the entries'
order (ops/spmv.py:row_sum), with no ragged loop.  The
reference's mutating element and matrix operations (``updateEntry``,
``addEntry``, ``zeroValues``, ``operator*=``, ``inplaceAdd/Subtract``,
h:1525-1604) return a new matrix sharing the index tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple, Union

import numpy as np
import torch

from .triplet import COOArrays, TripletMatrix, torch_dtype

__all__ = ["CSRMatrix", "csr_from_coo", "csr_from_triplet", "csr_from_dense"]


@dataclasses.dataclass(frozen=True)
class CSRMatrix:
    """Immutable CSR matrix; every tensor lives on one device.

    * ``data``    — (nnz,) stored values
    * ``indices`` — (nnz,) int64 column indices, ascending within a row
    * ``indptr``  — (rows+1,) int64 row pointers: 0 first, non-decreasing,
      nnz last (the product sums by it unchecked; the constructors here make
      it so, and ``interop.csr_from_numpy`` checks a caller's)
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

    @property
    def dense_row_count(self) -> int:
        return self.shape[0]

    @property
    def dense_col_count(self) -> int:
        return self.shape[1]

    # -- element access (reference h:1551-1604) -------------------------------
    def get_value_index(self, row: int, col: int) -> int:
        """Index into ``data`` of (row, col), or -1 when it is not stored: a
        binary search of the row's ascending columns (``getValueIndex``,
        h:1551-1570)."""
        start, end = (int(v) for v in self.indptr[int(row):int(row) + 2].tolist())
        seg = self.indices[start:end]
        pos = int(torch.searchsorted(seg, torch.tensor([int(col)], dtype=seg.dtype,
                                                       device=seg.device)))
        return start + pos if pos < end - start and int(seg[pos]) == int(col) else -1

    def get_value(self, row: int, col: int) -> torch.Tensor:
        """Value at (row, col) as a 0-d tensor; 0 when not stored (h:1582-1589)."""
        idx = self.get_value_index(row, col)
        if idx < 0:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        return self.data[idx]

    def _with_entry(self, row: int, col: int, value, accumulate: bool) -> "CSRMatrix":
        idx = self.get_value_index(row, col)
        data = self.data.clone()
        if idx >= 0:
            data[idx] = data[idx] + value if accumulate else value
        return dataclasses.replace(self, data=data)

    def update_entry(self, row: int, col: int, value) -> "CSRMatrix":
        """Overwrite a stored entry; a copy unchanged when absent (h:1572-1580)."""
        return self._with_entry(row, col, value, accumulate=False)

    def add_entry(self, row: int, col: int, value) -> "CSRMatrix":
        """Accumulate into a stored entry; a copy unchanged when the position
        is absent (``addEntry``, h:1596-1604: CSR cannot change its pattern)."""
        return self._with_entry(row, col, value, accumulate=True)

    def zero_values(self) -> "CSRMatrix":
        """Every stored value 0, the pattern kept (h:1591-1594)."""
        return dataclasses.replace(self, data=torch.zeros_like(self.data))

    def with_data(self, data: torch.Tensor) -> "CSRMatrix":
        """The same pattern with new values."""
        if data.shape != self.data.shape:
            raise ValueError("data must match nnz")
        return dataclasses.replace(self, data=data)

    # -- matrix-level ops (reference h:1525-1549) ------------------------------
    def scale(self, scalar) -> "CSRMatrix":
        """Scalar multiply (``operator*=``, h:1525-1531)."""
        return dataclasses.replace(self, data=self.data * scalar)

    def __mul__(self, scalar) -> "CSRMatrix":
        return self.scale(scalar)

    __rmul__ = __mul__

    def has_same_nonzero_pattern(self, other: "CSRMatrix") -> bool:
        """Pattern equality (the reference's memcmp check, h:1366-1385)."""
        if self.shape != other.shape or self.nnz != other.nnz:
            return False
        return bool(torch.equal(self.indices, other.indices.to(self.indices.device))
                    and torch.equal(self.indptr, other.indptr.to(self.indptr.device)))

    def add(self, other: "CSRMatrix") -> "CSRMatrix":
        """Element-wise sum; the patterns must be identical (``inplaceAdd``,
        h:1533-1540)."""
        self._require_same_pattern(other)
        return dataclasses.replace(self, data=self.data + other.data)

    def subtract(self, other: "CSRMatrix") -> "CSRMatrix":
        """Element-wise difference; the patterns must be identical
        (``inplaceSubtract``, h:1542-1549)."""
        self._require_same_pattern(other)
        return dataclasses.replace(self, data=self.data - other.data)

    def _require_same_pattern(self, other: "CSRMatrix") -> None:
        if not self.has_same_nonzero_pattern(other):
            raise ValueError("matrices must share an identical non-zero pattern")

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

    def get_preconditioner(self, kind="none", **kwargs):
        """Member-function preconditioner factory (``CSRMatrix::
        getPreconditioner``, h:1643-1651, which builds NONE/SGS only; this
        one every kind of :func:`get_preconditioner`)."""
        from ..precond.preconditioners import get_preconditioner

        return get_preconditioner(self, kind, **kwargs)

    # -- iteration (host-side; reference CSRIterator h:879-1000) ---------------
    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """(row, col, value) over the stored entries; empty rows are skipped
        (h:920-931)."""
        rows, cols, vals = (t.tolist() for t in (self.row_ids, self.indices, self.data))
        yield from zip(rows, cols, vals)

    def iter_row(self, row: int) -> Iterator[Tuple[int, int, float]]:
        """One row's entries (``CSRRowIterator``, h:946-1000)."""
        start, end = (int(v) for v in self.indptr[int(row):int(row) + 2].tolist())
        for c, v in zip(self.indices[start:end].tolist(), self.data[start:end].tolist()):
            yield int(row), c, v

    def row_nnz(self, row: int) -> int:
        return int(self.indptr[int(row) + 1] - self.indptr[int(row)])

    # -- conversions -----------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Dense scatter (reference toLinearDenseRowMajor, h:1995-2008)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row_ids, self.indices), self.data, accumulate=True)

    def to_coo(self) -> COOArrays:
        return COOArrays(rows=self.row_ids, cols=self.indices, vals=self.data, shape=self.shape)

    def transpose(self) -> "CSRMatrix":
        """A^T as a new CSR on the same device."""
        return csr_from_coo(COOArrays(rows=self.indices, cols=self.row_ids, vals=self.data,
                                      shape=(self.shape[1], self.shape[0])), needs_sort=True)

    def astype(self, dtype) -> "CSRMatrix":
        return dataclasses.replace(self, data=self.data.to(torch_dtype(dtype)))


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


def csr_from_triplet(triplet: Union[TripletMatrix, COOArrays], dtype=None, *,
                     device=None) -> CSRMatrix:
    """CSR from an assembly container (the reference's init-from-triplet
    path, SURVEY §3.1): a :class:`TripletMatrix` is laid out on ``device``,
    :class:`COOArrays` stay on theirs."""
    if isinstance(triplet, TripletMatrix):
        if device is None:
            raise TypeError("csr_from_triplet needs device= for a TripletMatrix")
        coo = triplet.to_coo(dtype, device=device)
    else:
        coo = triplet
        if dtype is not None:
            coo = dataclasses.replace(coo, vals=coo.vals.to(torch_dtype(dtype)))
    return csr_from_coo(coo)


def csr_from_dense(dense, dtype=None, tol: float = 0.0, *, device=None) -> CSRMatrix:
    """CSR from a dense array or tensor, dropping entries with |v| <= tol,
    on ``device`` (default: a tensor's own; an array needs one)."""
    if not isinstance(dense, torch.Tensor):
        if device is None:
            raise TypeError("csr_from_dense needs device= for a host array")
        dense = torch.as_tensor(np.asarray(dense))
    dense = dense.to(device if device is not None else dense.device)
    if dense.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    if dtype is not None:
        dense = dense.to(torch_dtype(dtype))
    rows, cols = torch.nonzero(dense.abs() > tol, as_tuple=True)
    return _csr_from_sorted(rows, cols, dense[rows, cols], tuple(dense.shape))
