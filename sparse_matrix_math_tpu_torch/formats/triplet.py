"""Triplet (COO) assembly: the reference's triplet container and COO arrays
for bulk CSR assembly.

Port of ``sparse_matrix_math_tpu/formats/triplet.py``:

* :class:`TripletMatrix` (JAX :135-264) is the host-side incremental
  assembly container of the reference's ``TripletMatrix``
  (include/sparse_matrix_math.h:487-684): ``add_entry`` accumulates,
  ``update_entry`` writes only where an entry is stored, ``get_value`` is
  0.0 where none is, iteration is row-major (``std::map`` order);
* :class:`COOArrays` (JAX :33-130) are the three flat tensors ``(rows, cols,
  vals)``, sorted row-major with duplicates summed (h:607-618, 1635).
  Sorting and deduplication run on the host in NumPy; the result lives on
  the device the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch

__all__ = ["TripletMatrix", "COOArrays", "coo_from_arrays", "host_coo_arrays"]


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or NumPy dtype, or the name of either
    (``"bfloat16"`` included, which NumPy lacks)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None), torch.dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


@dataclasses.dataclass(frozen=True)
class COOArrays:
    """Device COO matrix: parallel (rows, cols, vals) tensors, row-major
    sorted with duplicates summed."""

    rows: torch.Tensor  # (nnz,) int64
    cols: torch.Tensor  # (nnz,) int64
    vals: torch.Tensor  # (nnz,) float
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def to_dense(self) -> torch.Tensor:
        """Dense row-major scatter on the arrays' device (reference
        toLinearDenseRowMajor, h:1995-2008)."""
        out = torch.zeros(self.shape, dtype=self.vals.dtype, device=self.vals.device)
        return out.index_put_((self.rows, self.cols), self.vals, accumulate=True)

    def scale(self, scalar) -> "COOArrays":
        """Scalar multiply (reference operator*=, h:672-678)."""
        return dataclasses.replace(self, vals=self.vals * scalar)


def host_coo_arrays(rows, cols, vals, shape: Tuple[int, int], *,
                    sum_duplicates: bool = True, dtype=None):
    """Host-side sort and deduplication of flat COO arrays.

    Returns ``(rows, cols, vals, shape)`` as NumPy arrays (int64 indices),
    sorted row-major with duplicates summed.  Raises ValueError on
    mismatched lengths or out-of-range indices.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=dtype)
    if not np.issubdtype(vals.dtype, np.floating):
        vals = vals.astype(np.float64 if dtype is None else dtype)
    if rows.shape != cols.shape or rows.shape != vals.shape:
        raise ValueError("rows/cols/vals must have identical shapes")
    n_rows, n_cols = shape
    if rows.size and (rows.min() < 0 or rows.max() >= n_rows):
        raise ValueError("row index out of range")
    if cols.size and (cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("column index out of range")
    key = rows * np.int64(n_cols) + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    if sum_duplicates and key.size:
        uniq, inverse = np.unique(key, return_inverse=True)
        summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
        np.add.at(summed, inverse, vals)
        key, vals = uniq, summed
    return key // n_cols, key % n_cols, vals, (int(n_rows), int(n_cols))


def coo_from_arrays(rows, cols, vals, shape: Tuple[int, int], *,
                    device, sum_duplicates: bool = True, dtype=None) -> COOArrays:
    """Sorted, duplicate-summed :class:`COOArrays` on ``device`` from flat
    host arrays; duplicates at one (row, col) accumulate."""
    r, c, v, shape = host_coo_arrays(
        rows, cols, vals, shape, sum_duplicates=sum_duplicates, dtype=dtype
    )
    return COOArrays(
        rows=torch.as_tensor(r, device=device),
        cols=torch.as_tensor(c, device=device),
        vals=torch.as_tensor(v, device=device),
        shape=shape,
    )


class TripletMatrix:
    """Host-side incremental assembly container (COO with dict storage), the
    reference's ``TripletMatrix`` (h:487-684).

    * ``add_entry`` accumulates duplicates (h:607-618);
    * ``update_entry`` overwrites only where the entry exists (h:621-632);
    * ``get_value`` returns 0.0 for absent entries (h:635-645);
    * iteration yields entries in row-major order (``std::map`` key order);
    * the row and column counts are metadata: adding entries never resizes.

    Values accumulate as Python floats (float64) and take ``dtype`` (torch
    or NumPy) on export.  :meth:`to_coo` and :meth:`to_dense` make tensors on
    the device the caller names; :meth:`to_host_coo` returns NumPy arrays.
    """

    def __init__(self, rows: int = 0, cols: int = 0, dtype=torch.float64):
        self._shape = (int(rows), int(cols))
        self._entries: dict[tuple[int, int], float] = {}
        self.dtype = dtype

    def init(self, rows: int, cols: int) -> None:
        """Re-initialise the dimensions and clear the entries (h:589-597)."""
        self._shape = (int(rows), int(cols))
        self._entries.clear()

    def deinit(self) -> None:
        """Clear all state (h:599-604)."""
        self._shape = (0, 0)
        self._entries.clear()

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def dense_row_count(self) -> int:
        return self._shape[0]

    @property
    def dense_col_count(self) -> int:
        return self._shape[1]

    @property
    def nnz(self) -> int:
        """Count of stored entries (``getNonZeroCount``)."""
        return len(self._entries)

    def add_entry(self, row: int, col: int, value: float) -> None:
        """Add ``value`` at (row, col); duplicates accumulate (h:607-618)."""
        self._check_index(row, col)
        key = (int(row), int(col))
        self._entries[key] = self._entries.get(key, 0.0) + float(value)

    def update_entry(self, row: int, col: int, value: float) -> bool:
        """Overwrite a stored entry; False when absent (h:621-632)."""
        key = (int(row), int(col))
        if key in self._entries:
            self._entries[key] = float(value)
            return True
        return False

    def get_value(self, row: int, col: int) -> float:
        """Value at (row, col), 0.0 when not stored (h:635-645)."""
        return self._entries.get((int(row), int(col)), 0.0)

    def scale(self, scalar: float) -> None:
        """In-place scalar multiply (``operator*=``, h:672-678)."""
        for key in self._entries:
            self._entries[key] *= scalar

    def __imul__(self, scalar: float) -> "TripletMatrix":
        self.scale(scalar)
        return self

    def __iter__(self) -> Iterator[Tuple[int, int, float]]:
        """Row-major (row, col, value) iteration, the map-order guarantee."""
        for (r, c) in sorted(self._entries):
            yield r, c, self._entries[(r, c)]

    def __len__(self) -> int:
        return len(self._entries)

    def _sorted(self):
        items = sorted(self._entries.items())
        rows = np.fromiter((k[0] for k, _ in items), dtype=np.int64, count=len(items))
        cols = np.fromiter((k[1] for k, _ in items), dtype=np.int64, count=len(items))
        vals = np.fromiter((v for _, v in items), dtype=np.float64, count=len(items))
        return rows, cols, vals

    def _dtype(self, dtype) -> torch.dtype:
        return torch_dtype(self.dtype if dtype is None else dtype)

    def to_host_coo(self, dtype=None):
        """Sorted host ``(rows, cols, vals, shape)`` NumPy arrays: int64
        indices and values in ``dtype`` (default: the container's), never
        on a device (so float64 survives whatever the device holds)."""
        rows, cols, vals = self._sorted()
        return rows, cols, torch.from_numpy(vals).to(self._dtype(dtype)).numpy(), self._shape

    def to_coo(self, dtype=None, *, device) -> COOArrays:
        """Sorted :class:`COOArrays` on ``device``."""
        rows, cols, vals = self._sorted()
        return COOArrays(rows=torch.as_tensor(rows, device=device),
                         cols=torch.as_tensor(cols, device=device),
                         vals=torch.as_tensor(vals, device=device).to(self._dtype(dtype)),
                         shape=self._shape)

    def to_dense(self, dtype=None, *, device) -> torch.Tensor:
        """Dense ``(rows, cols)`` tensor on ``device``."""
        rows, cols, vals = self._sorted()
        out = np.zeros(self._shape, dtype=np.float64)
        out[rows, cols] = vals
        return torch.as_tensor(out, device=device).to(self._dtype(dtype))

    def _check_index(self, row: int, col: int) -> None:
        if not (0 <= int(row) < self._shape[0] and 0 <= int(col) < self._shape[1]):
            raise IndexError(f"entry ({row}, {col}) out of bounds for shape {self._shape}")
