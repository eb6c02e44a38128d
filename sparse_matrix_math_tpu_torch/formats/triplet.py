"""COO (coordinate) arrays for bulk CSR assembly.

Port of ``sparse_matrix_math_tpu/formats/triplet.py:33-130``: the three flat
arrays ``(rows, cols, vals)``, sorted row-major with duplicates summed, as
the reference's ``std::map``-ordered triplet container gives them
(include/sparse_matrix_math.h:607-618, 1635).  Sorting and deduplication run
on the host in NumPy; the result lives on the device the caller names.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["COOArrays", "coo_from_arrays"]


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
