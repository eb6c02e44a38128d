"""Host-side incomplete factorizations: IC(0) and ILU(0).

Port of ``sparse_matrix_math_tpu/precond/_factorize.py:24-245``.  A
factorization is sequential and driven by the pattern, so it runs on the
host in NumPy arrays; the apply is what runs on the device every iteration.
The native C++ path (:mod:`..native`) goes first; the Python loops are its
fallback and the tests' oracle.  Both raise :class:`FactorizationError`
where the reference fails silently: IC(0) on a non-SPD matrix raises instead
of returning NaN (reference h:1879), and a missing diagonal raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["FactorizationError", "ic0_factorize_host", "ilu0_factorize_host",
           "split_triangular"]


class FactorizationError(ValueError):
    """Raised when a preconditioner cannot be built from the matrix: an
    incomplete factorization that does not exist (IC(0) on a non-SPD
    matrix, a zero pivot), a missing or too small diagonal entry."""


def split_triangular(data: np.ndarray, indices: np.ndarray, indptr: np.ndarray
                     ) -> Tuple[np.ndarray, ...]:
    """Split square CSR arrays into (diag, strict-lower COO, strict-upper
    COO), each COO as (data, cols, rows)."""
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag = np.zeros(n, dtype=data.dtype)
    on_d = indices == row_ids
    diag[row_ids[on_d]] = data[on_d]
    lo = indices < row_ids
    up = indices > row_ids
    return (
        diag,
        (data[lo], indices[lo], row_ids[lo]),
        (data[up], indices[up], row_ids[up]),
    )


def _lower_pattern(data, indices, indptr, n):
    """A's lower pattern (ascending columns, the diagonal last) and values."""
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    low = indices <= row_ids
    l_idx, l_val, l_row = indices[low], data[low], row_ids[low]
    counts = np.bincount(l_row, minlength=n)
    l_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=l_ptr[1:])
    # CSR columns ascend, so each row's last lower entry must be its diagonal
    bad = counts == 0
    bad[~bad] = l_idx[l_ptr[1:][~bad] - 1] != np.arange(n)[~bad]
    if bad.any():
        raise FactorizationError(
            f"row {int(np.argmax(bad))} has no diagonal entry; matrix is not SPD"
        )
    return l_val, l_idx, l_ptr


def ic0_factorize_host(data: np.ndarray, indices: np.ndarray, indptr: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Incomplete Cholesky with zero fill, A ~= L L^T on A's lower pattern.
    Returns the lower-triangular CSR arrays (values, indices, indptr), the
    diagonal included.  Raises :class:`FactorizationError` on a non-SPD
    matrix or a missing diagonal."""
    from .. import native

    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    l_val, l_idx, l_ptr = _lower_pattern(data, indices, indptr, n)
    try:
        l_values = native.ic0_factorize(l_ptr, l_idx, l_val)
    except ValueError as e:
        raise FactorizationError(str(e)) from e
    if l_values is None:
        return _ic0_python(data, indices, indptr)
    return l_values, l_idx, l_ptr


def _ic0_python(data, indices, indptr):
    """The up-looking row algorithm in Python (reference h:1856-1920:
    ``l_ii = sqrt(a_ii - sum l_ik^2)``, ``l_ji = (a_ji - sum l_ik l_jk) / l_ii``)."""
    n = indptr.shape[0] - 1
    l_rows: list[dict[int, float]] = []
    l_cols_sorted: list[list[int]] = []
    for i in range(n):
        a_row = {
            int(c): float(v)
            for c, v in zip(indices[indptr[i]:indptr[i + 1]], data[indptr[i]:indptr[i + 1]])
            if c <= i
        }
        if i not in a_row:
            raise FactorizationError(f"row {i} has no diagonal entry; matrix is not SPD")
        li: dict[int, float] = {}
        cols = sorted(c for c in a_row if c < i)
        for k in cols:
            lk = l_rows[k]
            # sum over the shared columns j < k
            s = 0.0
            if len(li) <= len(lk):
                for j, v in li.items():
                    if j < k and j in lk:
                        s += v * lk[j]
            else:
                for j, v in lk.items():
                    if j < k and j in li:
                        s += v * li[j]
            li[k] = (a_row[k] - s) / lk[k]
        d = a_row[i] - sum(v * v for v in li.values())
        if d <= 0.0:
            raise FactorizationError(
                f"non-positive pivot {d:.3e} at row {i}; matrix is not SPD"
            )
        li[i] = float(np.sqrt(d))
        l_rows.append(li)
        l_cols_sorted.append(cols + [i])
    return _rows_to_csr(l_rows, l_cols_sorted, n, data.dtype)


def ilu0_factorize_host(data: np.ndarray, indices: np.ndarray, indptr: np.ndarray,
                        pivot_tol: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """ILU(0), incomplete LU with zero fill on A's pattern (IKJ form, Saad
    §10.3.2).  Returns the factor values aligned with A's pattern (strict
    lower entries hold L, unit diagonal implicit; the diagonal and strict
    upper entries hold U) and U's diagonal.  A pivot with
    ``|pivot| <= pivot_tol`` or a missing diagonal raises
    :class:`FactorizationError`."""
    from .. import native

    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_pos = np.full(n, -1, dtype=np.int64)
    on_diag = np.nonzero(indices == row_ids)[0]
    diag_pos[row_ids[on_diag]] = on_diag
    if np.any(diag_pos < 0):
        missing = int(np.nonzero(diag_pos < 0)[0][0])
        raise FactorizationError(
            f"row {missing} has no diagonal entry; ILU(0) requires a full diagonal"
        )
    try:
        factor = native.ilu0_factorize(indptr, indices, diag_pos, data, float(pivot_tol))
    except ValueError as e:
        raise FactorizationError(str(e)) from e
    if factor is None:
        factor = _ilu0_python(data, indices, indptr, diag_pos, pivot_tol)
    return factor, factor[diag_pos]


def _ilu0_python(data, indices, indptr, diag_pos, pivot_tol):
    """The IKJ elimination in Python."""
    n = indptr.shape[0] - 1
    factor = data.copy()
    col_pos = {}  # column -> position, for the active row
    for i in range(1, n):
        row_lo, row_hi = indptr[i], indptr[i + 1]
        col_pos.clear()
        for p in range(row_lo, row_hi):
            col_pos[int(indices[p])] = p
        for p in range(row_lo, row_hi):
            k = int(indices[p])
            if k >= i:
                break
            pivot = factor[diag_pos[k]]
            if abs(pivot) <= pivot_tol:
                raise FactorizationError(f"zero pivot at row {k} during ILU(0)")
            alpha = factor[p] / pivot
            factor[p] = alpha
            # subtract alpha * U(k, j) for j > k within the pattern
            for q in range(diag_pos[k] + 1, indptr[k + 1]):
                pj = col_pos.get(int(indices[q]))
                if pj is not None:
                    factor[pj] -= alpha * factor[q]
        if abs(factor[diag_pos[i]]) <= pivot_tol:
            raise FactorizationError(f"zero pivot at row {i} during ILU(0)")
    return factor


def _rows_to_csr(rows_dicts, cols_sorted, n, dtype):
    counts = np.fromiter((len(c) for c in cols_sorted), dtype=np.int64, count=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    out_idx = np.fromiter((c for cols in cols_sorted for c in cols), dtype=np.int64,
                          count=int(indptr[-1]))
    out_val = np.fromiter((rows_dicts[i][c] for i in range(n) for c in cols_sorted[i]),
                          dtype=dtype, count=int(indptr[-1]))
    return out_val, out_idx, indptr
