"""Plain whole-system references for the distributed padded DIA tests, from a CSR.

Imports torch alone: nothing of the port, so a fault in its layouts or
kernels cannot hide in the reference.  The truncated SGS apply is written
in the kernels' order: each row sums its strict entries in ascending column
order (the ascending-offset order of the DIA kernels, which add zeros for
the diagonals a boundary row lacks; adding a zero leaves a sum's value as
it is) and multiplies by ``1 / d``, so it equals the port's apply value for
value, with only the sign of a zero free.
"""

import torch


def _strict(indptr, indices, data, lower: bool):
    """The strict lower (or upper) entries as ``(n, k)`` coefficients and
    columns, each row's in ascending column order, padded with zero
    coefficients on column 0."""
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n), torch.diff(indptr))
    keep = indices < rows if lower else indices > rows
    rows, cols, vals = rows[keep], indices[keep], data[keep]
    counts = torch.bincount(rows, minlength=n)
    starts = torch.zeros(n, dtype=torch.int64)
    starts[1:] = torch.cumsum(counts, 0)[:-1]
    slot = torch.arange(rows.shape[0]) - starts[rows]
    width = max(int(counts.max()), 1) if n else 1
    coef = torch.zeros((n, width), dtype=data.dtype)
    col = torch.zeros((n, width), dtype=torch.int64)
    coef[rows, slot] = vals
    col[rows, slot] = cols
    return coef, col


def _diagonal(indptr, indices, data):
    n = indptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n), torch.diff(indptr))
    d = torch.zeros(n, dtype=data.dtype)
    on = indices == rows
    d[rows[on]] = data[on]
    return d


def _sweeps(coef, col, inv, rhs, sweeps: int):
    x = rhs * inv
    for _ in range(sweeps - 1):
        acc = coef[:, 0] * x[col[:, 0]]
        for j in range(1, coef.shape[1]):
            acc = acc + coef[:, j] * x[col[:, j]]
        x = (rhs - acc) * inv
    return x


def sgs_apply(indptr, indices, data, r, sweeps: int):
    """``z = M^{-1} r`` of the truncated SGS: ``x = r / d``, then ``sweeps -
    1`` times ``x = (r - L x) / d``; ``D x``; the same with ``U``."""
    d = _diagonal(indptr, indices, data)
    inv = 1.0 / d
    y = _sweeps(*_strict(indptr, indices, data, True), inv, r, sweeps)
    return _sweeps(*_strict(indptr, indices, data, False), inv, d * y, sweeps)

