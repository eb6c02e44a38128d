"""Matrix Market loader with the reference's accepted grammar.

Port of ``sparse_matrix_math_tpu/io/matrix_market.py:37-181``
(reference ``loadMatrixMarketMatrix``, include/sparse_matrix_math.h:2524-2609):
``%%MatrixMarket matrix coordinate real|integer symmetric`` (``general`` too
with ``allow_general=True``), ``%`` comment lines, a ``rows cols nnz`` size
line, then 1-based ``row col value`` triplets; symmetric off-diagonal
entries are mirrored.  Failures raise :class:`MatrixMarketError` with the
reference's :class:`MatrixLoadStatus` codes (h:2507-2522).

:func:`load_matrix_market` fills a :class:`TripletMatrix` from a path or a
file object with the Python parser; :func:`load_matrix_market_coo`, the bulk
path of ``load_matrix_csr``, tries the native parser first
(``native.mtx_read``, ``csrc/smm_native.cpp``) and falls back to the Python
one when the library is unavailable, as the JAX package does.
"""

from __future__ import annotations

import enum
import os
from typing import TextIO, Union

import numpy as np
import torch

from ..formats.triplet import COOArrays, TripletMatrix, coo_from_arrays

__all__ = ["MatrixLoadStatus", "MatrixMarketError", "load_matrix_market",
           "load_matrix_market_coo"]


class MatrixLoadStatus(enum.IntEnum):
    """Parity with the reference MatrixLoadStatus (h:2507-2522)."""

    SUCCESS = 0
    FAILED_TO_OPEN_FILE = 1
    FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT = 2
    PARSE_ERROR = 3
    UNSUPPORTED_FORMAT = 4


class MatrixMarketError(IOError):
    def __init__(self, status: MatrixLoadStatus, message: str):
        super().__init__(message)
        self.status = status


def _parse_path(path, allow_general: bool):
    try:
        f = open(path, "r")
    except OSError as e:
        raise MatrixMarketError(
            MatrixLoadStatus.FAILED_TO_OPEN_FILE, f"cannot open {path}: {e}"
        ) from e
    with f:
        return _parse(f, allow_general)


def load_matrix_market(path_or_file: Union[str, os.PathLike, TextIO], *,
                       allow_general: bool = False, dtype=torch.float64) -> TripletMatrix:
    """Parse a Matrix Market file (a path or an open text file) into a
    :class:`TripletMatrix`.  Symmetric off-diagonal entries are mirrored
    (h:2596-2601), so the result holds full storage, as the reference's."""
    if hasattr(path_or_file, "read"):
        rows, cols, vals, shape = _parse(path_or_file, allow_general)
    else:
        rows, cols, vals, shape = _parse_path(path_or_file, allow_general)
    m = TripletMatrix(*shape, dtype=dtype)
    for r, c, v in zip(rows, cols, vals):
        m.add_entry(r, c, v)
    return m


def load_matrix_market_coo(path: Union[str, os.PathLike], *, allow_general: bool = False,
                           dtype=torch.float64, device) -> COOArrays:
    """Parse a Matrix Market file into sorted, duplicate-summed
    :class:`COOArrays` on ``device``: the native parser when its library
    loads, else the Python one.  Duplicates sum in float64 before the cast
    to ``dtype``, as the reference's double-valued triplet map does."""
    from .. import native

    try:
        parsed = native.mtx_read(str(path), allow_general)
    except native.MtxNativeError as e:
        raise MatrixMarketError(MatrixLoadStatus(e.status), str(e)) from e
    if parsed is not None:
        n_rows, n_cols, rows, cols, vals = parsed
        shape = (n_rows, n_cols)
    else:
        rows, cols, vals, shape = _parse_path(path, allow_general)
    coo = coo_from_arrays(rows, cols, vals, shape, device=device, dtype=np.float64)
    return COOArrays(rows=coo.rows, cols=coo.cols, vals=coo.vals.to(dtype), shape=shape)


def _parse(f: TextIO, allow_general: bool):
    banner = f.readline()
    fields = banner.strip().split()
    # banner grammar checks (h:2544-2573)
    if len(fields) != 5 or fields[0] != "%%MatrixMarket":
        raise MatrixMarketError(
            MatrixLoadStatus.PARSE_ERROR, f"bad MatrixMarket banner: {banner!r}"
        )
    _, obj, fmt, field, symmetry = (s.lower() for s in fields)
    if obj != "matrix" or fmt != "coordinate":
        raise MatrixMarketError(
            MatrixLoadStatus.UNSUPPORTED_FORMAT,
            f"only 'matrix coordinate' is supported, got {obj} {fmt}",
        )
    if field not in ("real", "integer"):
        raise MatrixMarketError(
            MatrixLoadStatus.UNSUPPORTED_FORMAT,
            f"only real/integer fields are supported, got {field}",
        )
    symmetric = symmetry == "symmetric"
    if not symmetric and not (allow_general and symmetry == "general"):
        raise MatrixMarketError(
            MatrixLoadStatus.UNSUPPORTED_FORMAT,
            f"symmetry {symmetry!r} not supported "
            "(reference accepts only 'symmetric', h:2566-2573)",
        )

    # skip comments (h:2575-2578)
    line = f.readline()
    while line and line.lstrip().startswith("%"):
        line = f.readline()
    parts = line.split()
    if len(parts) != 3:
        raise MatrixMarketError(MatrixLoadStatus.PARSE_ERROR, f"bad size line: {line!r}")
    try:
        n_rows, n_cols, nnz = (int(p) for p in parts)
    except ValueError as e:
        raise MatrixMarketError(
            MatrixLoadStatus.PARSE_ERROR, f"bad size line: {line!r}"
        ) from e

    rows, cols, vals = [], [], []
    read = 0
    for line in f:
        s = line.strip()
        if not s or s.startswith("%"):
            continue
        parts = s.split()
        if len(parts) != 3:
            raise MatrixMarketError(MatrixLoadStatus.PARSE_ERROR, f"bad entry line: {line!r}")
        try:
            r = int(parts[0]) - 1  # 1-based indices (h:2595-2596)
            c = int(parts[1]) - 1
            v = float(parts[2])
        except ValueError as e:
            raise MatrixMarketError(
                MatrixLoadStatus.PARSE_ERROR, f"bad entry line: {line!r}"
            ) from e
        if not (0 <= r < n_rows and 0 <= c < n_cols):
            raise MatrixMarketError(
                MatrixLoadStatus.PARSE_ERROR,
                f"entry ({r + 1}, {c + 1}) out of bounds for {n_rows}x{n_cols}",
            )
        rows.append(r); cols.append(c); vals.append(v)
        if symmetric and r != c:
            rows.append(c); cols.append(r); vals.append(v)  # mirror (h:2596-2601)
        read += 1
    if read != nnz:
        raise MatrixMarketError(
            MatrixLoadStatus.PARSE_ERROR, f"expected {nnz} entries, found {read}"
        )
    return rows, cols, vals, (n_rows, n_cols)
