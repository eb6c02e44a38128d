"""SMMDT dense-text format: save and load.

Port of ``sparse_matrix_math_tpu/io/smmdt.py:31-114`` (the reference's
``saveDenseText``, include/sparse_matrix_math.h:1930-1993, and
``loadSMMDTMatrix``, h:2611-2646): a ``rows cols`` header line, then the
dense matrix as brace-delimited rows, ``{{v,v,...},\\n{...},...}``, each
value with 6 decimals and an empty slot as a bare ``0``.  The loader skips
zeros on ingest (h:2634-2636), so the reloaded triplet holds the nonzeros
only.
"""

from __future__ import annotations

import os
import re
from typing import TextIO, Union

import numpy as np
import torch

from ..formats.triplet import TripletMatrix
from .matrix_market import MatrixLoadStatus, MatrixMarketError

__all__ = ["save_dense_text", "load_smmdt"]


def save_dense_text(path_or_file: Union[str, os.PathLike, TextIO], matrix) -> None:
    """Write a matrix (any format with ``to_dense``, or a dense array or
    tensor) as SMMDT, in the reference writer's grammar (h:1955-1992)."""
    dense = matrix.to_dense(device="cpu") if isinstance(matrix, TripletMatrix) else (
        matrix.to_dense() if hasattr(matrix, "to_dense") else matrix)
    if isinstance(dense, torch.Tensor):
        dense = dense.cpu().numpy()
    dense = np.asarray(dense)
    if dense.ndim != 2:
        raise ValueError("expected a 2-D matrix")
    n_rows, n_cols = dense.shape

    def _write(f: TextIO) -> None:
        f.write(f"{n_rows} {n_cols}\n")
        f.write("{\n")
        for i in range(n_rows):
            row = ",".join(_fmt(v) for v in dense[i])
            sep = "," if i < n_rows - 1 else ""
            f.write("{" + row + "}" + sep + "\n")
        f.write("}")

    if hasattr(path_or_file, "write"):
        _write(path_or_file)
    else:
        with open(path_or_file, "w") as f:
            _write(f)


def _fmt(v) -> str:
    # an explicit zero is a bare "0" (h:1937-1943), any other value
    # std::fixed with setprecision(6) (h:1936)
    if v == 0:
        return "0"
    return f"{float(v):.6f}"


_NUM = re.compile(r"[-+0-9.eE]+")


def load_smmdt(path_or_file: Union[str, os.PathLike, TextIO], *,
               dtype=torch.float64) -> TripletMatrix:
    """Parse SMMDT into a :class:`TripletMatrix`; zeros are skipped on
    ingest as in the reference (h:2634-2636)."""
    if hasattr(path_or_file, "read"):
        text = path_or_file.read()
    else:
        try:
            with open(path_or_file, "r") as f:
                text = f.read()
        except OSError as e:
            raise MatrixMarketError(MatrixLoadStatus.FAILED_TO_OPEN_FILE,
                                    f"cannot open {path_or_file}: {e}") from e

    header, _, body = text.partition("{")
    parts = header.split()
    if len(parts) != 2:
        raise MatrixMarketError(MatrixLoadStatus.PARSE_ERROR, f"bad SMMDT header: {header!r}")
    n_rows, n_cols = int(parts[0]), int(parts[1])
    m = TripletMatrix(n_rows, n_cols, dtype=dtype)

    row_blocks = re.findall(r"\{([^{}]*)\}", body)
    if len(row_blocks) != n_rows:
        raise MatrixMarketError(MatrixLoadStatus.PARSE_ERROR,
                                f"expected {n_rows} rows, found {len(row_blocks)}")
    for i, block in enumerate(row_blocks):
        values = _NUM.findall(block)
        if len(values) != n_cols:
            raise MatrixMarketError(
                MatrixLoadStatus.PARSE_ERROR,
                f"row {i}: expected {n_cols} values, found {len(values)}")
        for j, tok in enumerate(values):
            v = float(tok)
            if v != 0.0:
                m.add_entry(i, j, v)
    return m
