"""DIA (diagonal) format for stencil matrices.

Port of ``sparse_matrix_math_tpu/formats/dia.py:31-113``.  All nonzeros lie
on a few diagonals, stored one row of ``diags`` each, so the product is a
few shifted elementwise products with no gather:

    y[i] = sum_d diags[d, i] * x[i + offsets[d]]

The conversion runs on the CSR's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .csr import CSRMatrix

__all__ = ["DIAMatrix", "dia_from_csr", "try_dia_from_csr"]


@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """``diags[d, i]`` is the entry at ``(i, i + offsets[d])``; slots that
    fall outside the matrix hold 0.  ``offsets`` ascend."""

    diags: torch.Tensor  # (ndiags, rows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.diags.dtype

    @property
    def device(self) -> torch.device:
        return self.diags.device

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def astype(self, dtype: torch.dtype) -> "DIAMatrix":
        return dataclasses.replace(self, diags=self.diags.to(dtype))

    def to_dense(self) -> torch.Tensor:
        n_rows, n_cols = self.shape
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        rows = torch.arange(n_rows, device=self.device)
        for d, off in enumerate(self.offsets):
            valid = (rows + off >= 0) & (rows + off < n_cols)
            out[rows[valid], rows[valid] + off] += self.diags[d][valid]
        return out


def _diagonal_offsets(csr: CSRMatrix) -> torch.Tensor:
    return torch.unique(csr.indices - csr.row_ids)  # sorted ascending


def dia_from_csr(csr: CSRMatrix, *, max_diags: int = 64) -> DIAMatrix:
    """Convert CSR to DIA.  Raises ValueError when the matrix has more than
    ``max_diags`` distinct diagonals (see :func:`try_dia_from_csr`)."""
    return _dia_from_offsets(csr, _diagonal_offsets(csr), max_diags)


def _dia_from_offsets(csr: CSRMatrix, uniq: torch.Tensor, max_diags: int) -> DIAMatrix:
    if uniq.numel() > max_diags:
        raise ValueError(
            f"matrix has {uniq.numel()} distinct diagonals (> {max_diags}); "
            "DIA layout not suitable"
        )
    n_rows, n_cols = csr.shape
    offs = csr.indices - csr.row_ids
    diags = torch.zeros((uniq.numel(), n_rows), dtype=csr.dtype, device=csr.device)
    diags[torch.searchsorted(uniq, offs), csr.row_ids] = csr.data
    return DIAMatrix(diags=diags, offsets=tuple(int(o) for o in uniq.tolist()),
                     shape=(int(n_rows), int(n_cols)), nnz=csr.nnz)


def try_dia_from_csr(csr: CSRMatrix, *, max_diags: int = 64,
                     min_fill: float = 0.25) -> Optional[DIAMatrix]:
    """DIA when profitable (at most ``max_diags`` diagonals, filled to at
    least ``min_fill``), else None."""
    uniq = _diagonal_offsets(csr)
    if uniq.numel() > max_diags:
        return None
    if csr.nnz / max(uniq.numel() * csr.shape[0], 1) < min_fill:
        return None
    return _dia_from_offsets(csr, uniq, max_diags)
