"""HYB: the dominant diagonals as DIA, the remainder as CSR.

Port of ``sparse_matrix_math_tpu/formats/hyb.py``.  ``y = dia @ x + rest @ x``:
the diagonal part is kernel K1 (``ops/dia_spmv.py``), the remainder the CSR
gather and sum by row (ops/spmv.py:row_sum).  HYB has no kernel of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRMatrix, _csr_from_sorted
from .dia import DIAMatrix

__all__ = ["HYBMatrix", "hyb_from_csr"]


@dataclasses.dataclass(frozen=True)
class HYBMatrix:
    """Diagonal part plus remainder; either may be absent (None)."""

    dia: Optional[DIAMatrix]
    rest: Optional[CSRMatrix]
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return (self.dia if self.dia is not None else self.rest).dtype

    @property
    def diagonal_fraction(self) -> float:
        """Share of nnz on the DIA side (1.0: perfectly banded)."""
        return (self.dia.nnz / self.nnz) if (self.dia and self.nnz) else 0.0

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        parts = [p.to_dense() for p in (self.dia, self.rest) if p is not None]
        return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def hyb_from_csr(csr: CSRMatrix, *, min_diag_fill: float = 0.5,
                 max_diags: int = 64) -> HYBMatrix:
    """Split ``csr`` into its dominant diagonals and a remainder, on the
    CSR's device.  A diagonal qualifies with at least ``min_diag_fill *
    n_rows`` entries; at most ``max_diags`` qualify, densest first."""
    indices = csr.indices.cpu().numpy().astype(np.int64)
    row_ids = csr.row_ids.cpu().numpy().astype(np.int64)
    data = csr.data.cpu().numpy()
    n_rows, n_cols = csr.shape
    dev = csr.device

    offs = indices - row_ids
    uniq, inverse, counts = np.unique(offs, return_inverse=True, return_counts=True)
    qualified = counts >= max(min_diag_fill * n_rows, 1)
    if qualified.sum() > max_diags:
        keep = np.zeros_like(qualified)
        keep[np.argsort(-counts)[:max_diags]] = True
        qualified &= keep

    on_dia = qualified[inverse]
    dia = None
    if on_dia.any():
        kept = uniq[qualified]
        diags = np.zeros((kept.size, n_rows), dtype=data.dtype)
        diags[np.searchsorted(kept, offs[on_dia]), row_ids[on_dia]] = data[on_dia]
        dia = DIAMatrix(diags=torch.from_numpy(diags).to(dev),
                        offsets=tuple(int(o) for o in kept),
                        shape=(int(n_rows), int(n_cols)), nnz=int(on_dia.sum()))
    rest = None
    if (~on_dia).any():
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        rest = _csr_from_sorted(put(row_ids[~on_dia]), put(indices[~on_dia]),
                                put(data[~on_dia]), (int(n_rows), int(n_cols)))
    if dia is None and rest is None:
        rest = csr  # empty matrix: keep the (empty) CSR so products stay total
    return HYBMatrix(dia=dia, rest=rest, shape=(int(n_rows), int(n_cols)), nnz=csr.nnz)
