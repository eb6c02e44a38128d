"""Sparse triangular solves for the preconditioner applies.

Port of ``sparse_matrix_math_tpu/precond/trisolve.py:50-246``.  The
reference's applies are sequential row substitutions (include/
sparse_matrix_math.h:1672-1711, 1802-1837).  :class:`TriangularMatrix`
offers two strategies instead:

* ``dense`` — the factor materialised once and solved with
  ``torch.linalg.solve_triangular`` (exact; O(n^2) memory, so for small n).
  The JAX package calls ``jax.scipy.linalg.solve_triangular`` here, outside
  any Pallas kernel.
* ``jacobi`` — Jacobi iteration on the triangular system,
  ``x_{k+1} = D^{-1} (b - N x_k)`` with ``N`` the strict part.  ``D^{-1} N``
  is nilpotent with index equal to the level-schedule depth, so
  ``sweeps >= depth`` is exact; fewer sweeps give the usual approximate
  triangular solve.

Each sweep's strict product runs through the W-SELL layout (kernel K7, or
K8 for an ``(n, m)`` panel) when the strict part packs under the slot-ratio
cap (trisolve.py:184-226), else it is a gather and an ``index_add_``.
``strict_layout="auto"`` picks W-SELL for a factor on a CUDA device and the
gather on the CPU.  A DIA matrix's preconditioner does not use either: the
padded solve re-lays its factors for the fused sweep kernels.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from ..formats.wsell import WSellMatrix, _wsell_from_coo

__all__ = ["TriangularMatrix", "triangular_from_csr_arrays"]

# beyond this level-schedule depth an "exact" Jacobi-sweep apply costs more
# SpMVs than the Krylov solve it preconditions
_EXACT_SWEEP_WARN_DEPTH = 64


@dataclasses.dataclass(frozen=True)
class TriangularMatrix:
    """Sparse triangular factor, the diagonal stored apart.

    ``data``/``indices``/``row_ids`` hold the STRICT part (row-major); ``diag``
    is the diagonal (all ones for a unit factor).  ``depth`` is the
    level-schedule depth, or -1 when it was not needed.  ``wsell`` is the
    strict part in the W-SELL layout, or None; when present, every sweep's
    strict product runs the W-SELL kernel.
    """

    data: torch.Tensor      # (snnz,) strict-part values
    indices: torch.Tensor   # (snnz,) int64 columns
    row_ids: torch.Tensor   # (snnz,) int64 rows
    diag: torch.Tensor      # (n,)
    dense: Optional[torch.Tensor]  # (n, n) materialised factor, or None
    n: int
    lower: bool
    depth: int
    method: str
    sweeps: int
    wsell: Optional[WSellMatrix] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.diag.dtype

    @property
    def device(self) -> torch.device:
        return self.diag.device

    def _strict_matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.wsell is not None:
            from ..ops.spmv import rmult

            return rmult(self.wsell, x)
        d = self.data[:, None] if x.ndim == 2 else self.data
        g = d * x.index_select(0, self.indices)
        return torch.zeros_like(x).index_add_(0, self.row_ids, g)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """x with T x = b; ``b`` is (n,) or a multi-RHS panel (n, m)."""
        if self.method == "dense":
            rhs = b[:, None] if b.ndim == 1 else b
            x = torch.linalg.solve_triangular(self.dense, rhs, upper=not self.lower)
            return x[:, 0] if b.ndim == 1 else x
        # Jacobi sweeps: sweep 0 is the diagonal scale, then sweeps-1 SpMV sweeps
        inv_d = 1.0 / self.diag
        if b.ndim == 2:
            inv_d = inv_d[:, None]
        x = b * inv_d
        for _ in range(self.sweeps - 1):
            x = (b - self._strict_matvec(x)) * inv_d
        return x


def triangular_from_csr_arrays(
    data: np.ndarray,
    indices: np.ndarray,
    indptr: np.ndarray,
    *,
    lower: bool,
    unit_diag: bool = False,
    method: str = "auto",
    sweeps="exact",
    dense_threshold: int = 4096,
    strict_layout: str = "auto",
    device=None,
) -> TriangularMatrix:
    """A :class:`TriangularMatrix` on ``device`` (the CPU when None) from
    host CSR arrays of a triangular matrix; diagonal entries are split out.
    A ``unit_diag`` factor has implicit ones on the diagonal.

    ``method="auto"`` picks ``dense`` for n <= ``dense_threshold``, else
    ``jacobi``.  ``sweeps="exact"`` takes the level-schedule depth and warns
    past depth 64.  ``strict_layout``: ``"wsell"`` lays a Jacobi factor's
    strict part out as W-SELL (window_f 1, else 8) and keeps the gather path
    when both pad past the cap; ``"csr"`` keeps the gather path; ``"auto"``
    is ``"wsell"`` on a CUDA device and ``"csr"`` on the CPU.
    """
    if strict_layout not in ("auto", "wsell", "csr"):
        raise ValueError(f"unknown strict_layout {strict_layout!r}")
    device = torch.device("cpu") if device is None else torch.device(device)
    data = np.asarray(data)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    on_diag = indices == row_ids
    if unit_diag:
        diag = np.ones(n, dtype=data.dtype)
    else:
        diag = np.zeros(n, dtype=data.dtype)
        diag[row_ids[on_diag]] = data[on_diag]
        if np.any(diag == 0):
            raise ValueError("triangular factor has a zero diagonal entry")
    strict = ~on_diag
    s_data, s_idx, s_row = data[strict], indices[strict], row_ids[strict]
    if lower and np.any(s_idx > s_row):
        raise ValueError("matrix is not lower triangular")
    if not lower and np.any(s_idx < s_row):
        raise ValueError("matrix is not upper triangular")

    if method == "auto":
        method = "dense" if n <= dense_threshold else "jacobi"
    if method not in ("dense", "jacobi"):
        raise ValueError(f"unknown triangular solve method {method!r}")
    # the depth scan is O(n) Python work: only when it is needed
    depth = (_level_depth(s_idx, s_row, n, lower=lower)
             if sweeps == "exact" or method == "dense" else -1)
    if sweeps == "exact":
        n_sweeps = depth
        if method == "jacobi" and depth > _EXACT_SWEEP_WARN_DEPTH:
            warnings.warn(
                f"sweeps='exact' implies {depth} Jacobi sweeps per triangular "
                "apply (each sweep is a full SpMV): at this depth the "
                "preconditioner is technically exact but practically unusable. "
                "Pass an explicit small sweep count (e.g. sweeps=2..8, the "
                "standard approximate triangular solve) for scale.",
                RuntimeWarning,
                stacklevel=3,
            )
    else:
        n_sweeps = int(sweeps)

    dense = None
    if method == "dense":
        dmat = np.zeros((n, n), dtype=data.dtype)
        dmat[s_row, s_idx] = s_data
        dmat[np.arange(n), np.arange(n)] = diag
        dense = torch.as_tensor(dmat, device=device)

    wsell = None
    if method == "jacobi" and s_data.size and (
            strict_layout == "wsell" or (strict_layout == "auto" and device.type == "cuda")):
        for wf in (1, 8):  # narrow windows first, wide for scattered patterns
            try:
                wsell = _wsell_from_coo(s_row, s_idx, s_data, (n, n), int(s_data.size),
                                        device=device, max_slot_ratio=8.0, window_f=wf)
                break
            except ValueError:
                wsell = None  # pads past the cap: try wider, else keep the gather

    return TriangularMatrix(
        data=torch.as_tensor(s_data, device=device),
        indices=torch.as_tensor(s_idx, device=device),
        row_ids=torch.as_tensor(s_row, device=device),
        diag=torch.as_tensor(diag, device=device),
        dense=dense,
        n=int(n),
        lower=bool(lower),
        depth=int(depth),
        method=method,
        sweeps=int(n_sweeps),
        wsell=wsell,
    )


def _level_depth(s_idx: np.ndarray, s_row: np.ndarray, n: int, *, lower: bool) -> int:
    """Level-schedule depth of a strict triangular pattern: the longest
    dependency chain, the nilpotency index of D^{-1} N."""
    if s_row.size == 0:
        return 1
    level = np.zeros(n, dtype=np.int64)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(s_row, minlength=n), out=starts[1:])
    cols_sorted = s_idx[np.argsort(s_row, kind="stable")]
    for r in (range(n) if lower else range(n - 1, -1, -1)):
        lo, hi = starts[r], starts[r + 1]
        if hi > lo:
            level[r] = level[cols_sorted[lo:hi]].max() + 1
    return int(level.max()) + 1
