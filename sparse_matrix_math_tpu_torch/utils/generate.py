"""Model-problem matrix generators.

Port of ``sparse_matrix_math_tpu/utils/generate.py:28-200``: the same NumPy
construction and the same values, returned as a :class:`CSRMatrix` on the
device the caller names.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix, _csr_from_sorted

__all__ = [
    "laplace_1d", "poisson_2d", "poisson_3d", "poisson_3d_27pt",
    "convection_diffusion_2d",
]


def _sorted_csr(rows, cols, vals, shape: Tuple[int, int], dtype, device) -> CSRMatrix:
    key = rows * np.int64(shape[1]) + cols
    order = np.argsort(key, kind="stable")
    as_t = lambda a: torch.as_tensor(a[order], device=device)  # noqa: E731
    return _csr_from_sorted(as_t(rows), as_t(cols), as_t(vals).to(dtype), shape)


def laplace_1d(n: int, dtype=torch.float64, *, device) -> CSRMatrix:
    """Tridiagonal [-1, 2, -1] SPD matrix."""
    r = np.arange(n)
    rows = np.concatenate([r[1:], r, r[:-1]])
    cols = np.concatenate([r[:-1], r, r[1:]])
    vals = np.concatenate([np.full(n - 1, -1.0), np.full(n, 2.0), np.full(n - 1, -1.0)])
    return _sorted_csr(rows, cols, vals, (n, n), dtype, device)


def poisson_2d(nx: int, ny: int = None, dtype=torch.float64, *, device) -> CSRMatrix:
    """5-point 2-D Poisson stencil on an nx-by-ny grid (n = nx*ny rows):
    diagonal 4, off-diagonals -1 at (+-1, +-nx) with row-boundary cuts on
    the +-1 couplings.  SPD; ~10M nnz at nx=ny=1414."""
    ny = nx if ny is None else ny
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0)]
    for mask, off in ((ix > 0, -1), (ix < nx - 1, 1), (idx >= nx, -nx), (idx < n - nx, nx)):
        rows.append(idx[mask]); cols.append(idx[mask] + off)
        vals.append(np.full(mask.sum(), -1.0))
    return _sorted_csr(np.concatenate(rows), np.concatenate(cols),
                       np.concatenate(vals), (n, n), dtype, device)


def poisson_3d(nx: int, ny: int = None, nz: int = None, dtype=torch.float64, *,
               device) -> CSRMatrix:
    """7-point 3-D Poisson stencil (diagonal 6, neighbours -1)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    rows, cols, vals = [idx], [idx], [np.full(n, 6.0)]
    for mask, off in (
        (ix > 0, -1), (ix < nx - 1, 1), (iy > 0, -nx), (iy < ny - 1, nx),
        (idx >= nx * ny, -nx * ny), (idx < n - nx * ny, nx * ny),
    ):
        rows.append(idx[mask]); cols.append(idx[mask] + off)
        vals.append(np.full(mask.sum(), -1.0))
    return _sorted_csr(np.concatenate(rows), np.concatenate(cols),
                       np.concatenate(vals), (n, n), dtype, device)


def poisson_3d_27pt(nx: int, ny: int = None, nz: int = None, dtype=torch.float64, *,
                    device) -> CSRMatrix:
    """27-point 3-D Laplacian: all 26 grid neighbours at -1, diagonal 26.
    SPD; 27 diagonals make the DIA product matrix-stream-bound."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, vals = [idx], [idx], [np.full(n, 26.0)]
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == dy == dz == 0:
                    continue
                m = (
                    (ix + dx >= 0) & (ix + dx < nx)
                    & (iy + dy >= 0) & (iy + dy < ny)
                    & (iz + dz >= 0) & (iz + dz < nz)
                )
                rows.append(idx[m])
                cols.append(idx[m] + dx + dy * nx + dz * nx * ny)
                vals.append(np.full(int(m.sum()), -1.0))
    return _sorted_csr(np.concatenate(rows), np.concatenate(cols),
                       np.concatenate(vals), (n, n), dtype, device)


def convection_diffusion_2d(nx: int, ny: int = None, cx: float = 0.5, cy: float = 0.25,
                            dtype=torch.float64, *, device) -> CSRMatrix:
    """Upwind convection-diffusion stencil, the NONSYMMETRIC model problem.
    Row (i,j): diag ``4 + cx + cy``; west ``-1 - cx``; east ``-1``; north
    ``-1 - cy``; south ``-1``.  A row-diagonally dominant M-matrix."""
    ny = nx if ny is None else ny
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    rows, cols, vals = [idx], [idx], [np.full(n, 4.0 + cx + cy)]
    for mask, off, v in (
        (ix > 0, -1, -1.0 - cx), (ix < nx - 1, 1, -1.0),
        (idx >= nx, -nx, -1.0 - cy), (idx < n - nx, nx, -1.0),
    ):
        rows.append(idx[mask]); cols.append(idx[mask] + off)
        vals.append(np.full(mask.sum(), v))
    return _sorted_csr(np.concatenate(rows), np.concatenate(cols),
                       np.concatenate(vals), (n, n), dtype, device)
