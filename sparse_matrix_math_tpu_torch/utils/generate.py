"""Model-problem matrix generators.

Port of ``sparse_matrix_math_tpu/utils/generate.py:28-389``: the
same NumPy construction, the same random draws and the same values, returned
as a :class:`CSRMatrix` on the device the caller names.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix, _csr_from_sorted
from ..formats.triplet import host_coo_arrays

__all__ = [
    "laplace_1d", "poisson_2d", "poisson_3d", "poisson_3d_27pt",
    "convection_diffusion_2d", "laplace_3d_jittered", "uniform_random_csr",
    "random_spd_csr", "sherman1_tiled",
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


def _summed_csr(r, c, v, n: int, dtype, device) -> CSRMatrix:
    """CSR of n-by-n COO arrays with duplicate entries summed, in the JAX
    generators' order: a stable sort by (row, col), then ``np.add.at`` in
    float64 (generate.py:280-289)."""
    key = r * np.int64(n) + c
    order = np.argsort(key, kind="stable")
    key, r, c, v = key[order], r[order], c[order], v[order]
    uniq = np.ones(key.shape[0], bool)
    uniq[1:] = key[1:] != key[:-1]
    grp = np.cumsum(uniq) - 1
    v_sum = np.zeros(int(grp[-1]) + 1)
    np.add.at(v_sum, grp, v)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return _csr_from_sorted(as_t(r[uniq]), as_t(c[uniq]), as_t(v_sum).to(dtype), (n, n))


def laplace_3d_jittered(m: int, jitter: int = 8, seed: int = 0, dtype=torch.float64,
                        symmetric: bool = False, shift: float = 0.0, *,
                        device) -> CSRMatrix:
    """7-point 3-D Laplacian on an m^3 grid whose off-diagonal COLUMN indices
    are moved by a random integer in ``[-jitter, jitter]``: the band survives
    but no diagonal structure does, so DIA refuses it and W-SELL is the fast
    path.  ``symmetric=True`` returns (A + A^T)/2; ``shift`` adds a constant
    to the diagonal values (the pattern is unchanged).  Colliding entries
    sum."""
    n = m ** 3
    i = np.arange(n)
    iz, iy, ix = i // (m * m), (i // m) % m, i % m
    rows, cols, vals = [i], [i], [np.full(n, 6.0 + shift)]
    rng = np.random.default_rng(seed)
    for off, valid in ((1, ix < m - 1), (-1, ix > 0), (m, iy < m - 1), (-m, iy > 0),
                       (m * m, iz < m - 1), (-m * m, iz > 0)):
        r = i[valid]
        c = np.clip(r + off + rng.integers(-jitter, jitter + 1, r.shape[0]), 0, n - 1)
        rows.append(r)
        cols.append(c)
        vals.append(np.full(r.shape[0], -1.0))
    r, c, v = np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    if symmetric:
        r, c, v = np.concatenate([r, c]), np.concatenate([c, r]), np.concatenate([v, v]) * 0.5
    return _summed_csr(r, c, v, n, dtype, device)


def uniform_random_csr(n: int, per_row: int = 5, seed: int = 42, dtype=torch.float64, *,
                       device) -> CSRMatrix:
    """Diagonal ``per_row + 1`` plus ``per_row`` uniformly random
    off-diagonal entries of -1 per row: the zero-locality pattern no
    renumbering helps."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n, dtype=np.int64), per_row + 1)
    c = np.empty((n, per_row + 1), np.int64)
    c[:, 0] = np.arange(n)
    c[:, 1:] = rng.integers(0, n, (n, per_row))
    c = c.reshape(-1)
    v = np.where(c == r, float(per_row + 1), -1.0)
    return _summed_csr(r, c, v, n, dtype, device)


def random_spd_csr(n: int, density: float = 0.05, seed: int = 0, dtype=torch.float64, *,
                   device) -> CSRMatrix:
    """Random symmetric, strictly diagonally dominant (hence SPD) matrix."""
    rng = np.random.default_rng(seed)
    nnz_target = max(int(n * n * density / 2), n)
    r = rng.integers(0, n, nnz_target)
    c = rng.integers(0, n, nnz_target)
    off = r != c
    r, c = r[off], c[off]
    v = rng.uniform(-1.0, 1.0, r.shape[0])
    rr, cc, vv, _ = host_coo_arrays(np.concatenate([r, c]), np.concatenate([c, r]),
                                    np.concatenate([v, v]), (n, n), dtype=np.float64)
    row_abs = np.zeros(n)
    np.add.at(row_abs, rr, np.abs(vv))
    diag = np.arange(n, dtype=np.int64)
    return _sorted_csr(np.concatenate([rr, diag]), np.concatenate([cc, diag]),
                       np.concatenate([vv, row_abs + 1.0]), (n, n), dtype, device)


def sherman1_tiled(copies: int, seed: int = 0, dtype=torch.float64, mtx_path: str = None,
                   jitter: bool = True, *, device) -> CSRMatrix:
    """Block-diagonal copies of the sherman1 pattern (an oil-reservoir
    matrix of the Harwell-Boeing collection) with each copy's off-diagonal
    columns moved by a seeded integer in ``[-2, 2]``: an unstructured
    pattern at benchmark scale.  ``jitter=False`` keeps every copy on
    sherman1's own pattern.  The diagonal stays in place, as the
    factorization preconditioners need it.

    ``mtx_path`` names the sherman1 ``.mtx`` file, else the
    ``SMM_SHERMAN1_MTX`` environment variable does; the package ships no
    copy, and a missing file raises FileNotFoundError."""
    import os

    from ..io import load_matrix_csr

    if mtx_path is None:
        mtx_path = os.environ.get("SMM_SHERMAN1_MTX")
    if mtx_path is None or not os.path.exists(mtx_path):
        raise FileNotFoundError(
            f"sherman1 seed matrix not found at {mtx_path!r}; pass mtx_path= or set "
            "SMM_SHERMAN1_MTX")
    a = load_matrix_csr(mtx_path, device="cpu")
    r0, c0, v0 = a.row_ids.numpy(), a.indices.numpy(), a.data.numpy()
    nb = a.shape[0]
    rng = np.random.default_rng(seed)
    diag0 = c0 == r0
    rs, cs, vs = [], [], []
    for k in range(copies):
        c = c0
        if jitter:
            c = np.where(diag0, c0, np.clip(c0 + rng.integers(-2, 3, c0.shape[0]), 0, nb - 1))
        rs.append(r0 + k * nb)
        cs.append(c + k * nb)
        vs.append(v0)
    return _summed_csr(np.concatenate(rs), np.concatenate(cs), np.concatenate(vs),
                       nb * copies, dtype, device)
