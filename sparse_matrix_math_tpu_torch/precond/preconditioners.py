"""Preconditioners: Identity, Jacobi, Symmetric Gauss-Seidel, ILU(0), IC(0).

Port of ``sparse_matrix_math_tpu/precond/preconditioners.py:58-359``.  Each
has ``apply(rhs) -> z`` solving ``M z = rhs`` for an (n,) vector or an
(n, m) panel, on the device of the matrix it was built from.  The
triangular applies of SGS, ILU(0) and IC(0) are :class:`TriangularMatrix`
solves (``method=``/``sweeps=`` at construction); a DIA solve re-lays them
into the padded layout, where every apply is one call of a fused sweep
kernel (solvers/_padded.py).  The factorizations run on the host
(precond/_factorize.py).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ._factorize import (
    FactorizationError,
    ic0_factorize_host,
    ilu0_factorize_host,
    split_triangular,
)
from .trisolve import TriangularMatrix, triangular_from_csr_arrays

__all__ = [
    "SolverPreconditioner", "IdentityPreconditioner", "JacobiPreconditioner",
    "SGSPreconditioner", "ILU0Preconditioner", "IC0Preconditioner", "get_preconditioner",
    "FactorizationError",
]

_SGS_MIN_DIAG = 1e-5  # reference diagonal magnitude floor (h:1690-1693)


class SolverPreconditioner(enum.Enum):
    """Preconditioner selector (reference enum h:1002-1006, which misspells
    SYMMETRIC_GAUS_SEIDEL; :func:`get_preconditioner` takes both spellings)."""

    NONE = "none"
    JACOBI = "jacobi"
    SYMMETRIC_GAUSS_SEIDEL = "sgs"
    ILU0 = "ilu0"
    IC0 = "ic0"


@dataclasses.dataclass(frozen=True)
class IdentityPreconditioner:
    """No-op preconditioner (reference IDPreconditioner, h:1165-1170)."""

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        return rhs


@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M = D: one elementwise multiply per apply."""

    inv_diag: torch.Tensor

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        d = self.inv_diag[:, None] if rhs.ndim == 2 else self.inv_diag
        return rhs * d

    @classmethod
    def from_matrix(cls, a: CSRMatrix) -> "JacobiPreconditioner":
        """Inverse diagonal of a square CSR matrix, on its device; a zero or
        missing diagonal entry raises :class:`FactorizationError`."""
        on_diag = a.indices == a.row_ids
        diag = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
        diag[a.row_ids[on_diag]] = a.data[on_diag]
        if bool((diag == 0).any()):
            raise FactorizationError("matrix has zero diagonal entries")
        return cls(inv_diag=1.0 / diag)


@dataclasses.dataclass(frozen=True)
class SGSPreconditioner:
    """Symmetric Gauss-Seidel, M = (D+L) D^{-1} (D+U).

    apply solves (D+L) y = rhs (forward, h:1672-1695), then
    (I + D^{-1} U) x = y, written as (D+U) x = D y (backward, h:1697-1711).
    """

    fwd: TriangularMatrix   # D + L
    bwd: TriangularMatrix   # D + U
    diag: torch.Tensor

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        y = self.fwd.solve(rhs)
        d = self.diag[:, None] if rhs.ndim == 2 else self.diag
        return self.bwd.solve(d * y)

    @classmethod
    def from_matrix(cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
                    strict_layout: str = "auto") -> "SGSPreconditioner":
        """Raises :class:`FactorizationError` when a diagonal entry is below
        1e-5 in magnitude (the reference returns error 1, h:1690-1693)."""
        diag, (ld, li, lr), (ud, ui, ur) = _host_split(a)
        if np.any(np.abs(diag) < _SGS_MIN_DIAG):
            raise FactorizationError(
                f"SGS requires |diagonal| >= {_SGS_MIN_DIAG} on every row"
            )
        n = a.shape[0]
        kw = dict(method=method, sweeps=sweeps, strict_layout=strict_layout, device=a.device)
        fwd = _strict_to_triangular(ld, li, lr, diag, n, lower=True, **kw)
        bwd = _strict_to_triangular(ud, ui, ur, diag, n, lower=False, **kw)
        return cls(fwd=fwd, bwd=bwd, diag=torch.as_tensor(diag, device=a.device))


@dataclasses.dataclass(frozen=True)
class ILU0Preconditioner:
    """M = L U on A's pattern (zero fill): a forward solve with the unit
    lower L, then a backward solve with U.

    ``shift`` is the diagonal shift the factorization was retried with after
    a (near-)zero pivot: 0.0 normally, > 0 when the factors are those of
    A + shift*I, which then precondition A itself.
    """

    lower: TriangularMatrix  # unit lower L
    upper: TriangularMatrix  # U, diagonal included
    shift: float = 0.0

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.upper.solve(self.lower.solve(rhs))

    @classmethod
    def from_matrix(cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
                    strict_layout: str = "auto", pivot_shift: str = "auto"
                    ) -> "ILU0Preconditioner":
        """``pivot_shift='auto'``: on a pivot with ``|pivot| <= 1e-12`` times
        the mean |diagonal|, retry on ``A + alpha*I`` with ``alpha`` rising
        from 1e-3 to 100 times the mean |diagonal|, and report it as
        ``.shift``.  ``pivot_shift='never'`` raises on such a pivot."""
        data = a.data.cpu().numpy().astype(np.float64)
        indices = a.indices.cpu().numpy()
        indptr = a.indptr.cpu().numpy()
        n = a.shape[0]
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        on_diag = indices == row_ids
        dscale = float(np.abs(data[on_diag]).mean()) if on_diag.any() else 1.0
        ptol = 1e-12 * max(dscale, np.finfo(np.float64).tiny)
        shifts = [0.0]
        if pivot_shift == "auto":
            shifts += [dscale * 1e-3 * 10.0 ** k for k in range(6)]
        for alpha in shifts:
            d2 = data if alpha == 0.0 else np.where(
                on_diag, np.where(data >= 0, data + alpha, data - alpha), data)
            try:
                factor, _ = ilu0_factorize_host(d2, indices, indptr, pivot_tol=ptol)
                break
            except FactorizationError:
                if alpha == shifts[-1]:
                    raise
        dtype = a.data.cpu().numpy().dtype
        diag_f, (ld, li, lr), (ud, ui, ur) = split_triangular(
            factor.astype(dtype), indices, indptr)
        kw = dict(method=method, sweeps=sweeps, strict_layout=strict_layout, device=a.device)
        lower = _strict_to_triangular(ld, li, lr, np.ones(n, dtype=dtype), n, lower=True, **kw)
        upper = _strict_to_triangular(ud, ui, ur, diag_f, n, lower=False, **kw)
        return cls(lower=lower, upper=upper, shift=float(alpha))


@dataclasses.dataclass(frozen=True)
class IC0Preconditioner:
    """M = L L^T on A's lower pattern (zero fill): a forward solve with L,
    then a backward solve with L^T (reference h:1802-1837)."""

    lower: TriangularMatrix  # L, diagonal included
    upper: TriangularMatrix  # L^T, diagonal included

    def apply(self, rhs: torch.Tensor) -> torch.Tensor:
        return self.upper.solve(self.lower.solve(rhs))

    @classmethod
    def from_matrix(cls, a: CSRMatrix, *, method: str = "auto", sweeps="exact",
                    strict_layout: str = "auto") -> "IC0Preconditioner":
        """Raises :class:`FactorizationError` on a non-SPD matrix."""
        lv, lidx, lptr = ic0_factorize_host(a.data.cpu().numpy(), a.indices.cpu().numpy(),
                                            a.indptr.cpu().numpy())
        lv = lv.astype(a.data.cpu().numpy().dtype)
        n = a.shape[0]
        kw = dict(method=method, sweeps=sweeps, strict_layout=strict_layout, device=a.device)
        lower = triangular_from_csr_arrays(lv, lidx, lptr, lower=True, **kw)
        # transpose L into upper CSR on the host: sort by (new row = old
        # column, new column = old row)
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(lptr))
        order = np.lexsort((row_ids, lidx))
        t_rows, t_cols, t_vals = lidx[order], row_ids[order], lv[order]
        t_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(t_rows, minlength=n), out=t_ptr[1:])
        upper = triangular_from_csr_arrays(t_vals, t_cols, t_ptr, lower=False, **kw)
        return cls(lower=lower, upper=upper)


def get_preconditioner(a: CSRMatrix, kind=SolverPreconditioner.NONE, **kwargs):
    """Preconditioner factory (reference getPreconditioner, h:1643-1651,
    which builds only NONE and SGS).  ``kind`` is a
    :class:`SolverPreconditioner` or one of its names or aliases."""
    if isinstance(kind, str):
        if kind.lower() in ("cheby", "chebyshev", "poly", "polynomial"):
            # polynomial preconditioning: the apply is k products with A
            from .cheby_poly import ChebyshevPreconditioner

            return ChebyshevPreconditioner.from_matrix(a, **kwargs)
        aliases = {
            "none": SolverPreconditioner.NONE,
            "jacobi": SolverPreconditioner.JACOBI,
            "diagonal": SolverPreconditioner.JACOBI,
            "sgs": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "symmetric_gauss_seidel": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "symmetric_gaus_seidel": SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL,
            "ilu0": SolverPreconditioner.ILU0,
            "ic0": SolverPreconditioner.IC0,
        }
        kind = aliases[kind.lower()]
    if kind == SolverPreconditioner.NONE:
        return IdentityPreconditioner()
    if kind == SolverPreconditioner.JACOBI:
        return JacobiPreconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.SYMMETRIC_GAUSS_SEIDEL:
        return SGSPreconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.ILU0:
        return ILU0Preconditioner.from_matrix(a, **kwargs)
    if kind == SolverPreconditioner.IC0:
        return IC0Preconditioner.from_matrix(a, **kwargs)
    raise ValueError(f"unknown preconditioner kind: {kind!r}")


def _host_split(a: CSRMatrix):
    return split_triangular(a.data.cpu().numpy(), a.indices.cpu().numpy(),
                            a.indptr.cpu().numpy())


def _strict_to_triangular(s_data, s_idx, s_row, diag, n, *, lower, method, sweeps,
                          strict_layout="auto", device=None) -> TriangularMatrix:
    """A TriangularMatrix from a strict part in row-major COO and a
    separate diagonal: the diagonal goes last in each row of a lower
    factor and first in each row of an upper one."""
    counts = np.bincount(s_row, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts + 1, out=indptr[1:])  # one more slot per row for the diagonal
    nnz = int(indptr[-1])
    out_val = np.empty(nnz, dtype=np.asarray(diag).dtype)
    out_idx = np.empty(nnz, dtype=np.int64)
    order = np.argsort(s_row, kind="stable")
    sr, si, sd = s_row[order], s_idx[order], s_data[order]
    within = _within_row_offsets(sr, n)
    ddst = indptr[1:] - 1 if lower else indptr[:-1]
    dst = indptr[sr] + within + (0 if lower else 1)
    out_val[dst] = sd
    out_idx[dst] = si
    out_val[ddst] = diag
    out_idx[ddst] = np.arange(n)
    return triangular_from_csr_arrays(out_val, out_idx, indptr, lower=lower, method=method,
                                      sweeps=sweeps, strict_layout=strict_layout,
                                      device=device)


def _within_row_offsets(sorted_rows: np.ndarray, n: int) -> np.ndarray:
    """Offset of each entry within its row, given row-sorted entries."""
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(np.bincount(sorted_rows, minlength=n)[:-1], out=starts[1:])
    return np.arange(sorted_rows.shape[0], dtype=np.int64) - starts[sorted_rows]
