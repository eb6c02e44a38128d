"""Matrix-free constant-coefficient grid stencils: no matrix traffic.

Port of ``sparse_matrix_math_tpu/formats/stencil.py`` (the whole file).  A
finite-difference stencil on a structured grid (2-D/3-D Poisson,
convection-diffusion) carries no per-entry information: each diagonal holds
ONE coefficient, and its zero pattern is index arithmetic.
:class:`GridStencilMatrix` stores exactly (coefficients, grid shape, grid
offsets).  The apply reshapes the vector to the grid, zero-pads once and adds
one shifted slice per stencil point, in the stencil's point order.  The JAX
package leaves that to XLA, with no Pallas kernel (solvers/_stencil.py:12),
so plain torch ops are its port.  Cuts at the grid's edge are exact: the pad
ring is zero, and a tensor-product grid has no interior cuts, which is the
condition :func:`try_grid_stencil_from_csr` verifies ENTRY FOR ENTRY before
it accepts a matrix, so the routed operator always equals its source.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRMatrix
from .dia import DIAMatrix, try_dia_from_csr

__all__ = ["GridStencilMatrix", "try_grid_stencil_from_csr", "try_grid_stencil_from_dia"]


@dataclasses.dataclass(frozen=True)
class GridStencilMatrix:
    """Constant-coefficient stencil on an N-D tensor-product grid.

    ``coeffs[k]`` is the scalar applied to the neighbour at grid offset
    ``doffs[k]`` (a length-``ndim`` tuple, row-major: the LAST entry is the
    fastest-varying axis).  ``dims`` is the grid shape; the operator acts on
    flat vectors of length ``prod(dims)``.
    """

    coeffs: torch.Tensor  # (npoints,)
    doffs: Tuple[Tuple[int, ...], ...]
    dims: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype

    @property
    def device(self) -> torch.device:
        return self.coeffs.device

    def astype(self, dtype: torch.dtype) -> "GridStencilMatrix":
        return dataclasses.replace(self, coeffs=self.coeffs.to(dtype))

    def to_grid(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(self.dims)

    def from_grid(self, xg: torch.Tensor) -> torch.Tensor:
        return xg.reshape(-1)

    def _pads(self):
        nd = len(self.dims)
        lo = [max(-min(o[d] for o in self.doffs), 0) for d in range(nd)]
        hi = [max(max(o[d] for o in self.doffs), 0) for d in range(nd)]
        return lo, hi

    def _apply(self, xg: torch.Tensor, lead: int) -> torch.Tensor:
        """The shifted-slice sum over the grid axes ``lead .. lead + ndim - 1``
        of ``xg``; the other axes are batch axes."""
        nd = len(self.dims)
        lo, hi = self._pads()
        trail = xg.ndim - lead - nd
        # F.pad takes (left, right) pairs from the LAST axis backwards
        pad = [0, 0] * trail
        for d in reversed(range(nd)):
            pad += [lo[d], hi[d]]
        xp = torch.nn.functional.pad(xg, pad)
        head = (slice(None),) * lead
        y = None
        for k, off in enumerate(self.doffs):
            sl = head + tuple(slice(lo[d] + off[d], lo[d] + off[d] + self.dims[d])
                              for d in range(nd))
            term = self.coeffs[k] * xp[sl]
            y = term if y is None else y + term
        return y

    def apply_grid(self, xg: torch.Tensor) -> torch.Tensor:
        """y = A x with x, y in the grid layout: the solvers keep every carry
        in it (solvers/_stencil.py).  TRAILING axes beyond the grid dims are
        batch axes (a panel of right-hand sides)."""
        return self._apply(xg, 0)

    def apply_batched(self, xg: torch.Tensor) -> torch.Tensor:
        """y = A x for a LEADING-batch grid panel of shape ``(m, *dims)``."""
        return self._apply(xg, 1)

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(self.dtype, x.dtype)
        a = self if self.dtype == dtype else self.astype(dtype)
        x = x.to(dtype)
        if x.ndim == 2:  # a panel of right-hand sides: one batched pass
            m = x.shape[1]
            return a.apply_grid(x.reshape(self.dims + (m,))).reshape(-1, m)
        return a.from_grid(a.apply_grid(a.to_grid(x)))

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def diagonal(self) -> torch.Tensor:
        """The matrix diagonal (constant: the (0, ..., 0) coefficient)."""
        for k, off in enumerate(self.doffs):
            if all(o == 0 for o in off):
                return self.coeffs[k].expand(self.shape[0]).clone()
        return torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)

    def to_dense(self) -> torch.Tensor:
        """Densify by probing with the identity (test and debug sizes only)."""
        return self.rmult(torch.eye(self.shape[0], dtype=self.dtype, device=self.device))


def _strides(dims: Tuple[int, ...]):
    """Row-major strides: strides[i] = prod(dims[i+1:])."""
    out = []
    s = 1
    for d in reversed(dims):
        out.append(s)
        s *= d
    return out[::-1]


def _decompose(off: int, dims: Tuple[int, ...], max_d: int):
    """Mixed-radix decomposition of a flat offset into per-axis grid offsets
    with each |component| <= max_d, or None.  Balanced rounding from the
    slowest axis is exact while max_d is well under every dimension."""
    comps = []
    rem = int(off)
    for s in _strides(dims):
        c = int(round(rem / s))
        if abs(c) > max_d:
            return None
        comps.append(c)
        rem -= c * s
    if rem != 0:
        return None
    return tuple(comps)


def try_grid_stencil_from_csr(csr: CSRMatrix, dims: Optional[Tuple[int, ...]] = None, *,
                              max_point_offset: int = 2, max_diags: int = 32,
                              dia: Optional[DIAMatrix] = None) -> Optional[GridStencilMatrix]:
    """Detect a constant-coefficient grid stencil, verifying EVERY entry.

    ``dims`` gives the grid shape; without it, square 2-D and cubic 3-D grids
    are inferred from n.  Returns None unless the CSR is EXACTLY the stencil
    operator (values constant per offset, zero pattern exactly the
    tensor-product boundary pattern): detection is by reconstruction and
    exact comparison on the host.  Pass an existing DIAMatrix of ``csr`` as
    ``dia`` to skip that build."""
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        return None
    if dia is None:
        dia = try_dia_from_csr(csr, max_diags=max_diags)
    if dia is None:
        return None
    return _detect_from_dia(dia, (int(n_rows), int(n_cols)), int(csr.nnz), dims,
                            max_point_offset)


def try_grid_stencil_from_dia(dia: DIAMatrix, dims: Optional[Tuple[int, ...]] = None, *,
                              max_point_offset: int = 2) -> Optional[GridStencilMatrix]:
    """Stencil detection from a DIAMatrix, with the same entry-for-entry
    verification: the diagonal planes ARE a DIA matrix's full value set."""
    n_rows, n_cols = dia.shape
    if n_rows != n_cols:
        return None
    return _detect_from_dia(dia, (int(n_rows), int(n_cols)), int(dia.nnz), dims,
                            max_point_offset)


def _detect_from_dia(dia: DIAMatrix, shape, nnz, dims, max_point_offset):
    n_rows, n_cols = shape
    candidates = []
    if dims is not None:
        candidates.append(tuple(int(d) for d in dims))
    else:
        r2 = round(n_rows ** 0.5)
        if r2 * r2 == n_rows and r2 > 1:
            candidates.append((r2, r2))
        r3 = round(n_rows ** (1.0 / 3.0))
        for rr in (r3 - 1, r3, r3 + 1):
            if rr > 1 and rr ** 3 == n_rows:
                candidates.append((rr, rr, rr))

    diags = dia.diags.cpu().numpy()
    offsets = dia.offsets
    for cand in candidates:
        if int(np.prod(cand)) != n_rows:
            continue
        doffs, coeffs = [], []
        ok = True
        # index grids for the mask check (built once per candidate)
        coords = []
        rem = np.arange(n_rows, dtype=np.int64)
        for s in _strides(cand):
            coords.append(rem // s)
            rem = rem % s
        for d_i, off in enumerate(offsets):
            row = diags[d_i]
            comp = _decompose(int(off), cand, max_point_offset)
            if comp is None:
                ok = False
                break
            nz = row[row != 0]
            if nz.size == 0:
                continue  # an all-zero diagonal contributes nothing
            c = nz[0]
            mask = np.ones(n_rows, bool)
            for ax in range(len(cand)):
                v = coords[ax] + comp[ax]
                mask &= (v >= 0) & (v < cand[ax])
            expected = np.where(mask, c, np.zeros((), row.dtype))
            if not np.array_equal(row, expected):
                ok = False
                break
            doffs.append(comp)
            coeffs.append(c)
        if ok and doffs:
            return GridStencilMatrix(
                coeffs=torch.from_numpy(np.asarray(coeffs)).to(dia.device),
                doffs=tuple(doffs), dims=cand, shape=(int(n_rows), int(n_cols)),
                nnz=int(nnz))
    return None
