"""Build the port's objects from plain NumPy arrays.

State crosses from the JAX package as ``np.asarray(...)`` of its objects'
fields; these converters rebuild the matching objects on ``device``.  The
port itself never sees a JAX object.
"""

from __future__ import annotations

import numpy as np
import torch

from .formats.csr import CSRMatrix
from .formats.dia import DIAMatrix
from .formats.ell import ELLMatrix
from .formats.hyb import HYBMatrix
from .formats.reorder import ReorderedMatrix
from .formats.rsell import RoutedMatrix, StreamPass
from .formats.stencil import GridStencilMatrix
from .formats.wsell import WSellMatrix, slab_pointers
from .ops.df32 import DfDiaMatrix, DfEllMatrix
from .precond.preconditioners import (
    IC0Preconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from .precond.trisolve import TriangularMatrix
from .solvers.multigrid import PoissonMultigrid

__all__ = ["csr_from_numpy", "dia_from_numpy", "jacobi_from_numpy", "triangular_from_numpy",
           "sgs_from_numpy", "ic0_from_numpy", "ilu0_from_numpy", "wsell_from_numpy",
           "ell_from_numpy", "hyb_from_numpy", "reordered_from_numpy", "df_dia_from_numpy",
           "df_ell_from_numpy", "routed_from_numpy", "grid_stencil_from_numpy",
           "multigrid_from_numpy"]


def csr_from_numpy(indptr, indices, data, shape, device) -> CSRMatrix:
    """A :class:`CSRMatrix` from CSR arrays; ``row_ids`` derive from ``indptr``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n_rows = int(shape[0])
    if indptr.shape != (n_rows + 1,):
        raise ValueError(f"indptr has {indptr.shape[0]} entries, expected {n_rows + 1}")
    if indptr[0] != 0 or indptr[-1] != np.asarray(data).shape[0] or np.any(np.diff(indptr) < 0):
        raise ValueError("indptr must start at 0, not decrease and end at nnz")
    indptr = torch.tensor(indptr, device=device)
    row_ids = torch.repeat_interleave(
        torch.arange(n_rows, device=device), torch.diff(indptr)
    )
    return CSRMatrix(
        data=torch.tensor(np.asarray(data), device=device),
        indices=torch.tensor(np.asarray(indices, dtype=np.int64), device=device),
        indptr=indptr, row_ids=row_ids, shape=(n_rows, int(shape[1])),
    )


def dia_from_numpy(diags, offsets, shape, nnz, device, dtype=None) -> DIAMatrix:
    """A :class:`DIAMatrix` from its (ndiags, rows) diagonals and offsets.

    ``dtype`` casts the diagonals in torch, rounding to nearest even: NumPy
    has no bfloat16, so bfloat16 diagonals (the mixed solve's low operator,
    ``dataclasses.replace(pad_dia(a), diags_p=...)``) are made from the
    float32 arrays here, bit for bit what the JAX package's ``astype`` holds."""
    diags = torch.tensor(np.asarray(diags), device=device)
    if dtype is not None:
        diags = diags.to(dtype)
    offsets = tuple(int(o) for o in offsets)
    if diags.ndim != 2 or diags.shape[0] != len(offsets):
        raise ValueError(f"diags of shape {tuple(diags.shape)} for {len(offsets)} offsets")
    return DIAMatrix(diags=diags, offsets=offsets,
                     shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def wsell_from_numpy(fields, device) -> WSellMatrix:
    """A :class:`WSellMatrix` from a mapping of its fields: the planes
    ``vals``, ``meta``, ``base`` and ``slab``, and ``shape``, ``nnz``,
    ``n_slabs``, ``x_rows``, ``slot_ratio``, ``window_f`` and ``nway``.
    ``slab_ptr`` is derived from ``slab``, and K7's slab-sorted SELL-32
    layout from the planes (padding told by rule, ``formats/sell.py``)."""
    slab = np.asarray(fields["slab"], dtype=np.int32)
    planes = dict(vals=np.asarray(fields["vals"]), meta=np.asarray(fields["meta"], np.int32),
                  base=np.asarray(fields["base"], np.int32), slab=slab,
                  slab_ptr=slab_pointers(slab, int(fields["n_slabs"])))
    return WSellMatrix(**{k: torch.tensor(v, device=device) for k, v in planes.items()},
                       shape=(int(fields["shape"][0]), int(fields["shape"][1])),
                       nnz=int(fields["nnz"]), n_slabs=int(fields["n_slabs"]),
                       x_rows=int(fields["x_rows"]), slot_ratio=float(fields["slot_ratio"]),
                       window_f=int(fields["window_f"]), nway=int(fields["nway"]))


def ell_from_numpy(vals, cols, shape, nnz, device) -> ELLMatrix:
    """An :class:`ELLMatrix` from its ``(rows_padded, K)`` planes (K6's
    layout derived from them, each row's live slots ending before its
    trailing slots of value 0 and column 0)."""
    return ELLMatrix(vals=torch.tensor(np.asarray(vals), device=device),
                     cols=torch.tensor(np.asarray(cols, dtype=np.int32), device=device),
                     shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def hyb_from_numpy(dia, rest, shape, nnz, device) -> HYBMatrix:
    """A :class:`HYBMatrix` from its parts: ``dia`` is None or a mapping with
    ``diags``, ``offsets`` and ``nnz``; ``rest`` is None or a mapping with
    ``indptr``, ``indices`` and ``data``."""
    d = None if dia is None else dia_from_numpy(dia["diags"], dia["offsets"], shape,
                                                dia["nnz"], device)
    r = None if rest is None else csr_from_numpy(rest["indptr"], rest["indices"],
                                                 rest["data"], shape, device)
    return HYBMatrix(dia=d, rest=r, shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def reordered_from_numpy(inner, inner_csr, perm, iperm, shape, nnz) -> ReorderedMatrix:
    """A :class:`ReorderedMatrix` from the port's inner operator and permuted
    CSR (built with the converters above) and the host permutations, placed
    on the inner operator's device."""
    device = inner.device
    return ReorderedMatrix(
        inner=inner, inner_csr=inner_csr,
        perm=torch.tensor(np.asarray(perm, dtype=np.int64), device=device),
        iperm=torch.tensor(np.asarray(iperm, dtype=np.int64), device=device),
        shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def routed_from_numpy(passes, final, shape, nnz, slot_ratio, device) -> RoutedMatrix:
    """A :class:`RoutedMatrix` from its routing passes, each a mapping with
    the planes ``vals``, ``meta`` and ``base`` and ``x_rows`` and
    ``window_f``, and ``final``, a mapping for :func:`wsell_from_numpy`.
    The chain is folded for the product on ``device`` as ``routed_from_csr``
    folds its own (``formats/rsell.py:fold_chain``)."""
    def stream_pass(f):
        return StreamPass(vals=torch.tensor(np.asarray(f["vals"]), device=device),
                          meta=torch.tensor(np.asarray(f["meta"], np.int32), device=device),
                          base=torch.tensor(np.asarray(f["base"], np.int32), device=device),
                          x_rows=int(f["x_rows"]), window_f=int(f["window_f"]))

    return RoutedMatrix(passes=tuple(stream_pass(f) for f in passes),
                        final=wsell_from_numpy(final, device),
                        shape=(int(shape[0]), int(shape[1])), nnz=int(nnz),
                        slot_ratio=float(slot_ratio))


def grid_stencil_from_numpy(coeffs, doffs, dims, shape, nnz, device) -> GridStencilMatrix:
    """A :class:`GridStencilMatrix` from its coefficients, grid offsets and
    grid shape."""
    return GridStencilMatrix(coeffs=torch.tensor(np.asarray(coeffs), device=device),
                             doffs=tuple(tuple(int(o) for o in off) for off in doffs),
                             dims=tuple(int(d) for d in dims),
                             shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def df_dia_from_numpy(diags_hi, diags_lo, offsets, shape, nnz, device) -> DfDiaMatrix:
    """A :class:`DfDiaMatrix` from its (ndiags, rows) hi and lo planes."""
    hi, lo = (dia_from_numpy(d, offsets, shape, nnz, device).diags for d in (diags_hi, diags_lo))
    return DfDiaMatrix(diags_hi=hi, diags_lo=lo, offsets=tuple(int(o) for o in offsets),
                       shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def df_ell_from_numpy(vals_hi, vals_lo, cols, shape, nnz, device) -> DfEllMatrix:
    """A :class:`DfEllMatrix` from its ``(rows_padded, K)`` hi, lo and column
    planes."""
    hi, lo = (ell_from_numpy(v, cols, shape, nnz, device) for v in (vals_hi, vals_lo))
    return DfEllMatrix(vals_hi=hi.vals, vals_lo=lo.vals, cols=hi.cols,
                       shape=(int(shape[0]), int(shape[1])), nnz=int(nnz))


def jacobi_from_numpy(inv_diag, device) -> JacobiPreconditioner:
    """A :class:`JacobiPreconditioner` from its inverse diagonal."""
    return JacobiPreconditioner(inv_diag=torch.tensor(np.asarray(inv_diag), device=device))


def triangular_from_numpy(fields, device) -> TriangularMatrix:
    """A :class:`TriangularMatrix` from a mapping of its fields: the arrays
    ``data``, ``indices``, ``row_ids``, ``diag`` and ``dense`` (None when
    absent), and ``n``, ``lower``, ``depth``, ``method``, ``sweeps``; an
    optional ``wsell``, a mapping for :func:`wsell_from_numpy` (or None)."""
    def tensor(name, dtype=None):
        return torch.tensor(np.asarray(fields[name], dtype=dtype), device=device)

    return TriangularMatrix(
        data=tensor("data"), indices=tensor("indices", np.int64),
        row_ids=tensor("row_ids", np.int64), diag=tensor("diag"),
        dense=None if fields.get("dense") is None else tensor("dense"),
        n=int(fields["n"]), lower=bool(fields["lower"]), depth=int(fields["depth"]),
        method=str(fields["method"]), sweeps=int(fields["sweeps"]),
        wsell=None if fields.get("wsell") is None else wsell_from_numpy(fields["wsell"], device),
    )


def sgs_from_numpy(fwd_fields, bwd_fields, diag, device) -> SGSPreconditioner:
    """An :class:`SGSPreconditioner` from its two factors' fields and diagonal."""
    return SGSPreconditioner(fwd=triangular_from_numpy(fwd_fields, device),
                             bwd=triangular_from_numpy(bwd_fields, device),
                             diag=torch.tensor(np.asarray(diag), device=device))


def ic0_from_numpy(lower_fields, upper_fields, device) -> IC0Preconditioner:
    """An :class:`IC0Preconditioner` from the fields of L and L^T."""
    return IC0Preconditioner(lower=triangular_from_numpy(lower_fields, device),
                             upper=triangular_from_numpy(upper_fields, device))


def ilu0_from_numpy(lower_fields, upper_fields, shift, device) -> ILU0Preconditioner:
    """An :class:`ILU0Preconditioner` from the fields of L and U and its shift."""
    return ILU0Preconditioner(lower=triangular_from_numpy(lower_fields, device),
                              upper=triangular_from_numpy(upper_fields, device),
                              shift=float(shift))


def multigrid_from_numpy(coarse_inv, factors, winv, dims, nu1, nu2, omega,
                         device) -> PoissonMultigrid:
    """A :class:`PoissonMultigrid` from its hierarchy: the coarsest level's
    dense inverse, the per-level ``(dL, uL, dM, uM)`` factors of every axis,
    the Jacobi weights ``winv`` and the grid of every level."""
    def tensor(a):
        return torch.tensor(np.asarray(a), device=device)

    return PoissonMultigrid(
        coarse_inv=tensor(coarse_inv),
        factors=tuple(tuple(tuple(tensor(v) for v in axis) for axis in level)
                      for level in factors),
        winv=tuple(tensor(w) for w in winv),
        dims=tuple(tuple(int(m) for m in d) for d in dims),
        nu1=int(nu1), nu2=int(nu2), omega=float(omega))
