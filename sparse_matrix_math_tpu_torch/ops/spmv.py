"""SpMV family: y = op(lhs, A @ x).

Port of ``sparse_matrix_math_tpu/ops/spmv.py:94-136, 148-320``, the
reference's ``rMultOp`` family (include/sparse_matrix_math.h:1458-1515):

* CSR — gather ``x`` by column, multiply, then :func:`row_sum`: each row's
  products added in the entries' order, the same bits on every run.  The
  JAX package computes this in XLA, not in a kernel, so plain torch is its
  port.
* DIA — the hand-written kernel :func:`~.dia_spmv.dia_spmv` (K1).
* ELL — the kernel :func:`~.ell_spmv.ell_spmv` (K6) for a vector,
  :func:`~.ell_spmv.ell_spmm` (the panel kernel K8 runs too) for an
  ``(n, k)`` panel.  The JAX package runs XLA here (its Mosaic refuses the
  kernel's gather).
* W-SELL — :func:`~.wsell_spmv.wsell_spmv` (K7) for a vector,
  :func:`~.wsell_spmv.wsell_spmm` (K8) for an ``(n, k)`` panel.
* R-SELL — the routed chain folded once per matrix into its final pass's
  layout (``RoutedMatrix.sell``): :func:`~.wsell_spmv.routed_spmv`, one
  launch of K7's kernel on x, for a vector, :func:`~.wsell_spmv.routed_spmm`
  (K8's) for an ``(n, k)`` panel; bit for bit the chain that
  :func:`routed_chain_rmult` runs (one :func:`~.stream_gather.stream_gather`,
  K11, per routing pass, then K7 over the routed stream).
* grid stencil — the matrix-free shifted-slice pass (formats/stencil.py),
  plain torch ops as the JAX package's is plain XLA.
* HYB — the DIA part plus the CSR remainder; a ``ReorderedMatrix`` —
  its inner operator between two permutations.
* dense 2-D tensors — ``a @ x``; callables — ``a(x)``.
"""

from __future__ import annotations

from functools import singledispatch

import torch

from ..formats.csr import CSRMatrix
from ..formats.dia import DIAMatrix
from ..formats.ell import ELLMatrix
from ..formats.hyb import HYBMatrix
from ..formats.reorder import ReorderedMatrix
from ..formats.rsell import RoutedMatrix
from ..formats.stencil import GridStencilMatrix
from ..formats.wsell import WSellMatrix
from . import dia_spmv as _dia
from . import ell_spmv as _ell
from . import stream_gather as _stream
from . import wsell_spmv as _wsell

_FORMATS = (CSRMatrix, DIAMatrix, ELLMatrix, HYBMatrix, WSellMatrix, ReorderedMatrix,
            RoutedMatrix, GridStencilMatrix)

__all__ = ["rmult", "rmult_add", "rmult_sub", "matvec_fn", "as_operator", "row_sum",
           "routed_chain_rmult"]


def row_sum(vals: torch.Tensor, row_ptr: torch.Tensor) -> torch.Tensor:
    """The sum of each row's run ``vals[row_ptr[i]:row_ptr[i + 1]]`` (an
    ``(nnz,)`` vector or an ``(nnz, k)`` panel), in the entries' order; an
    empty row sums to 0.

    The same bits on every run: ``index_add_`` on a card adds with atomics,
    in an order that changes from run to run, so a solve over it does not
    repeat itself.  As a column, so that a card sums each row in one thread
    (the 1-D form takes a thread block per row, ~50x slower at 2M short
    rows, ``tools/dist_probe.py``).  ``row_ptr`` must be a valid row pointer
    (``row_ptr[0] == 0``, non-decreasing, ``row_ptr[-1] == nnz``): its
    constructors make it so, and checking it on every call would sync with the
    host (``unsafe``).
    """
    col = vals[:, None] if vals.ndim == 1 else vals
    out = torch.segment_reduce(col, "sum", offsets=row_ptr, axis=0, unsafe=True)
    return out[:, 0] if vals.ndim == 1 else out


def _bcast(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-entry coefficients shaped to broadcast against an (n,) or (n, k) x."""
    return v.reshape(v.shape + (1,) * (x.ndim - 1))


@singledispatch
def rmult(a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x (reference rMult, h:1501-1505) for a sparse matrix of the
    port's formats, a dense 2-D tensor, or a matvec callable."""
    if isinstance(a, torch.Tensor) and a.ndim == 2:
        return a @ x
    if callable(a):
        return a(x)
    raise TypeError(f"unsupported matrix type: {type(a).__name__}")


@rmult.register
def _rmult_csr(a: CSRMatrix, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(a.dtype, x.dtype)
    gathered = _bcast(a.data.to(dtype), x) * x.to(dtype).index_select(0, a.indices)
    return row_sum(gathered, a.indptr)


@rmult.register
def _rmult_dia(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    dtype = torch.promote_types(a.dtype, x.dtype)
    if not a.offsets:  # no stored diagonals: A == 0
        return torch.zeros((a.shape[0],) + tuple(x.shape[1:]), dtype=dtype,
                           device=x.device)
    if a.dtype != dtype:
        a = a.astype(dtype)
    x = x.to(dtype)
    if x.ndim == 1:
        return _dia.dia_spmv(a, x.contiguous())
    # several right-hand sides: one kernel launch per column
    return torch.stack([_dia.dia_spmv(a, x[:, j].contiguous())
                        for j in range(x.shape[1])], dim=1)


def _promoted(a, x: torch.Tensor):
    """``a`` and ``x`` in their common value type, x contiguous."""
    dtype = torch.promote_types(a.dtype, x.dtype)
    return (a if a.dtype == dtype else a.astype(dtype)), x.to(dtype).contiguous()


@rmult.register
def _rmult_ell(a: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    a, x = _promoted(a, x)
    if x.ndim == 1:
        return _ell.ell_spmv(a, x)
    return _ell.ell_spmm(a, x)


@rmult.register
def _rmult_wsell(a: WSellMatrix, x: torch.Tensor) -> torch.Tensor:
    a, x = _promoted(a, x)
    if x.ndim == 1:
        return _wsell.wsell_spmv(a, x)
    return _wsell.wsell_spmm(a, x)


@rmult.register
def _rmult_routed(a: RoutedMatrix, x: torch.Tensor) -> torch.Tensor:
    # one launch over the folded layout (formats/rsell.py:fold_chain)
    a, x = _promoted(a, x)
    if x.ndim == 1:
        return _wsell.routed_spmv(a, x)
    return _wsell.routed_spmm(a, x)


def routed_chain_rmult(a: RoutedMatrix, x: torch.Tensor) -> torch.Tensor:
    """The routed chain itself, as the JAX package runs it: one K11 launch
    per routing pass, then the final F-window W-SELL multiply-accumulate (K7)
    over the routed stream, whose length is the final layout's column count;
    a panel column by column.  The folded product's reference: ``rmult``
    does not call it."""
    if x.ndim != 1:
        return torch.stack([routed_chain_rmult(a, x[:, j]) for j in range(x.shape[1])], dim=1)
    a, t = _promoted(a, x)
    for p in a.passes:
        t = _stream.stream_gather(p.base, p.meta, p.vals, t, x_rows=p.x_rows,
                                  window_f=p.window_f)
    return _wsell.wsell_spmv(a.final, t)


@rmult.register
def _rmult_stencil(a: GridStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    return a.rmult(x)


@rmult.register
def _rmult_reordered(a: ReorderedMatrix, x: torch.Tensor) -> torch.Tensor:
    # acts as the original matrix: x into the permuted order and y back
    # (the solvers hoist both out of their loops, formats/reorder.py)
    return a.from_permuted(rmult(a.inner, a.to_permuted(x)))


@rmult.register
def _rmult_hyb(a: HYBMatrix, x: torch.Tensor) -> torch.Tensor:
    parts = [rmult(p, x) for p in (a.dia, a.rest) if p is not None]
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def rmult_add(a, lhs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = lhs + A @ x (reference rMultAdd, h:1507-1510)."""
    return lhs + rmult(a, x)


def rmult_sub(a, lhs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = lhs - A @ x (reference rMultSub, h:1512-1515)."""
    return lhs - rmult(a, x)


def as_operator(a):
    """Check that ``a`` is an operator the solvers take: a sparse matrix of
    the port's formats, a dense 2-D tensor, or a matvec callable."""
    if isinstance(a, _FORMATS) or callable(a):
        return a
    if isinstance(a, torch.Tensor) and a.ndim == 2:
        return a
    raise TypeError(f"unsupported matrix type: {type(a).__name__}")


def matvec_fn(a):
    """The solvers' matvec closure for any operator :func:`as_operator` takes."""
    if callable(a):
        return a
    return lambda x: rmult(a, x)
