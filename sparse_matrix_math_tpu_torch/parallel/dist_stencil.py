"""Distributed matrix-free grid stencils: no matrix data on any rank.

Port of ``sparse_matrix_math_tpu/parallel/dist_stencil.py``, the distributed
twin of formats/stencil.py:GridStencilMatrix with parallel/dist_dia.py's row
partition and neighbour-window exchange.  Each rank owns a contiguous block
of the flattened grid vector and the ``(npoints,)`` coefficients; the
boundary cuts come from global index arithmetic (the rank's first row plus
``arange``, integer division and remainder).

The product keeps dist_dia's interior/boundary split: the interior term
reads only the rank's own block while the exchange is in flight.  A solve
works the masks out once (eager PyTorch would otherwise repeat a dozen
integer passes over the block on every product).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..formats.stencil import GridStencilMatrix, _strides
from ..solvers.types import SolveResult, resolve_max_iterations
from .dist import _RowBlocks, _block_rows, _host, _psum_dot, _run_core, _solve_vectors
from .dist_dia import DIA_SOLVERS
from .mesh import ROW_AXIS, RowMesh, halo_start, put_sharded, resolve_mesh

__all__ = ["DistStencil", "distribute_stencil", "dist_stencil_spmv", "dist_stencil_solve"]


@dataclasses.dataclass(frozen=True)
class DistStencil(_RowBlocks):
    """A row-block-partitioned grid stencil (no per-rank matrix data).

    ``block_rows``/``padded_rows``/``axis``/``shape`` follow DistDIA's, so
    ``distribute_vector``/``collect`` take it as is.
    """

    coeffs: torch.Tensor  # (npoints,), on every rank
    doffs: Tuple[Tuple[int, ...], ...]
    dims: Tuple[int, ...]
    shape: Tuple[int, int]
    block_rows: int
    n_shards: int
    nnz: int
    axis: str
    mesh: RowMesh

    @property
    def dtype(self) -> torch.dtype:
        return self.coeffs.dtype


def _flat_offsets(doffs, dims):
    s = _strides(dims)
    return tuple(sum(c * st for c, st in zip(off, s)) for off in doffs)


def distribute_stencil(
    st: GridStencilMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistStencil:
    """Row-partition a grid stencil over ``mesh``.

    Requires every |flat offset| <= block (the one-neighbour window).
    """
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, _ = st.shape
    block = _block_rows(n_rows, n_dev)
    span = max((abs(o) for o in _flat_offsets(st.doffs, st.dims)), default=0)
    if span > block:
        raise ValueError(
            f"stencil flat offset {span} exceeds the row block {block}; "
            "use distribute_csr in allgather mode"
        )
    return DistStencil(
        coeffs=put_sharded(_host(st.coeffs), mesh, None),
        doffs=tuple(tuple(int(c) for c in off) for off in st.doffs),
        dims=tuple(int(d) for d in st.dims),
        shape=tuple(int(s) for s in st.shape),
        block_rows=int(block),
        n_shards=int(n_dev),
        nnz=int(st.nnz),
        axis=axis,
        mesh=mesh,
    )


def _row_masks(a: DistStencil, mesh: RowMesh):
    """Per stencil point, this rank's rows of the grid whose neighbour at
    that point is on the grid too (the padded tail's rows, past n, in
    none), from the rank's global row ids."""
    strides = _strides(a.dims)
    gi = mesh.rank * a.block_rows + torch.arange(a.block_rows, device=mesh.device)
    coords = [gi // strides[0]] + [(gi // strides[ax]) % a.dims[ax]
                                   for ax in range(1, len(a.dims))]
    out = []
    for comp in a.doffs:
        mask = gi < a.shape[0]
        for ax, c in enumerate(coords):
            v = c + comp[ax]
            mask = mask & (v >= 0) & (v < a.dims[ax])
        out.append(mask)
    return out


def _local_stencil_spmv(coeffs, x_local, *, masks, flat_offs, mesh: RowMesh,
                        block_rows: int):
    """This shard's rows of ``A @ x``, matrix-free.

    The window structure of dist_dia._local_dia_spmv, with each point's
    rows taken from ``masks`` (:func:`_row_masks`) instead of stored
    diagonals: point ``(c, comp)`` at flat offset ``off`` adds ``c * x[g +
    off]`` to row g iff every grid coordinate of g stays on the grid after
    adding ``comp``.
    """
    halo = halo_start(x_local, mesh)
    B = block_rows
    dtype = torch.promote_types(coeffs.dtype, x_local.dtype)
    zero = torch.zeros((), dtype=x_local.dtype, device=x_local.device)
    y_int = torch.zeros(B, dtype=dtype, device=x_local.device)
    for k, off in enumerate(flat_offs):
        c, m = coeffs[k], masks[k]
        if off >= 0:
            y_int[: B - off] += c * torch.where(m[: B - off], x_local[off:], zero)
        else:
            y_int[-off:] += c * torch.where(m[-off:], x_local[: B + off], zero)
    left, right = halo.wait()
    y_bnd = torch.zeros_like(y_int)
    for k, off in enumerate(flat_offs):
        c, m = coeffs[k], masks[k]
        if off < 0:
            y_bnd[:-off] += c * torch.where(m[:-off], left[B + off:], zero)
        elif off > 0:
            y_bnd[B - off:] += c * torch.where(m[B - off:], right[:off], zero)
    return y_int + y_bnd


def _matvec(a: DistStencil, mesh: RowMesh):
    """The shard product; the row masks are worked out once, here."""
    masks, flat_offs = _row_masks(a, mesh), _flat_offsets(a.doffs, a.dims)

    def matvec(v):
        return _local_stencil_spmv(a.coeffs, v, masks=masks, flat_offs=flat_offs,
                                   mesh=mesh, block_rows=a.block_rows)

    return matvec


def dist_stencil_spmv(a: DistStencil, x, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of ``y = A @ x`` for a row-partitioned stencil."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    x_local, _ = _solve_vectors(a, x, None, mesh)
    return _matvec(a, mesh)(x_local)


def dist_stencil_solve(
    a: DistStencil,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
) -> SolveResult:
    """Distributed Krylov solve on the matrix-free stencil path (the cores
    and conventions of dist_dia_solve)."""
    if solver not in DIA_SOLVERS:
        raise ValueError(
            f"dist_stencil_solve supports cg/bicg_symmetric/cgs/bicgstab, got {solver!r}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    b_local, x0_local = _solve_vectors(a, b, x0, mesh)
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])
    return _run_core(solver, _matvec(a, mesh), _psum_dot(mesh), mesh, b_local, x0_local,
                     float(epsilon), maxiter, bool(record_residuals))
