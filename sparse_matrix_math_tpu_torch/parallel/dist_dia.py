"""Distributed DIA (stencil) matrices over the row mesh.

Port of ``sparse_matrix_math_tpu/parallel/dist_dia.py``.  Each rank owns a
contiguous row block of every diagonal; the multiplicand's halo is the
neighbour-window exchange (every ``|offset|`` at most the block size).  The
shard product is plain PyTorch, as in the JAX package (no kernel there
either), split into an INTERIOR part that reads only the rank's own x block
and so runs while the exchange is in flight, and a BOUNDARY part (the first
or last ``|offset|`` rows of each diagonal) that reads the neighbour blocks
once they have landed.

Exchange volume per SpMV: 2 x B elements per rank, whatever the rank count.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.dia import DIAMatrix
from ..solvers.types import SolveResult, resolve_max_iterations
from .dist import _RowBlocks, _block_rows, _host, _psum_dot, _run_core, _solve_vectors
from .mesh import ROW_AXIS, RowMesh, halo_start, put_sharded, resolve_mesh

__all__ = ["DistDIA", "distribute_dia", "dist_dia_spmv", "dist_dia_solve"]

# the cores with the standard signature (bicgstab given the identity
# preconditioner); chebyshev and pipelined CG go through dist_solve's CSR path
DIA_SOLVERS = ("cg", "bicg_symmetric", "cgs", "bicgstab")


@dataclasses.dataclass(frozen=True)
class DistDIA(_RowBlocks):
    """This rank's shard of a row-block-partitioned DIA matrix.

    ``diags`` is ``(ndiags, B)``: this rank's row block of each diagonal
    (rows beyond n zero-padded).  Vectors use the padded row blocks of
    parallel/dist.py (``distribute_vector``/``collect`` take it as is).
    """

    diags: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    block_rows: int
    nnz: int
    axis: str
    n_shards: int
    mesh: RowMesh

    @property
    def dtype(self) -> torch.dtype:
        return self.diags.dtype


def distribute_dia(
    dia: DIAMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistDIA:
    """Partition a DIA matrix into equal row blocks over ``mesh``.

    Requires ``max |offset| <= block`` so the neighbour window (one block
    left, one block right) covers every read.
    """
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, n_cols = dia.shape
    if n_rows != n_cols:
        raise ValueError(f"distribute_dia supports square systems only, got {dia.shape}")
    block = _block_rows(n_rows, n_dev)
    span = max(abs(o) for o in dia.offsets) if dia.offsets else 0
    if span > block:
        raise ValueError(
            f"diagonal offset {span} exceeds the row block {block}; "
            "the neighbor-window halo cannot cover it (fall back to "
            "distribute_csr in allgather mode)"
        )
    d = _host(dia.diags)
    lo = mesh.rank * block
    mine = np.zeros((d.shape[0], block), dtype=d.dtype)
    if lo < n_rows:
        mine[:, : min(block, n_rows - lo)] = d[:, lo:lo + block]
    return DistDIA(
        diags=put_sharded(mine, mesh, None),
        offsets=tuple(int(o) for o in dia.offsets),
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        nnz=dia.nnz,
        axis=axis,
        n_shards=int(n_dev),
        mesh=mesh,
    )


def _local_dia_spmv(diags, x_local, *, offsets, mesh: RowMesh, block_rows: int):
    """This shard's rows of ``A @ x``.

    Global row ``d*B + i`` reads ``window[B + i + off]`` of ``window =
    [left | own | right]``.  The interior term touches only ``own``, so it
    carries no dependency on the exchange posted before it; the boundary
    term completes y afterwards.
    """
    halo = halo_start(x_local, mesh)
    B = block_rows
    dtype = torch.promote_types(diags.dtype, x_local.dtype)
    y_int = torch.zeros(B, dtype=dtype, device=x_local.device)
    for d, off in enumerate(offsets):
        # interior: rows whose read i + off stays inside [0, B)
        if off >= 0:
            y_int[: B - off].addcmul_(diags[d, : B - off], x_local[off:])
        else:
            y_int[-off:].addcmul_(diags[d, -off:], x_local[: B + off])
    left, right = halo.wait()
    y_bnd = torch.zeros_like(y_int)
    for d, off in enumerate(offsets):
        # boundary: rows reading the left (i + off < 0) or right block
        if off < 0:
            y_bnd[:-off].addcmul_(diags[d, :-off], left[B + off:])
        elif off > 0:
            y_bnd[B - off:].addcmul_(diags[d, B - off:], right[:off])
    return y_int + y_bnd


def dist_dia_spmv(a: DistDIA, x, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of ``y = A @ x``; ``x`` is this rank's block (or a
    global host vector)."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    x_local, _ = _solve_vectors(a, x, None, mesh)
    return _local_dia_spmv(a.diags, x_local, offsets=a.offsets, mesh=mesh,
                           block_rows=a.block_rows)


def dist_dia_solve(
    a: DistDIA,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
) -> SolveResult:
    """Distributed Krylov solve on the DIA path: dist_solve's cores over the
    overlapped stencil SpMV above.  ``b``/``x0`` are global host vectors of
    logical length n (or padded) or this rank's blocks; the result's ``x``
    is this rank's block."""
    if solver not in DIA_SOLVERS:
        raise ValueError(
            f"dist_dia_solve supports cg/bicg_symmetric/cgs/bicgstab, got {solver!r}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    b_local, x0_local = _solve_vectors(a, b, x0, mesh)
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])

    def matvec(v):
        return _local_dia_spmv(a.diags, v, offsets=a.offsets, mesh=mesh,
                               block_rows=a.block_rows)

    return _run_core(solver, matvec, _psum_dot(mesh), mesh, b_local, x0_local,
                     float(epsilon), maxiter, bool(record_residuals))
