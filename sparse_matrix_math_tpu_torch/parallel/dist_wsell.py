"""Distributed W-SELL: the general-pattern kernel in every shard.

Port of ``sparse_matrix_math_tpu/parallel/dist_wsell.py``.  Rows partition
into per-rank blocks of a multiple of the 1024-row W-SELL slab.  Every
shard's columns must fall inside its neighbour window ``[(d-1)B, (d+2)B)``
(DistCSR's halo precondition); rewritten window-local, each rank's rows are
an ordinary ``(B, 3B)`` W-SELL matrix whose x is the exchanged ``[left |
own | right]`` window.  Each rank builds only its own matrix (the layout code
of formats/wsell.py:wsell_from_csr, at the JAX package's ``nway=4``,
``nway_min_gain=0.0``, no per-shard ratio cap), and its shard product is
K7: ops/wsell_spmv.py:wsell_spmv, ``csrc/sell_spmv.cu:sell_kernel`` over the
matrix's SELL-32 layout on a CUDA device (its plain version on the CPU).

The JAX package stacks the shards' planes to one vreg count for one
``shard_map``; here each rank launches its own kernel on its own matrix, so
no common count is needed.  The global padding check reduces the ranks'
slot counts, so every rank takes the same decision.  ``_mesh_interpret``
(``dist_wsell.py:170-176``, Pallas interpret mode on a CPU mesh) is a TPU
mechanism with no counterpart here.

Patterns that escape the neighbour window take
``distribute_csr(mode="allgather")`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..formats.wsell import SLAB, WSellMatrix, _wsell_from_coo
from ..ops.wsell_spmv import wsell_spmv
from ..solvers.types import SolveResult, resolve_max_iterations
from .dist import _RowBlocks, _block_rows, _host, _psum_dot, _run_core, _solve_vectors
from .dist_dia import DIA_SOLVERS
from .mesh import ROW_AXIS, RowMesh, all_reduce, halo_exchange, resolve_mesh

__all__ = ["DistWSell", "distribute_wsell", "dist_wsell_spmv", "dist_wsell_solve"]

WSELL_SOLVERS = DIA_SOLVERS + ("gmres",)


@dataclasses.dataclass(frozen=True)
class DistWSell(_RowBlocks):
    """This rank's shard of a row-block-partitioned W-SELL matrix: ``local``
    is its ``(B, 3B)`` window matrix on the mesh's device."""

    local: WSellMatrix
    shape: Tuple[int, int]
    block_rows: int
    n_slabs: int
    x_rows: int
    nnz: int
    slot_ratio: float  # the global one: every shard's slots over the nnz
    axis: str
    n_shards: int
    mesh: RowMesh
    nway: int = 4  # uniform bounded-reduction width (formats/wsell.py)

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def distribute_wsell(
    csr: CSRMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
    max_slot_ratio: float = 8.0,
) -> DistWSell:
    """Partition a CSR matrix into per-rank W-SELL blocks over ``mesh``.

    Requires the neighbour-window (banded) property; raises ValueError
    otherwise (fall back to distribute_csr allgather mode), and when the
    shards' slots over the matrix's nnz exceed ``max_slot_ratio``.
    """
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError(f"distribute_wsell supports square systems only, got {csr.shape}")
    block = _block_rows(n_rows, n_dev, SLAB)

    r = _host(csr.row_ids).astype(np.int64)
    c = _host(csr.indices).astype(np.int64)
    v = _host(csr.data)
    shard_of = r // block
    if r.size and not bool(np.all((c >= (shard_of - 1) * block) & (c < (shard_of + 2) * block))):
        raise ValueError(
            "matrix columns escape the neighbor window; use "
            "distribute_csr(mode='allgather') for long-range patterns"
        )

    d = mesh.rank
    sel = shard_of == d
    # per-shard caps are meaningless (boundary and empty shards hold few nnz
    # by construction): the padding cap applies to the whole matrix below
    local = _wsell_from_coo(
        r[sel] - d * block, c[sel] - (d - 1) * block, v[sel], (block, 3 * block),
        int(sel.sum()), device=mesh.device, max_slot_ratio=float("inf"), nway=4,
        nway_min_gain=0.0,
    )
    slots = torch.tensor([local.vals.shape[0] * local.vals.shape[1]], dtype=torch.int64,
                         device=mesh.device)
    total_slots = int(all_reduce(slots, mesh).item())
    global_ratio = total_slots / max(csr.nnz, 1)
    if global_ratio > max_slot_ratio:
        raise ValueError(
            f"W-SELL padding too high for this pattern: {global_ratio:.1f} "
            f"slots/nnz (> {max_slot_ratio}) — use distribute_csr instead"
        )
    return DistWSell(
        local=local,
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        n_slabs=int(local.n_slabs),
        x_rows=int(local.x_rows),
        nnz=csr.nnz,
        slot_ratio=float(global_ratio),
        axis=axis,
        n_shards=int(n_dev),
        mesh=mesh,
        nway=int(local.nway),
    )


def _local_wsell_spmv(local: WSellMatrix, x_local, *, mesh: RowMesh):
    """This shard's rows of ``A @ x``: the neighbour exchange, then K7 over
    the ``[left | own | right]`` window."""
    left, right = halo_exchange(x_local, mesh)
    return wsell_spmv(local, torch.cat([left, x_local, right]))


def dist_wsell_spmv(a: DistWSell, x, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of ``y = A @ x``; ``x`` is this rank's block (or a
    global host vector)."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    x_local, _ = _solve_vectors(a, x, None, mesh)
    return _local_wsell_spmv(a.local, x_local, mesh=mesh)


def dist_wsell_solve(
    a: DistWSell,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
    restart: int = 32,
) -> SolveResult:
    """Distributed Krylov solve on the general-pattern W-SELL path (the
    cores of dist_solve; all-reduced dots, neighbour-window exchange, K7 for
    every product)."""
    if solver not in WSELL_SOLVERS:
        raise ValueError(
            f"dist_wsell_solve supports cg/bicg_symmetric/cgs/bicgstab/gmres, got {solver!r}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    b_local, x0_local = _solve_vectors(a, b, x0, mesh)
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])

    def matvec(v):
        return _local_wsell_spmv(a.local, v, mesh=mesh)

    return _run_core(solver, matvec, _psum_dot(mesh), mesh, b_local, x0_local,
                     float(epsilon), maxiter, bool(record_residuals),
                     gmres_m=min(max(int(restart), 1), a.shape[0]))
