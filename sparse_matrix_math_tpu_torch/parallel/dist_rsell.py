"""Distributed R-SELL: the routed zero-locality chain in every shard.

Port of ``sparse_matrix_math_tpu/parallel/dist_rsell.py``.  DistWSell
(parallel/dist_wsell.py) needs the neighbour-window property; a long-range
pattern otherwise takes ``distribute_csr(mode="allgather")``, whose shard
product is a plain gather and row sum.  Here every rank runs the routed
chain of formats/rsell.py over its own row block instead:

* rows partition into per-rank blocks of a multiple of the 1024-row slab;
  each rank builds only its own chain, over its ``(B, P*B)`` rows with
  full-width columns (routing is a per-row-block transformation, so the
  shards' layouts do not depend on each other);
* the communication is one all-gather of x per product (a zero-locality
  pattern reads everywhere: the volume DistCSR's allgather mode moves);
* the shard product is ``ops/spmv.py``'s routed product over the gathered
  x: one launch of ``csrc/sell_spmv.cu:sell_kernel`` over the shard's chain
  folded into its final layout (``ops/wsell_spmv.py:routed_spmv``; the fold
  runs the chain once per shard at build, one K11 launch per routing pass,
  ``csrc/stream_gather.cu:stream_gather_kernel``) on a CUDA device; its
  plain version on the CPU;
* the build pins one global mixed-radix plan and leaf width for every
  shard (``_plan_digits`` from the global n and nnz), the final pass at
  ``nway`` 4 with no gain threshold, as the JAX package does
  (``dist_rsell.py:124-150``), so every rank's chain is the JAX package's
  chain of that shard and has the same pass count;
* the slot-ratio cap applies to the global slot total, taken with one
  all-reduce at build, so every rank raises or none does.

The JAX package pads every pass's planes to the shards' largest and stacks
them (``pad_stack``, ``chunk_for``, ``dist_rsell.py:166-218``) because one
``shard_map`` needs one shape; here each rank launches its own kernels on
its own chain, so no pass is padded.  A rank whose block holds no rows (the
last of 4 at n = 6144) builds an empty chain, launches nothing for its
passes and returns zeros.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix, _csr_from_sorted
from ..formats.rsell import RoutedMatrix, _plan_digits, routed_from_csr
from ..formats.wsell import LANE, SLAB, _round_up
from ..ops.spmv import rmult
from ..solvers.types import SolveResult, resolve_max_iterations
from .dist import _RowBlocks, _host, _psum_dot, _run_core, _solve_vectors
from .mesh import ROW_AXIS, RowMesh, all_gather, all_reduce, resolve_mesh

__all__ = ["DistRouted", "distribute_routed", "dist_routed_spmv", "dist_routed_solve"]

ROUTED_SOLVERS = ("cg", "bicg_symmetric", "cgs", "bicgstab", "gmres")


@dataclasses.dataclass(frozen=True)
class DistRouted(_RowBlocks):
    """This rank's shard of a row-block-partitioned routed matrix: ``local``
    is its ``(B, P*B)`` chain on the mesh's device."""

    local: RoutedMatrix
    shape: Tuple[int, int]
    block_rows: int
    n_passes: int
    window_f: int
    nnz: int
    slot_ratio: float  # the global one: every shard's slots over the nnz
    axis: str
    n_shards: int
    mesh: RowMesh
    final_nway: int = 4  # the final pass's bounded-reduction width, every shard

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype


def distribute_routed(
    csr: CSRMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
    window_f: int = 16,
    max_slot_ratio: float = 16.0,
) -> DistRouted:
    """Partition a CSR matrix into per-rank routed chains over ``mesh``.

    Any pattern (no neighbour-window condition).  Raises ValueError on every
    rank when the shards' slots over the matrix's nnz exceed
    ``max_slot_ratio``.
    """
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError(f"distribute_routed supports square systems only, got {csr.shape}")
    block = max(_round_up(int(math.ceil(n_rows / n_dev)), SLAB), SLAB)
    padded_cols = n_dev * block  # the all-gathered x's length

    r = _host(csr.row_ids).astype(np.int64)
    c = _host(csr.indices).astype(np.int64)
    v = _host(csr.data)

    # one global chain plan: the same leaf width and mixed-radix digits for
    # every shard, so every chain has the same pass count
    n_slabs_local = block // SLAB
    span = 8 * window_f * LANE
    per_slab = max(csr.nnz / max(n_rows // SLAB, 1), 1.0)
    leaf_slabs = min(max(int(0.6 * span / (per_slab * 1.35)), 1), n_slabs_local)
    n_leaves = -(-n_slabs_local // leaf_slabs)
    digits = tuple(_plan_digits(padded_cols, max(csr.nnz // n_dev, 1), n_leaves, window_f))

    d = mesh.rank
    sel = (r // block) == d
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)  # noqa: E731
    local_csr = _csr_from_sorted(t(r[sel] - d * block), t(c[sel]), t(v[sel]),
                                 (block, padded_cols))
    local = routed_from_csr(local_csr, window_f=window_f, max_slot_ratio=float("inf"),
                            leaf_slabs=leaf_slabs, _digits=digits, final_nway=4,
                            _final_nway_min_gain=0.0)

    slots = sum(p.out_len for p in local.passes) + local.final.n_vregs * SLAB
    total_slots = int(all_reduce(torch.tensor([slots], dtype=torch.int64,
                                              device=mesh.device), mesh).item())
    global_ratio = total_slots / max(csr.nnz, 1)
    if global_ratio > max_slot_ratio:
        raise ValueError(f"R-SELL routing pads too high for this pattern: "
                         f"{global_ratio:.1f} slots/nnz (> {max_slot_ratio})")
    return DistRouted(
        local=local,
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        n_passes=len(local.passes),
        window_f=int(window_f),
        nnz=csr.nnz,
        slot_ratio=float(global_ratio),
        axis=axis,
        n_shards=int(n_dev),
        mesh=mesh,
        final_nway=int(local.final.nway),
    )


def _local_routed_spmv(local: RoutedMatrix, x_local, *, mesh: RowMesh):
    """This shard's rows of ``A @ x``: the all-gather of x, then one launch
    over the folded chain."""
    return rmult(local, all_gather(x_local, mesh))


def dist_routed_spmv(a: DistRouted, x, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of ``y = A @ x``; ``x`` is this rank's block (or a
    global host vector)."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    x_local, _ = _solve_vectors(a, x, None, mesh)
    return _local_routed_spmv(a.local, x_local, mesh=mesh)


def dist_routed_solve(
    a: DistRouted,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "bicgstab",
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
    restart: int = 32,
) -> SolveResult:
    """Distributed Krylov solve on the routed path: dist_solve's cores over
    the shard chains (all-reduced dots, one all-gather of x per product;
    GMRES's panel dot one all-reduce of ``V @ w``).  The result's ``x`` is
    this rank's block."""
    if solver not in ROUTED_SOLVERS:
        raise ValueError(
            f"dist_routed_solve supports cg/bicg_symmetric/cgs/bicgstab/gmres, got {solver!r}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    b_local, x0_local = _solve_vectors(a, b, x0, mesh)
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])

    def matvec(v):
        return _local_routed_spmv(a.local, v, mesh=mesh)

    return _run_core(solver, matvec, _psum_dot(mesh), mesh, b_local, x0_local,
                     float(epsilon), maxiter, bool(record_residuals),
                     gmres_m=min(max(int(restart), 1), a.shape[0]))
