"""Row-partitioned distributed CSR: SpMV, preconditioners and Krylov solves.

Port of ``sparse_matrix_math_tpu/parallel/dist.py``.  Each rank of a
:class:`~.mesh.RowMesh` owns one contiguous block of ``block_rows`` rows:

* the matrix as this shard's padded nnz arrays (value, column id, local row
  id) — the rank's row of the JAX package's ``(P, L)`` arrays, and no other
  shard's;
* every vector as this rank's block of the zero-padded global vector;
* the SpMV as the JAX package computes it, in plain PyTorch ops (gather,
  then a sum by row): in ``halo`` mode the interior term reads only the
  rank's own block while the neighbour exchange is in flight, and the
  boundary term reads the ``[left | own | right]`` window; in ``allgather``
  mode the whole x is gathered first;
* every dot product a local ``torch.dot`` and one ``all_reduce``.

The solver cores of ``solvers/*.py`` run unchanged on each rank over these
``matvec`` and ``dotfn`` closures.  Every scalar a core reads on the host
comes from an all-reduced tensor, so every rank takes the same branch.

Padding keeps everything exact: padded rows have no nnz, padded vector
entries are 0 and padded nnz slots hold value 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.csr import CSRMatrix
from ..ops.spmv import row_sum
from ..precond.cheby_poly import widen_eig_bounds
from ..precond.preconditioners import (
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
)
from ..precond.trisolve import TriangularMatrix
from ..solvers.bicg_symmetric import bicg_symmetric_core
from ..solvers.bicgstab import bicgstab_core
from ..solvers.cg import cg_core, pcg_core
from ..solvers.cgs import cgs_core
from ..solvers.chebyshev import chebyshev_core
from ..solvers.gmres import gmres_core
from ..solvers.pipelined import cg_pipelined_core
from ..solvers.types import SolveResult, resolve_max_iterations
from .mesh import (
    ROW_AXIS,
    RowMesh,
    all_gather,
    all_reduce,
    gather_to_host,
    halo_start,
    put_sharded,
    resolve_mesh,
)

__all__ = [
    "DistCSR",
    "DistPreconditioner",
    "distribute_csr",
    "distribute_vector",
    "collect",
    "dist_spmv",
    "dist_solve",
    "dist_lanczos_extremal",
    "distribute_preconditioner",
]

_LANE = 128  # per-shard nnz padded to a multiple of this, as in the JAX package


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _block_rows(n_rows: int, n_dev: int, unit: int = 8) -> int:
    return max(_round_up(int(math.ceil(n_rows / n_dev)), unit), unit)


# -- distributed containers ---------------------------------------------------


class _RowBlocks:
    """What the row-block operands (DistCSR, DistDIA, DistStencil, DistWSell)
    share: ``n_shards`` blocks of ``block_rows`` rows over ``mesh``, and the
    way their vectors go to and from one global host vector, which
    ``utils/checkpoint.py`` takes to save and resume a distributed solve."""

    @property
    def padded_rows(self) -> int:
        return self.n_shards * self.block_rows

    def gather_vector(self, x_local: torch.Tensor) -> np.ndarray:
        """The global vector in its padded layout, on every rank."""
        return gather_to_host(x_local, self.mesh)

    def scatter_vector(self, x) -> torch.Tensor:
        """This rank's block of a global (logical or padded) host vector."""
        return distribute_vector(x, self)

    def write_once(self, write) -> None:
        """``write()`` on rank 0 alone; every rank returns once it is done."""
        if self.mesh.rank == 0:
            write()
        torch.distributed.barrier(group=self.mesh.group)


@dataclasses.dataclass(frozen=True)
class DistCSR(_RowBlocks):
    """This rank's shard of a row-block-partitioned CSR matrix.

    ``data``/``cols`` are the shard's padded nnz arrays (value, column id),
    sorted by row, and ``row_ptr`` the offset of each of the block's rows in
    them (``block_rows + 1`` entries, as a CSR ``indptr``); pad slots hold
    value 0 and belong to the shard's last row.  In halo mode they hold the
    INTERIOR entries (columns inside the rank's own block, ids local to it)
    and ``bdata``/``bcols``/``brow_ptr`` the BOUNDARY entries (columns in
    the neighbour blocks, ids window-local in ``[0, 3B)``); in allgather mode the columns are global and the
    boundary arrays are empty.  ``mesh`` is the mesh it was distributed
    over, and the solve-time default.
    """

    data: torch.Tensor
    cols: torch.Tensor
    row_ptr: torch.Tensor
    bdata: torch.Tensor
    bcols: torch.Tensor
    brow_ptr: torch.Tensor
    shape: Tuple[int, int]
    block_rows: int
    nnz: int
    axis: str
    n_shards: int
    mesh: RowMesh
    # "allgather": the SpMV gathers the full x (exact for any pattern).
    # "halo": every shard's columns fall inside its neighbour window
    #   [(d-1)B, (d+2)B), and only the two neighbour blocks are exchanged.
    mode: str = "allgather"

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def arrays(self):
        return (self.data, self.cols, self.row_ptr, self.bdata, self.bcols, self.brow_ptr)


def _pack_group(rows, local_cols, data, shard_of, *, n_dev, block, pad_col, shard):
    """Shard ``shard``'s row of the JAX package's padded ``(P, L)`` arrays
    for one group of row-sorted COO entries (columns already in the target
    index space), and the offset of each of its ``block`` rows in them (the
    pads belong to the last row); ``L`` comes from every shard's count."""
    seg_nnz = np.bincount(shard_of, minlength=n_dev) if rows.size else np.zeros(
        n_dev, np.int64)
    slots = max(_round_up(int(seg_nnz.max()) if rows.size else 0, _LANE), _LANE)
    mine = shard_of == shard
    k = int(seg_nnz[shard])
    v = np.zeros(slots, dtype=data.dtype)
    c = np.full(slots, pad_col, dtype=np.int64)
    lr = np.full(slots, block - 1, dtype=np.int64)
    v[:k] = data[mine]
    c[:k] = local_cols[mine]
    lr[:k] = rows[mine] - shard * block
    return v, c, np.concatenate([[0], np.cumsum(np.bincount(lr, minlength=block))])


def _pack_row_blocks(
    rows: np.ndarray,
    cols: np.ndarray,
    data: np.ndarray,
    *,
    n_dev: int,
    block: int,
    mode: str,
    shard: int,
):
    """Shard ``shard``'s padded arrays of row-sorted COO entries, and the mode.

    ``mode="auto"`` picks "halo" when every shard's columns fall within its
    neighbour window [(d-1)·B, (d+2)·B), else "allgather".  In halo mode the
    entries split into interior (ids local to the own block) and boundary
    (ids window-local in [0, 3B)) groups.  Every rank decides from the same
    host arrays, so the ranks agree on the mode.
    """
    shard_of = rows // block if rows.size else rows.astype(np.int64)

    if mode == "auto":
        lo_ok = cols >= (shard_of - 1) * block
        hi_ok = cols < (shard_of + 2) * block
        mode = "halo" if (rows.size == 0 or bool(np.all(lo_ok & hi_ok))) else "allgather"
    elif mode == "halo":
        if rows.size and not bool(
            np.all((cols >= (shard_of - 1) * block) & (cols < (shard_of + 2) * block))
        ):
            raise ValueError("matrix columns escape the neighbor window; halo mode invalid")
    elif mode != "allgather":
        raise ValueError(f"unknown mode {mode!r}; options: auto, halo, allgather")

    kw = dict(n_dev=n_dev, block=block, shard=shard)
    if mode == "halo":
        interior = (cols >= shard_of * block) & (cols < (shard_of + 1) * block)
        v, c, lr = _pack_group(rows[interior], (cols - shard_of * block)[interior],
                               data[interior], shard_of[interior], pad_col=0, **kw)
        bmask = ~interior
        bv, bc, blr = _pack_group(rows[bmask], (cols - (shard_of - 1) * block)[bmask],
                                  data[bmask], shard_of[bmask], pad_col=block, **kw)
        return v, c, lr, bv, bc, blr, mode

    v, c, lr = _pack_group(rows, cols, data, shard_of, pad_col=0, **kw)
    empty_i = np.zeros(0, dtype=np.int64)
    return v, c, lr, np.zeros(0, dtype=data.dtype), empty_i, empty_i.copy(), mode


def distribute_csr(
    csr: CSRMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
    mode: str = "auto",
) -> DistCSR:
    """Partition a CSR matrix into equal row blocks over ``mesh``.

    ``csr`` is the same global matrix on every rank (on any device); each
    rank keeps only its own shard, on the mesh's device.  ``mode``: "auto"
    (default) uses the neighbour-halo exchange when the sparsity pattern
    allows, "allgather"/"halo" force.
    """
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError(f"distribute_csr supports square systems only, got {csr.shape}")
    block = _block_rows(n_rows, n_dev)
    *arrays, mode = _pack_row_blocks(
        _host(csr.row_ids).astype(np.int64), _host(csr.indices).astype(np.int64),
        _host(csr.data), n_dev=n_dev, block=block, mode=mode, shard=mesh.rank,
    )
    data, cols, row_ptr, bdata, bcols, brow_ptr = (put_sharded(a, mesh, None) for a in arrays)
    return DistCSR(
        data=data, cols=cols, row_ptr=row_ptr, bdata=bdata, bcols=bcols, brow_ptr=brow_ptr,
        shape=(int(n_rows), int(n_cols)), block_rows=int(block), nnz=csr.nnz,
        axis=axis, n_shards=int(n_dev), mesh=mesh, mode=mode,
    )


def distribute_vector(x, dist, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of a length-n (or padded) host vector, zero-padded
    to the padded row count, on the mesh's device."""
    mesh = mesh if mesh is not None else dist.mesh
    x = _host(x)
    n_pad = dist.padded_rows
    if x.shape[0] != n_pad:
        x = np.concatenate([x, np.zeros(n_pad - x.shape[0], dtype=x.dtype)])
    return put_sharded(x, mesh, dist.axis)


def collect(x_local: torch.Tensor, dist) -> np.ndarray:
    """The unpadded global vector of the ranks' blocks, as a host array on
    every rank (an all-gather over the operand's mesh)."""
    return gather_to_host(x_local, dist.mesh)[: dist.shape[0]]


def _local_vector(v, a, mesh: RowMesh, dtype) -> torch.Tensor:
    """A vector argument as this rank's block in ``dtype``: a 1-D tensor of
    ``block_rows`` entries on the mesh's device already is one; anything
    else is a global host vector of logical or padded length."""
    if not (isinstance(v, torch.Tensor) and v.ndim == 1 and v.device == mesh.device
            and v.shape[0] == a.block_rows):
        v = distribute_vector(v, a, mesh)
    return v.to(dtype)


# -- local (per-shard) products -----------------------------------------------


def _local_spmv(data, cols, row_ptr, bdata, bcols, brow_ptr, x_local, *,
                mesh: RowMesh, mode: str = "allgather"):
    """This shard's rows of ``A @ x``: gather by column, then sum by row.

    mode="halo": the neighbour exchange is posted first; the interior term
    reads only ``x_local``, so it runs while the blocks travel, and the
    boundary term reads the ``[left | own | right]`` window once they have
    landed.  mode="allgather": the whole x is gathered first (exact for any
    pattern).
    """
    if mode == "halo":
        halo = halo_start(x_local, mesh)
        y = row_sum(data * x_local.index_select(0, cols), row_ptr)
        left, right = halo.wait()
        xg = torch.cat([left, x_local, right])
        return y + row_sum(bdata * xg.index_select(0, bcols), brow_ptr)
    xg = all_gather(x_local, mesh)
    return row_sum(data * xg.index_select(0, cols), row_ptr)


def _psum_dot(mesh: RowMesh):
    """The global inner product: a local ``torch.dot`` and one all-reduce."""

    def dotfn(u, v):
        return all_reduce(torch.dot(u, v), mesh)

    return dotfn


def _matvec(a: DistCSR, mesh: RowMesh):
    def matvec(v):
        return _local_spmv(*a.arrays, v, mesh=mesh, mode=a.mode)

    return matvec


# -- distributed preconditioners ----------------------------------------------


# Per-kind count of flat arrays: 7 per triangular factor, 1 per vector.
_TRI = 7
_PRE_LAYOUT = {
    "none": 0,
    "jacobi": 1,
    "sgs": 2 * _TRI + 1,   # forward factor, backward factor, D scale
    "ilu0": 2 * _TRI,      # lower factor, upper factor
    "ic0": 2 * _TRI,
}


@dataclasses.dataclass(frozen=True)
class DistPreconditioner:
    """Distributed preconditioner: a ``kind`` plus this rank's flat arrays.

    ``kind`` is one of none/jacobi/sgs/ilu0/ic0; a triangular apply runs as
    Jacobi sweeps, each one distributed strict SpMV.  The array count must
    match the kind (checked at construction).
    """

    kind: str
    arrays: Tuple[torch.Tensor, ...]
    statics: Tuple[int, ...]  # per-factor sweep counts

    def __post_init__(self):
        if self.kind not in _PRE_LAYOUT:
            raise ValueError(f"unknown distributed preconditioner kind {self.kind!r}")
        if len(self.arrays) != _PRE_LAYOUT[self.kind]:
            raise ValueError(f"{self.kind} preconditioner has {len(self.arrays)} arrays, "
                             f"expected {_PRE_LAYOUT[self.kind]}")


def _padded_block(values, dist: DistCSR, mesh: RowMesh, fill: float) -> torch.Tensor:
    values = _host(values)
    full = np.full(dist.padded_rows, fill, dtype=values.dtype)
    full[: dist.shape[0]] = values
    return put_sharded(full, mesh, dist.axis)


def _distribute_triangular(tri: TriangularMatrix, dist: DistCSR, mesh: RowMesh):
    """A TriangularMatrix's strict part in the matrix's row-block format and
    exchange mode (the factor's pattern is a subset of A's, so halo
    feasibility carries over): the shard's 6 arrays and this rank's block of
    the diagonal (pad 1.0), and the factor's sweep count."""
    *arrays, _ = _pack_row_blocks(
        _host(tri.row_ids).astype(np.int64), _host(tri.indices).astype(np.int64),
        _host(tri.data), n_dev=mesh.size, block=dist.block_rows, mode=dist.mode,
        shard=mesh.rank,
    )
    flat = tuple(put_sharded(a, mesh, None) for a in arrays)
    sweeps = tri.sweeps if tri.method != "dense" else tri.depth
    return flat + (_padded_block(tri.diag, dist, mesh, 1.0),), sweeps


def distribute_preconditioner(
    precond, dist: DistCSR, mesh: Optional[RowMesh] = None
) -> DistPreconditioner:
    """Re-lay a single-device preconditioner's factors over the mesh.

    Identity/Jacobi shard trivially; SGS/ILU0/IC0 triangular applies
    become distributed Jacobi sweeps (exact once the sweep count reaches
    the factor's level-schedule depth).
    """
    mesh = resolve_mesh(mesh, dist, n_shards=dist.n_shards, axis=dist.axis)
    if precond is None or isinstance(precond, IdentityPreconditioner):
        return DistPreconditioner(kind="none", arrays=(), statics=())
    if isinstance(precond, JacobiPreconditioner):
        return DistPreconditioner(
            kind="jacobi", arrays=(_padded_block(precond.inv_diag, dist, mesh, 1.0),),
            statics=())
    if isinstance(precond, SGSPreconditioner):
        fwd, fs = _distribute_triangular(precond.fwd, dist, mesh)
        bwd, bs = _distribute_triangular(precond.bwd, dist, mesh)
        return DistPreconditioner(
            kind="sgs", arrays=fwd + bwd + (_padded_block(precond.diag, dist, mesh, 0.0),),
            statics=(fs, bs))
    if isinstance(precond, (ILU0Preconditioner, IC0Preconditioner)):
        lo, ls = _distribute_triangular(precond.lower, dist, mesh)
        up, us = _distribute_triangular(precond.upper, dist, mesh)
        return DistPreconditioner(
            kind="ilu0" if isinstance(precond, ILU0Preconditioner) else "ic0",
            arrays=lo + up, statics=(ls, us))
    raise TypeError(f"cannot distribute preconditioner {type(precond).__name__}")


def _local_tri_solve(tri7, b_local, *, mesh, sweeps, mode="allgather"):
    """Distributed triangular solve by Jacobi sweeps,
    ``x_{k+1} = (b - N x_k) / d`` with N the strict part (exact once the
    sweep count reaches the factor's dependency depth)."""
    *strict, inv_d = tri7
    x = b_local * inv_d
    for _ in range(max(sweeps - 1, 0)):
        nx = _local_spmv(*strict, x, mesh=mesh, mode=mode)
        x = (b_local - nx) * inv_d
    return x


def _build_local_precond_apply(kind, arrays, statics, *, mesh, mode="allgather"):
    """This rank's ``apply`` closure (the diagonals inverted once here)."""
    if kind == "none":
        return lambda r: r
    if kind == "jacobi":
        (inv_diag,) = arrays
        return lambda r: r * inv_diag

    def factor(seven):
        return (*seven[:6], 1.0 / seven[6])

    first, second = factor(arrays[:_TRI]), factor(arrays[_TRI:2 * _TRI])
    s1, s2 = statics
    kw = dict(mesh=mesh, mode=mode)
    if kind == "sgs":
        dscale = arrays[2 * _TRI]

        def apply_sgs(r):
            y = _local_tri_solve(first, r, sweeps=s1, **kw)
            return _local_tri_solve(second, dscale * y, sweeps=s2, **kw)

        return apply_sgs
    if kind in ("ilu0", "ic0"):

        def apply_lu(r):
            return _local_tri_solve(second, _local_tri_solve(first, r, sweeps=s1, **kw),
                                    sweeps=s2, **kw)

        return apply_lu
    raise ValueError(f"unknown distributed preconditioner kind {kind!r}")


# -- public distributed ops ---------------------------------------------------


def dist_spmv(a: DistCSR, x, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """This rank's block of ``y = A @ x``; ``x`` is this rank's block (or a
    global host vector)."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    return _matvec(a, mesh)(_local_vector(x, a, mesh, a.dtype))


_CORES = {
    "cg": cg_core,
    "bicg_symmetric": bicg_symmetric_core,
    "cgs": cgs_core,
    "bicgstab": bicgstab_core,
    "chebyshev": chebyshev_core,  # dot-free between checks
    "cg_pipelined": cg_pipelined_core,  # one fused all-reduce per iteration
    "gmres": gmres_core,  # the panel contraction all-reduces over the rows
}

def _run_core(solver, matvec, dotfn, mesh, b_local, x0_local, epsilon, maxiter, record, *,
              precond=None, cheb=None, gmres_m=None) -> SolveResult:
    """One rank's part of a distributed solve: the single-device core of
    ``solver`` over the distributed ``matvec`` and ``dotfn``."""
    if solver == "cg":
        if precond is None:
            return cg_core(matvec, dotfn, b_local, x0_local, epsilon, maxiter, record)
        return pcg_core(matvec, precond, dotfn, b_local, x0_local, epsilon, maxiter, record)
    apply_ = precond if precond is not None else (lambda v: v)
    if solver == "bicgstab":
        return bicgstab_core(matvec, apply_, dotfn, b_local, x0_local, epsilon, maxiter,
                             record)
    if solver == "cg_pipelined":

        def dot2(u1, v1, u2, v2):
            both = all_reduce(torch.stack([torch.dot(u1, v1), torch.dot(u2, v2)]), mesh)
            return both[0], both[1]  # ONE collective for both

        return cg_pipelined_core(matvec, dot2, b_local, x0_local, epsilon, maxiter, record)
    if solver == "chebyshev":
        lmin, lmax, check_every = cheb
        return chebyshev_core(matvec, dotfn, b_local, x0_local, epsilon, lmin, lmax,
                              maxiter, check_every, record)
    if solver == "gmres":
        # (m+1, n_local) @ (n_local,) is this shard's part of the panel
        # contraction: ONE all-reduce completes all of a step's Arnoldi dots
        return gmres_core(matvec, apply_, dotfn, lambda V, w: all_reduce(V @ w, mesh),
                          b_local, x0_local, epsilon, gmres_m, maxiter, record)
    return _CORES[solver](matvec, dotfn, b_local, x0_local, epsilon, maxiter, record)


def _solve_vectors(a, b, x0, mesh):
    b_local = _local_vector(b, a, mesh, a.dtype)
    x0_local = (torch.zeros_like(b_local) if x0 is None
                else _local_vector(x0, a, mesh, a.dtype))
    return b_local, x0_local


def dist_lanczos_extremal(a: DistCSR, mesh: Optional[RowMesh] = None, k: int = 32,
                          seed: int = 0):
    """Extremal-eigenvalue estimate by ``k`` distributed Lanczos steps,
    used to bound distributed Chebyshev.  Every dot is an all-reduce; the
    ``(k,)`` tridiagonal coefficients come to the host once, for the dense
    eigensolve.  The start vector is the JAX package's (NumPy, over the
    padded rows)."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    np_dtype = torch.empty((), dtype=a.dtype).numpy().dtype
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(a.padded_rows).astype(np_dtype)
    v[a.shape[0]:] = 0.0
    v = distribute_vector(v / np.linalg.norm(v), a, mesh)
    matvec, dotfn = _matvec(a, mesh), _psum_dot(mesh)
    v_prev, beta = torch.zeros_like(v), torch.zeros((), dtype=v.dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(int(k)):
        w = matvec(v) - beta * v_prev
        alpha = dotfn(w, v)
        w = w - alpha * v
        new_beta = torch.sqrt(dotfn(w, w))
        v_prev, v = v, w / torch.clamp(new_beta, min=1e-30)
        beta = new_beta
        alphas.append(alpha)
        betas.append(new_beta)
    al = torch.stack(alphas).to(torch.float64).cpu().numpy()
    be = torch.stack(betas).to(torch.float64).cpu().numpy()
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    eig = np.linalg.eigvalsh(t)
    return float(eig[0]), float(eig[-1])


def dist_solve(
    a: DistCSR,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "cg",
    preconditioner: Optional[DistPreconditioner] = None,
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
    eig_bounds=None,
    check_every: int = 10,
    restart: int = 32,
) -> SolveResult:
    """Distributed Krylov solve over the row mesh.

    Runs the single-device core of the same name (solvers/*.py) on every
    rank: the SpMV exchanges x as the operand's mode says, and every dot is
    a local partial plus an all-reduce.  ``b``/``x0`` may be global host
    vectors of logical length n (or padded), or this rank's blocks.

    The result's ``x`` is this rank's block of the padded solution; use
    :func:`collect` for the global vector.  ``status``, ``iterations``,
    ``residual_norm`` (the true residual) and ``floor_hit`` are the same on
    every rank.
    """
    if solver not in _CORES:
        raise ValueError(f"unknown solver {solver!r}; options: {sorted(_CORES)}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    if preconditioner is not None and solver not in ("cg", "bicgstab", "gmres"):
        raise ValueError("preconditioning is supported for cg, bicgstab, and gmres")
    pre = preconditioner or DistPreconditioner(kind="none", arrays=(), statics=())
    b_local, x0_local = _solve_vectors(a, b, x0, mesh)
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])

    if solver == "chebyshev" and eig_bounds is None:
        eig_bounds = widen_eig_bounds(*dist_lanczos_extremal(a, mesh, k=min(32, a.shape[0])))
    cheb = ((float(eig_bounds[0]), float(eig_bounds[1]), int(check_every))
            if solver == "chebyshev" else None)
    gmres_m = min(max(int(restart), 1), a.shape[0]) if solver == "gmres" else None
    precond = None
    if pre.kind != "none":
        precond = _build_local_precond_apply(pre.kind, pre.arrays, pre.statics, mesh=mesh,
                                             mode=a.mode)
    return _run_core(solver, _matvec(a, mesh), _psum_dot(mesh), mesh, b_local, x0_local,
                     float(epsilon), maxiter, bool(record_residuals), precond=precond,
                     cheb=cheb, gmres_m=gmres_m)
