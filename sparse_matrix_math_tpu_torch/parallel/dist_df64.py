"""Distributed double-word f64: the 1e-8 contract over the row mesh.

Port of ``sparse_matrix_math_tpu/parallel/dist_df64.py``.  On one device
the f64 accuracy bar is carried by double-word f32 (ops/df32.py) and made
cheap by iterative refinement (solvers/ir_df64.py); this module runs both
over the 1-D row mesh:

* :class:`DistDfDia` holds this rank's row block of the (hi, lo) diagonal
  planes, as DistDIA (parallel/dist_dia.py) holds its diagonals.  The
  double-word product sends both x words in one ``(2, B)`` payload per
  direction through the wrapping neighbour exchange (``mesh.halo_start``:
  as many messages as the f32 product, twice the bytes), and keeps the
  interior and boundary accumulators apart, so the interior terms run while
  the exchange is in flight.  It is plain PyTorch built from ops/df32.py's
  error-free transforms, as the JAX package's is plain ``jnp``
  (``_local_df_dia_spmv``, ``dist_dia.py``-style rolls and masks).
* A double-word sum over ranks (:func:`_df_allreduce`) all-gathers the P
  (hi, lo) partials and adds them in rank order with ops/df32.py's pairwise
  tree on every rank: the same bits everywhere, error ~log2(P) 2^-47.  An
  ``all_reduce(SUM)`` of the words would round the sum to 2^-24, in an order
  of the backend's choosing.
* :func:`dist_cg_ir_df64` / :func:`dist_bicgstab_ir_df64` run the refinement
  loop of the single-device solvers (solvers/ir_df64.py:ir_df_core): the
  double-word true residual judges convergence, and the f32 correction
  solves run on the hi operator through dist_dia's shard product with
  all-reduced dots.  The rounds are driven from the host on all-reduced
  values only, so every rank takes the same branch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.df32 import (
    DfDiaMatrix,
    _df_pairwise_reduce,
    _fast_two_sum,
    df_add,
    df_norm2,
    df_sub,
    two_prod,
)
from ..solvers.df64 import DfSolveResult
from ..solvers.ir_df64 import ir_df_core
from ..solvers.types import resolve_max_iterations
from .dist import _RowBlocks, _block_rows, _host, _psum_dot
from .dist_dia import _local_dia_spmv
from .mesh import ROW_AXIS, RowMesh, all_gather, halo_start, put_sharded, resolve_mesh

__all__ = [
    "DistDfDia",
    "distribute_df_dia",
    "dist_df_dia_spmv",
    "dist_cg_ir_df64",
    "dist_bicgstab_ir_df64",
]


@dataclasses.dataclass(frozen=True)
class DistDfDia(_RowBlocks):
    """This rank's shard of a row-block-partitioned double-word DIA matrix:
    ``diags_hi``/``diags_lo`` are ``(ndiags, B)``, its row block of each
    diagonal's (hi, lo) planes (rows beyond n zero-padded), DistDIA's layout
    with the value planes doubled."""

    diags_hi: torch.Tensor
    diags_lo: torch.Tensor
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    block_rows: int
    nnz: int
    axis: str
    n_shards: int
    mesh: RowMesh

    @property
    def dtype(self) -> torch.dtype:
        return self.diags_hi.dtype


def distribute_df_dia(
    dfa: DfDiaMatrix,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistDfDia:
    """Partition a :class:`~..ops.df32.DfDiaMatrix` into equal row blocks
    over ``mesh`` (distribute_dia's condition: every ``|offset|`` at most the
    block, else ValueError)."""
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    n_rows, n_cols = dfa.shape
    if n_rows != n_cols:
        raise ValueError(f"distribute_df_dia supports square systems only, got {dfa.shape}")
    block = _block_rows(n_rows, n_dev)
    span = max(abs(o) for o in dfa.offsets) if dfa.offsets else 0
    if span > block:
        raise ValueError(f"diagonal offset {span} exceeds the row block {block}; "
                         "the neighbor-window halo cannot cover it")
    lo = mesh.rank * block

    def mine(d):
        d = _host(d)
        out = np.zeros((d.shape[0], block), dtype=d.dtype)
        if lo < n_rows:
            out[:, : min(block, n_rows - lo)] = d[:, lo:lo + block]
        return put_sharded(out, mesh, None)

    return DistDfDia(
        diags_hi=mine(dfa.diags_hi),
        diags_lo=mine(dfa.diags_lo),
        offsets=tuple(int(o) for o in dfa.offsets),
        shape=(int(n_rows), int(n_cols)),
        block_rows=int(block),
        nnz=dfa.nnz,
        axis=axis,
        n_shards=int(n_dev),
        mesh=mesh,
    )


def _local_df_dia_spmv(dhi, dlo, xh, xl, *, offsets, mesh: RowMesh, block_rows: int):
    """This shard's rows of ``A @ x`` in double-word.

    Per diagonal, ``two_prod`` of the hi words plus the f32 cross terms,
    added in double-word.  Row ``i`` reads ``x[i + off]`` of its own block
    (the interior accumulator) or of a neighbour block (the boundary one,
    once the exchange has landed); every other row adds an exact zero.
    """
    halo = halo_start(torch.stack([xh, xl]), mesh)  # both words, one payload
    B = block_rows
    i = torch.arange(B, device=xh.device)
    zero = torch.zeros(B, dtype=xh.dtype, device=xh.device)
    y_int = y_bnd = (zero, zero)

    def acc(y, a_hi, a_lo, wh, wl):
        p, e = two_prod(a_hi, wh)
        e = e + (a_hi * wl + a_lo * wh)
        return df_add(y, _fast_two_sum(p, e))

    def shifted(v, off, m):
        return torch.where(m, torch.roll(v, -off) if off else v, zero)

    for d, off in enumerate(offsets):
        inside = (i + off >= 0) & (i + off < B)
        y_int = acc(y_int, dhi[d], dlo[d], shifted(xh, off, inside), shifted(xl, off, inside))
    left, right = halo.wait()
    for d, off in enumerate(offsets):
        if off == 0:
            continue
        m, src = ((i + off < 0), left) if off < 0 else ((i + off >= B), right)
        y_bnd = acc(y_bnd, torch.where(m, dhi[d], zero), torch.where(m, dlo[d], zero),
                    shifted(src[0], off, m), shifted(src[1], off, m))
    return df_add(y_int, y_bnd)


def _df_allreduce(s, mesh: RowMesh):
    """The double-word sum over the mesh of a rank's (hi, lo) scalar pair:
    the P pairs all-gathered, then added by the pairwise tree in rank order
    on every rank (the same bits everywhere)."""
    parts = all_gather(torch.stack([s[0], s[1]]), mesh).reshape(mesh.size, 2)
    return _df_pairwise_reduce(parts[:, 0], parts[:, 1])


def _distribute_df_vector(v, a: DistDfDia, mesh: RowMesh):
    """This rank's padded (hi, lo) blocks of a global float64 vector (host
    array or tensor) or a global (hi, lo) pair; a pair of this rank's
    blocks on the mesh's device is taken as it is."""
    if isinstance(v, tuple) and len(v) == 2:
        if all(isinstance(w, torch.Tensor) and w.ndim == 1 and w.device == mesh.device
               and w.shape[0] == a.block_rows for w in v):
            return v[0].to(torch.float32), v[1].to(torch.float32)
        hi, lo = _host(v[0]).astype(np.float32), _host(v[1]).astype(np.float32)
    else:
        v = _host(v).astype(np.float64)
        hi = v.astype(np.float32)
        lo = (v - hi.astype(np.float64)).astype(np.float32)
    pad = a.padded_rows - hi.shape[0]
    if pad:
        hi = np.concatenate([hi, np.zeros(pad, np.float32)])
        lo = np.concatenate([lo, np.zeros(pad, np.float32)])
    return put_sharded(hi, mesh, a.axis), put_sharded(lo, mesh, a.axis)


def dist_df_dia_spmv(a: DistDfDia, x_df, mesh: Optional[RowMesh] = None):
    """This rank's (hi, lo) blocks of ``y = A @ x``, double-word in and out;
    ``x_df`` is this rank's (hi, lo) blocks, a global (hi, lo) pair or a
    global float64 vector."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    xh, xl = _distribute_df_vector(x_df, a, mesh)
    return _local_df_dia_spmv(a.diags_hi, a.diags_lo, xh, xl, offsets=a.offsets, mesh=mesh,
                              block_rows=a.block_rows)


def _dist_ir_df64(inner_kind: str, a: DistDfDia, b, x0=None, max_iterations: int = -1,
                  epsilon: float = 1e-8, *, inner_rho: float = 1e-2, max_outer: int = 60,
                  mesh: Optional[RowMesh] = None) -> DfSolveResult:
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    if not float(epsilon) ** 2 > 0.0 or float(epsilon) < 2e-19:
        raise ValueError(f"epsilon must satisfy eps^2 > f32 tiny (eps >= ~2e-19); got {epsilon!r}")
    b_df = _distribute_df_vector(b, a, mesh)
    x0_df = ((torch.zeros_like(b_df[0]), torch.zeros_like(b_df[1])) if x0 is None
             else _distribute_df_vector(x0, a, mesh))
    maxiter = resolve_max_iterations(max_iterations, a.shape[0])
    f32 = dict(dtype=torch.float32, device=mesh.device)
    eps2 = torch.tensor(float(epsilon) ** 2, **f32)
    rho2 = torch.tensor(float(inner_rho) ** 2, **f32)
    kw = dict(offsets=a.offsets, mesh=mesh, block_rows=a.block_rows)

    def matvec32(v):
        return _local_dia_spmv(a.diags_hi, v, **kw)

    def true_residual(x_df):
        r = df_sub(b_df, _local_df_dia_spmv(a.diags_hi, a.diags_lo, *x_df, **kw))
        return r, _df_allreduce(df_norm2(r), mesh)[0]

    def ident(v):
        return v

    x_hi, x_lo, rn2, total, outer, status = ir_df_core(
        true_residual, matvec32, None, _psum_dot(mesh), ident, ident, b_df, x0_df, eps2,
        rho2, maxiter, int(max_outer), inner_kind)
    n = a.shape[0]
    return DfSolveResult(x_hi=all_gather(x_hi, mesh)[:n], x_lo=all_gather(x_lo, mesh)[:n],
                         status=int(status), iterations=int(total), residual_norm2=rn2,
                         outer_rounds=int(outer))


def dist_cg_ir_df64(a: DistDfDia, b, x0=None, max_iterations: int = -1,
                    epsilon: float = 1e-8, *, inner_rho: float = 1e-2, max_outer: int = 60,
                    mesh: Optional[RowMesh] = None) -> DfSolveResult:
    """Distributed :func:`~..solvers.ir_df64.cg_ir_df64` (SPD systems): f32
    inner CG over the row mesh, refined by the exact double-word true
    residual; the single-device solver's accuracy contract at any rank
    count.  ``b``/``x0`` are global float64 vectors (or (hi, lo) pairs); the
    result holds the global solution on every rank."""
    return _dist_ir_df64("cg", a, b, x0, max_iterations, epsilon, inner_rho=inner_rho,
                         max_outer=max_outer, mesh=mesh)


def dist_bicgstab_ir_df64(a: DistDfDia, b, x0=None, max_iterations: int = -1,
                          epsilon: float = 1e-8, *, inner_rho: float = 1e-2,
                          max_outer: int = 60,
                          mesh: Optional[RowMesh] = None) -> DfSolveResult:
    """Distributed :func:`~..solvers.ir_df64.bicgstab_ir_df64` (general square
    systems): the refinement with f32 BiCGStab correction solves."""
    return _dist_ir_df64("bicgstab", a, b, x0, max_iterations, epsilon, inner_rho=inner_rho,
                         max_outer=max_outer, mesh=mesh)
