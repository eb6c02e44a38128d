"""Distributed geometric multigrid over the row mesh.

Port of ``sparse_matrix_math_tpu/parallel/dist_multigrid.py``: the Galerkin
tensor-product hierarchy of solvers/multigrid.py with its fine levels split
over the ranks.

Layout: a grid vector is split along axis 0 (the outermost grid axis), so a
rank's block is a run of whole planes, the contiguous row block of the
row-major flat vector that parallel/dist.py's operands hold.  Every
multigrid operation is a radius-1 stencil along axis 0, so it needs one
neighbour plane from each side: :func:`~.mesh.open_halo_exchange`, which
does not wrap (the edge ranks receive zeros, the homogeneous Dirichlet
boundary; so does the only rank of a world of one).  The wrapping
``halo_exchange`` of the other operands would couple the grid's first and
last planes.

Axis-0 divisibility: level ``l``'s axis-0 extent pads to ``m0[l] = m0[0] /
2**l`` with ``m0[0]`` a multiple of ``P * 2**K`` (P ranks, K distributed
levels), so every distributed level splits into equal blocks and the 2:1
restriction stays aligned across rank boundaries (coarse plane j of rank d
reads fine planes 2j..2j+2 of rank d and at most the first plane of rank
d+1).  Padding planes hold zeros, kept so by per-level plane masks and zeroed
Galerkin and Jacobi coefficients; restricted to the real planes the padded
system is exactly the true operator.

Below the distributed levels the grids are small: the level-K residual is
all-gathered and the single-device hierarchy's tail
(``PoissonMultigrid._vcycle`` from level K, the dense coarsest inverse
included) runs on every rank, each slicing its own block back out.  Dots are
a local ``torch.dot`` and one all-reduce.  Everything here is plain PyTorch,
as it is plain ``jnp`` in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..solvers import _loop
from ..solvers.cg import cg_core, pcg_core
from ..solvers.multigrid import (
    _CYCLES_PER_READ,
    PoissonMultigrid,
    _prolong_1d,
    _restrict_1d,
    _tridiag_apply,
)
from ..solvers.types import RUNNING, SolveResult, SolverStatus
from .dist import _host, _psum_dot
from .mesh import ROW_AXIS, RowMesh, all_gather, open_halo_exchange, put_sharded, resolve_mesh

__all__ = ["DistPoissonMG", "distribute_multigrid", "dist_mg_solve", "dist_mg_vcycle"]

MG_SOLVERS = ("pcg", "cg", "mg")


@dataclasses.dataclass(frozen=True)
class DistPoissonMG:
    """This rank's shard of an axis-0-split multigrid hierarchy.

    ``ax0[l-1]`` (distributed levels ``l >= 1``): the level's axis-0
    Galerkin tridiagonal coefficients as this rank's ``(b0_l,)`` blocks,
    ``(dL, uL, loL, dM, uM, loM)`` with ``lo[i] = u[i-1]`` worked out on the
    host, so a coupling across a rank boundary needs no extra exchange.
    ``winv[l-1]``: the ``(b0_l, *rest)`` Jacobi weights, zero on pad planes.
    ``masks[l]`` (levels 0..K): ``(b0_l,)`` plane masks (1 = real plane).
    ``inner``: the whole single-device hierarchy on every rank; its levels
    K.. run as the replicated tail, and its dims are the true grids.
    """

    ax0: Tuple[Tuple[torch.Tensor, ...], ...]
    winv: Tuple[torch.Tensor, ...]
    masks: Tuple[torch.Tensor, ...]
    inner: PoissonMultigrid
    m0s: Tuple[int, ...]
    n_levels_dist: int
    axis: str
    n_shards: int
    mesh: RowMesh

    @property
    def dims(self):
        return self.inner.dims

    @property
    def shape(self):
        n = int(np.prod(self.dims[0]))
        return (n, n)

    @property
    def dtype(self) -> torch.dtype:
        return self.masks[0].dtype

    @property
    def block_shape(self) -> Tuple[int, ...]:
        """This rank's block of a finest-level grid vector."""
        return (self.m0s[0] // self.n_shards,) + tuple(self.dims[0][1:])


def _shift_lo(u: np.ndarray) -> np.ndarray:
    """lo[i] = u[i-1] (the symmetric lower coefficient, row-indexed)."""
    return np.pad(u[:-1], (1, 0))


def distribute_multigrid(
    mg: PoissonMultigrid,
    mesh: Optional[RowMesh] = None,
    *,
    axis: str = ROW_AXIS,
) -> DistPoissonMG:
    """Split a :class:`~..solvers.multigrid.PoissonMultigrid` hierarchy over
    a row mesh (the same hierarchy on every rank, on the mesh's device)."""
    mesh = resolve_mesh(mesh, axis=axis)
    n_dev = mesh.size
    dims = mg.dims
    if mg.coarse_inv.device != mesh.device:
        raise ValueError(f"the hierarchy lives on {mg.coarse_inv.device}, the mesh's ranks on "
                         f"{mesh.device}: build it with for_grid(..., device=mesh.device)")
    if len(dims) < 2:
        raise ValueError("grid too small to distribute (single-level hierarchy); use "
                         "the single-device PoissonMultigrid")
    # distributed levels 0..K-1, level K starts the replicated tail: a level
    # stays distributed while it has at least 2 real planes per rank, K >= 1
    k = 1
    while k < len(dims) - 1 and dims[k][0] >= 2 * n_dev:
        k += 1
    unit = n_dev * (1 << k)
    m00 = -(-dims[0][0] // unit) * unit
    m0s = tuple(m00 >> lvl for lvl in range(k + 1))
    dtype = mg.winv[0].dtype if mg.winv else mg.coarse_inv.dtype
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def block(vec, lvl: int) -> torch.Tensor:
        """A per-plane array padded to ``m0s[lvl]`` planes; this rank's block."""
        v = np.asarray(vec)
        v = np.pad(v, [(0, m0s[lvl] - v.shape[0])] + [(0, 0)] * (v.ndim - 1))
        return put_sharded(v.astype(np_dtype), mesh, axis)

    masks = tuple(block(np.ones(dims[lvl][0]), lvl) for lvl in range(k + 1))
    ax0, winv = [], []
    for lvl in range(1, k):
        dl, ul, dm, um = (_host(v).astype(np.float64) for v in mg.factors[lvl - 1][0])
        ax0.append(tuple(block(v, lvl) for v in (dl, ul, _shift_lo(ul), dm, um, _shift_lo(um))))
        winv.append(block(_host(mg.winv[lvl - 1]), lvl))
    return DistPoissonMG(ax0=tuple(ax0), winv=tuple(winv), masks=masks,
                         inner=mg, m0s=m0s, n_levels_dist=k,
                         axis=axis, n_shards=n_dev, mesh=mesh)


# -- this rank's grid operations, on (b0, *rest) blocks ----------------------------


def _mask_mul(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x * mask.reshape((mask.shape[0],) + (1,) * (x.ndim - 1))


def _stencil_apply_dist(x, mask, mesh: RowMesh):
    """Level 0's uniform 2d+1-point Laplacian on an axis-0 block."""
    up, dn = open_halo_exchange(x, mesh)
    d = x.ndim
    y = (2.0 * d) * x
    y = y - torch.cat([up, x[:-1]], 0)  # x[i-1]
    y = y - torch.cat([x[1:], dn], 0)   # x[i+1]
    for ax in range(1, d):
        lo = tuple(slice(0, -1) if a == ax else slice(None) for a in range(d))
        hi = tuple(slice(1, None) if a == ax else slice(None) for a in range(d))
        pad_lo = [0, 0] * (d - 1 - ax) + [1, 0]  # F.pad pairs run from the last axis
        pad_hi = [0, 0] * (d - 1 - ax) + [0, 1]
        y = (y - torch.nn.functional.pad(x[lo], pad_lo)
             - torch.nn.functional.pad(x[hi], pad_hi))
    return _mask_mul(y, mask)


def _tridiag0_pair(x, c_l, c_m, mesh: RowMesh):
    """Both axis-0 tridiagonal applies (the L and M factors) off one
    exchange; ``c_l``/``c_m`` are ``(d, u, lo)`` coefficient blocks."""
    up, dn = open_halo_exchange(x, mesh)
    x_m1 = torch.cat([up, x[:-1]], 0)
    x_p1 = torch.cat([x[1:], dn], 0)

    def tri(c):
        d, u, lo = (v.reshape((-1,) + (1,) * (x.ndim - 1)) for v in c)
        return d * x + u * x_p1 + lo * x_m1

    return tri(c_l), tri(c_m)


def _apply_coarse_dist(a: DistPoissonMG, lvl: int, x, mesh: RowMesh):
    """y = A_lvl x on a distributed Galerkin level (lvl >= 1): the axis-0
    factors share one exchange, the other axes run the local tridiagonal
    passes (solvers/multigrid.py:_tridiag_apply).  Pad planes carry zero
    coefficients, so no output mask is needed."""
    dl0, ul0, lo0, dm0, um0, mo0 = a.ax0[lvl - 1]
    t_l, t_m = _tridiag0_pair(x, (dl0, ul0, lo0), (dm0, um0, mo0), mesh)
    per_axis = a.inner.factors[lvl - 1]
    d = x.ndim
    # the axis-0 term: L along axis 0, M along the rest
    y = t_l
    for ax in range(1, d):
        _, _, dm, um = per_axis[ax]
        y = _tridiag_apply(y, dm, um, ax)
    # the terms of axes >= 1: M along axis 0 (t_m), L along ax, M along the rest
    for ax in range(1, d):
        t = t_m
        for b in range(1, d):
            dl, ul, dm, um = per_axis[b]
            t = _tridiag_apply(t, dl, ul, b) if b == ax else _tridiag_apply(t, dm, um, b)
        y = y + t
    return y


def _smooth_dist(a: DistPoissonMG, lvl: int, x, b, steps: int, mesh: RowMesh):
    if lvl == 0:
        w = a.inner.omega / (2.0 * len(a.dims[0]))
        for _ in range(steps):
            x = x + w * (b - _stencil_apply_dist(x, a.masks[0], mesh))
        return x
    w = a.winv[lvl - 1]
    for _ in range(steps):
        x = x + w * (b - _apply_coarse_dist(a, lvl, x, mesh))
    return x


def _restrict_dist(a: DistPoissonMG, r, lvl: int, mesh: RowMesh):
    """Full-weighting restriction from level lvl to lvl+1: rc[j] = f[2j+1]
    + 0.5 (f[2j] + f[2j+2]); only fine plane 2*bc (the next rank's first)
    crosses a boundary.  Axes >= 1 restrict locally."""
    _, next_first = open_halo_exchange(r, mesh)
    right = torch.cat([r[2::2], next_first], 0)
    rc = _mask_mul(r[1::2] + 0.5 * (r[0::2] + right), a.masks[lvl + 1])
    for ax in range(1, r.ndim):
        rc = _restrict_1d(rc, a.dims[lvl + 1][ax], ax)
    return rc


def _prolong_dist(a: DistPoissonMG, c, lvl: int, mesh: RowMesh):
    """Linear prolongation from level lvl+1 to lvl (the adjoint of
    :func:`_restrict_dist`): fine 2j+1 <- c[j], fine 2j <- 0.5 (c[j-1] +
    c[j]); only the previous rank's last plane crosses a boundary.  Axes >= 1
    prolong locally."""
    prev_last, _ = open_halo_exchange(c, mesh)
    cpad = torch.cat([prev_last, c], 0)
    even = 0.5 * (cpad[:-1] + cpad[1:])
    fine = torch.stack([even, c], dim=1).reshape((-1,) + tuple(c.shape[1:]))
    fine = _mask_mul(fine, a.masks[lvl])
    for ax in range(1, c.ndim):
        fine = _prolong_1d(fine, a.dims[lvl][ax], ax)
    return fine


def _vcycle_dist(a: DistPoissonMG, b, lvl: int, mesh: RowMesh):
    """One distributed V-cycle for A_lvl e = b from a zero guess."""
    k = a.n_levels_dist
    if lvl == k:
        # the replicated tail: the level-K residual gathered, the single-device
        # hierarchy's remaining levels on every rank, this rank's block kept
        n0 = a.dims[k][0]
        ec = a.inner._vcycle(all_gather(b, mesh)[:n0], k)
        bc = a.m0s[k] // mesh.size
        lo = mesh.rank * bc
        out = torch.zeros_like(b)
        if lo < n0:
            out[: min(bc, n0 - lo)] = ec[lo:lo + bc]
        return out
    x = _smooth_dist(a, lvl, torch.zeros_like(b), b, a.inner.nu1, mesh)
    if lvl == 0:
        r = b - _stencil_apply_dist(x, a.masks[0], mesh)
    else:
        r = b - _apply_coarse_dist(a, lvl, x, mesh)
    ec = _vcycle_dist(a, _restrict_dist(a, r, lvl, mesh), lvl + 1, mesh)
    x = x + _prolong_dist(a, ec, lvl, mesh)
    return _smooth_dist(a, lvl, x, b, a.inner.nu2, mesh)


# -- the front ----------------------------------------------------------------------


def _to_block(a: DistPoissonMG, v, mesh: RowMesh) -> torch.Tensor:
    """This rank's flat block of a flat global vector (host array or tensor
    of length n), axis 0 zero-padded to ``m0s[0]`` planes."""
    dims0 = a.dims[0]
    arr = _host(v).reshape(dims0)
    arr = np.pad(arr, [(0, a.m0s[0] - dims0[0])] + [(0, 0)] * (len(dims0) - 1))
    np_dtype = torch.empty((), dtype=a.dtype).numpy().dtype
    return put_sharded(arr.astype(np_dtype), mesh, a.axis).reshape(-1)


def _from_blocks(a: DistPoissonMG, x_flat: torch.Tensor, mesh: RowMesh) -> torch.Tensor:
    """The flat true-length global vector of the ranks' flat blocks, on
    every rank."""
    full = all_gather(x_flat.reshape(a.block_shape), mesh)
    return full[: a.dims[0][0]].reshape(-1)


def dist_mg_vcycle(a: DistPoissonMG, r, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """One distributed V-cycle z ~= A^{-1} r, flat global vectors in and out:
    the distributed twin of ``PoissonMultigrid.apply``."""
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    z = _vcycle_dist(a, _to_block(a, r, mesh).reshape(a.block_shape), 0, mesh)
    return _from_blocks(a, z.reshape(-1), mesh)


def _mg_stationary(a: DistPoissonMG, b, x0, eps: float, maxiter: int, mesh: RowMesh):
    """The stationary V-cycle iteration (solvers/multigrid.py:_mg_solve's
    twin over the mesh, its runaway guard included); flat blocks in and
    out, every host read of an all-reduced value."""
    dotfn = _psum_dot(mesh)
    shape, mask0 = a.block_shape, a.masks[0]

    def residual(x):
        return b - _stencil_apply_dist(x.reshape(shape), mask0, mesh).reshape(-1)

    eps2 = torch.as_tensor(eps, dtype=b.dtype, device=b.device) ** 2
    r = residual(x0)
    rr = dotfn(r, r)
    rr_cap = 1e4 * rr + 1.0
    x = x0
    status = torch.where(rr <= eps2, int(SolverStatus.SUCCESS), RUNNING)
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    def active_now():
        return (status == RUNNING) & (k < maxiter)

    active = active_now()
    while _loop.running(active):
        for _ in range(_CYCLES_PER_READ):
            x_n = x + _vcycle_dist(a, r.reshape(shape), 0, mesh).reshape(-1)
            r_n = residual(x_n)
            rr_n = dotfn(r_n, r_n)
            new_status = torch.where(
                ~torch.isfinite(rr_n) | (rr_n > rr_cap), int(SolverStatus.DIVERGED),
                torch.where(rr_n <= eps2, int(SolverStatus.SUCCESS), RUNNING))
            x = torch.where(active, x_n, x)
            r = torch.where(active, r_n, r)
            rr = torch.where(active, rr_n, rr)
            status = torch.where(active, new_status, status)
            k = k + active
            active = active_now()
    status_h, k_h = _loop.read(status, k)
    status_h = int(status_h)
    if status_h == RUNNING:
        status_h = int(SolverStatus.MAX_ITERATIONS_REACHED)
    return SolveResult(x=x, status=status_h, iterations=int(k_h), residual_norm=torch.sqrt(rr))


def dist_mg_solve(
    a: DistPoissonMG,
    b,
    x0=None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    solver: str = "pcg",
    mesh: Optional[RowMesh] = None,
    record_residuals: bool = False,
) -> SolveResult:
    """Distributed solve of the hierarchy's finest Poisson system.

    ``solver="pcg"``: CG preconditioned by one distributed V-cycle per
    iteration (the single device's ``cg(a, b, preconditioner=mg)``);
    ``"cg"``: plain distributed CG on the stencil; ``"mg"``: the stationary
    V-cycle iteration (``PoissonMultigrid.solve``'s twin).  ``b``/``x0``
    are flat global vectors; the result's ``x`` is the flat global solution
    on every rank, as the JAX package returns it.
    """
    if solver not in MG_SOLVERS:
        raise ValueError(f"dist_mg_solve supports pcg/cg/mg, got {solver!r}")
    mesh = resolve_mesh(mesh, a, n_shards=a.n_shards, axis=a.axis)
    b_local = _to_block(a, b, mesh)
    x0_local = torch.zeros_like(b_local) if x0 is None else _to_block(a, x0, mesh)
    maxiter = int(max_iterations)
    if maxiter < 0:
        maxiter = 100 if solver == "mg" else a.shape[0]
    shape, mask0 = a.block_shape, a.masks[0]

    def matvec(v):
        return _stencil_apply_dist(v.reshape(shape), mask0, mesh).reshape(-1)

    def precond(r):
        return _vcycle_dist(a, r.reshape(shape), 0, mesh).reshape(-1)

    dotfn, eps = _psum_dot(mesh), float(epsilon)
    if solver == "mg":
        res = _mg_stationary(a, b_local, x0_local, eps, maxiter, mesh)
    elif solver == "cg":
        res = cg_core(matvec, dotfn, b_local, x0_local, eps, maxiter, bool(record_residuals))
    else:
        res = pcg_core(matvec, precond, dotfn, b_local, x0_local, eps, maxiter,
                       bool(record_residuals))
    return dataclasses.replace(res, x=_from_blocks(a, res.x, mesh))
