"""Geometric multigrid for the 2-D/3-D Poisson grids (5/7-point).

Port of ``sparse_matrix_math_tpu/solvers/multigrid.py``.  The family is the
dimensionless 2d+1-point Laplacian that ``poisson_2d`` / ``poisson_3d``
produce (diagonal 2d, neighbours -1, homogeneous Dirichlet):

* vectors are grid-shaped, ``(ny, nx)`` or ``(nz, ny, nx)``; every operator
  is a few shifted adds.  The JAX package leaves these to XLA, with no Pallas
  kernel, so plain torch ops are their port;
* coarse operators are Galerkin (A_c = P^T A P) in closed tensor-product
  form: with P the Kronecker product of per-axis prolongations and
  A = sum_ax kron(M_1, ..., L_ax, ..., M_d) (1-D tridiagonal factors; at the
  finest level M = I), every level is an exact Galerkin operator applied as
  d^2 one-axis tridiagonal stencils, for any side length (even, odd,
  anisotropic);
* smoothing: weighted Jacobi (omega = 4/5) with the level's true diagonal;
* coarsest level: a dense inverse computed once on the host (NumPy, float64)
  and applied as one product;
* :meth:`PoissonMultigrid.solve` runs V-cycles to a tolerance;
  :meth:`PoissonMultigrid.apply` is one V-cycle, a symmetric positive
  operation usable as a CG preconditioner.

The hierarchy builders (:func:`_prolong_matrix_np`, :func:`_lap1d_np`,
:func:`_tri_vectors`) are the port's own copy of the JAX module's NumPy code.
``solve``'s loop is host-driven (solvers/_loop.py): a chunk of V-cycles per
host read, frozen cycles keeping the state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import _loop
from .types import RUNNING, SolveResult, SolverStatus

__all__ = ["PoissonMultigrid"]

# at most this many points per side: the exact dense solve (the JAX
# package's values; 3-D stops earlier, the dense inverse is cubic in side)
_COARSEST = {2: 31, 3: 12}
# V-cycles per host read in solve()
_CYCLES_PER_READ = 4


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    pad = [0, 0] * (x.ndim - 1 - axis) + [lo, hi]  # F.pad pairs run from the last axis
    return torch.nn.functional.pad(x, pad)


def _sl(x: torch.Tensor, axis: int, start: int, limit: int, stride: int = 1) -> torch.Tensor:
    """Strided slice along one axis."""
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(start, limit, stride)
    return x[tuple(idx)]


def _stencil_apply(x: torch.Tensor) -> torch.Tensor:
    """y = A x for the dimensionless 2d+1-point Laplacian on a grid-shaped x
    (zeros outside the grid): the finest level (uniform stencil, M = I)."""
    d = x.ndim
    p = torch.nn.functional.pad(x, [1, 1] * d)
    y = (2.0 * d) * x
    for ax in range(d):
        lo = tuple(slice(0, -2) if a == ax else slice(1, -1) for a in range(d))
        hi = tuple(slice(2, None) if a == ax else slice(1, -1) for a in range(d))
        y = y - p[lo] - p[hi]
    return y


def _bcast(v: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    """A 1-D coefficient vector shaped to broadcast along ``axis``."""
    shape = [1] * ndim
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def _tridiag_apply(x, diag, upper, axis: int):
    """A symmetric tridiagonal operator along one grid axis:
    y_i = diag_i x_i + upper_i x_{i+1} + upper_{i-1} x_{i-1} (``upper`` has
    length n with upper_{n-1} = 0)."""
    n = x.shape[axis]
    d = _bcast(diag, x.ndim, axis)
    u = _bcast(upper, x.ndim, axis)
    lo = _bcast(torch.nn.functional.pad(upper[:-1], [1, 0]), x.ndim, axis)  # upper_{i-1}
    x_up = _pad_axis(_sl(x, axis, 1, n), axis, 0, 1)  # x_{i+1}
    x_dn = _pad_axis(_sl(x, axis, 0, n - 1), axis, 1, 0)  # x_{i-1}
    return d * x + u * x_up + lo * x_dn


def _prolong_1d(c: torch.Tensor, nf: int, axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis``: coarse node j sits at fine index
    2j+1; even fine indices average their coarse neighbours (zeros beyond the
    ends).  The even and odd fine sequences interleave by stack + reshape."""
    nc = c.shape[axis]
    cpad = _pad_axis(c, axis, 1, 1)
    n_even = (nf + 1) // 2  # fine indices 0, 2, 4, ...
    even = 0.5 * (_sl(cpad, axis, 0, n_even) + _sl(cpad, axis, 1, n_even + 1))
    odd = c if nc == n_even else _pad_axis(c, axis, 0, n_even - nc)
    pair = torch.stack([even, odd], dim=axis + 1)
    shape = list(c.shape)
    shape[axis] = 2 * n_even
    return _sl(pair.reshape(shape), axis, 0, nf)


def _restrict_1d(f: torch.Tensor, nc: int, axis: int) -> torch.Tensor:
    """The adjoint of :func:`_prolong_1d` (exact P^T, matching the Galerkin
    coarse operators): rc[j] = f[2j+1] + 0.5 f[2j] + 0.5 f[2j+2]."""
    fpad = _pad_axis(f, axis, 0, 2)
    center = _sl(f, axis, 1, 2 * nc, 2)
    left = _sl(fpad, axis, 0, 2 * nc, 2)
    right = _sl(fpad, axis, 2, 2 * nc + 2, 2)
    return center + 0.5 * (left + right)


# -- the hierarchy, built on the host (NumPy, float64) ----------------------


def _prolong_matrix_np(nf: int, nc: int) -> np.ndarray:
    """Dense 1-D prolongation: column j has tap 1 at fine 2j+1 and taps 0.5
    at fine 2j, 2j+2, the matrix :func:`_prolong_1d` applies."""
    p = np.zeros((nf, nc))
    for j in range(nc):
        p[2 * j + 1, j] = 1.0
        p[2 * j, j] += 0.5
        if 2 * j + 2 < nf:
            p[2 * j + 2, j] += 0.5
    return p


def _lap1d_np(n: int) -> np.ndarray:
    lap = 2.0 * np.eye(n)
    lap -= np.diag(np.ones(n - 1), 1) + np.diag(np.ones(n - 1), -1)
    return lap


def _tri_vectors(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(diag, upper) of a symmetric tridiagonal matrix; upper padded to
    length n with a trailing zero."""
    n = t.shape[0]
    upper = np.zeros(n)
    if n > 1:
        upper[:-1] = np.diag(t, 1)
    return np.diag(t).copy(), upper


@dataclasses.dataclass(frozen=True)
class PoissonMultigrid:
    """Galerkin tensor-product V-cycle solver and preconditioner for
    ``poisson_2d(nx, ny)`` / ``poisson_3d`` systems.

    ``coarse_inv`` is the dense inverse of the coarsest level's operator.
    ``factors[l][ax] = (dL, uL, dM, uM)``: the 1-D tridiagonal Galerkin
    factors of intermediate level ``l+1`` (level 0 is the uniform stencil),
    as (diag, upper) vectors.  ``winv[l]``: grid-shaped omega / diag(A_{l+1})
    Jacobi weights.  ``dims`` is the grid of every level.
    """

    coarse_inv: torch.Tensor
    factors: Tuple[Tuple[Tuple[torch.Tensor, ...], ...], ...]
    winv: Tuple[torch.Tensor, ...]
    dims: Tuple[Tuple[int, ...], ...]
    nu1: int = 2
    nu2: int = 2
    omega: float = 0.8

    @classmethod
    def for_stencil(cls, st, **kw) -> "PoissonMultigrid":
        """The hierarchy for a :class:`~..formats.stencil.GridStencilMatrix`
        that is the dimensionless 2d+1-point Laplacian (center ``2d``, each
        unit axis neighbour ``-1``), on the stencil's device.  Any other
        stencil raises ``ValueError``: the V-cycle's finest operator is this
        family's.  ``solve(a, b, preconditioner="multigrid")`` calls it."""
        d = len(st.dims)
        coeffs = st.coeffs.double().cpu().numpy()
        want = {(0,) * d: 2.0 * d}
        for ax in range(d):
            for s in (-1, 1):
                off = [0] * d
                off[ax] = s
                want[tuple(off)] = -1.0
        got = {tuple(o): float(c) for o, c in zip(st.doffs, coeffs)}
        if got != want:
            raise ValueError(
                "PoissonMultigrid.for_stencil: stencil is not the dimensionless "
                f"{2 * d + 1}-point Laplacian (got offsets/coeffs {got})")
        kw.setdefault("device", st.device)
        # for_grid's dims[0] is (ny, nx) / (nz, ny, nx): the stencil's
        # row-major dims, reversed into for_grid's arguments
        return cls.for_grid(*(int(m) for m in reversed(st.dims)), **kw)

    @classmethod
    def for_grid(cls, nx: int, ny: Optional[int] = None, nz: Optional[int] = None, *,
                 nu1: int = 2, nu2: int = 2, omega: float = 0.8, dtype=torch.float32,
                 device) -> "PoissonMultigrid":
        """The hierarchy for an ``nx x ny`` (2-D) or ``nx x ny x nz`` (3-D)
        interior grid in the row-major node order of ``poisson_2d`` /
        ``poisson_3d``, on ``device``."""
        ny = nx if ny is None else ny
        dims = [(int(ny), int(nx))] if nz is None else [(int(nz), int(ny), int(nx))]
        d = len(dims[0])
        coarsest = _COARSEST[d]
        # coarsen while the grid is large by either measure: the product cap
        # keeps anisotropic grids (4096 x 16) from a huge dense coarsest level
        while ((min(dims[-1]) > coarsest or int(np.prod(dims[-1])) > 2048)
               and min(dims[-1]) > 2):
            dims.append(tuple(m // 2 for m in dims[-1]))

        # the Galerkin recursion on the 1-D factors (exact for any dims)
        level_mats = [[(_lap1d_np(n), np.eye(n)) for n in dims[0]]]
        for lvl in range(1, len(dims)):
            cur = []
            for ax in range(d):
                p = _prolong_matrix_np(dims[lvl - 1][ax], dims[lvl][ax])
                lap, mass = level_mats[-1][ax]
                cur.append((p.T @ lap @ p, p.T @ mass @ p))
            level_mats.append(cur)

        def as_dt(a):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        factors, winv = [], []
        for lvl in range(1, len(dims) - 1):  # intermediate levels only
            per_axis = []
            diag_grid = np.zeros(dims[lvl])
            for ax in range(d):
                lap, mass = level_mats[lvl][ax]
                dl, ul = _tri_vectors(lap)
                dm, um = _tri_vectors(mass)
                per_axis.append((as_dt(dl), as_dt(ul), as_dt(dm), as_dt(um)))
                vecs = [np.diag(level_mats[lvl][a][0 if a == ax else 1]) for a in range(d)]
                g = vecs[0]
                for v in vecs[1:]:
                    g = np.multiply.outer(g, v)
                diag_grid += g
            factors.append(tuple(per_axis))
            winv.append(as_dt(omega / diag_grid))

        # the dense coarsest operator: sum over axes of kron(T_1, ..., T_d)
        n = int(np.prod(dims[-1]))
        a = np.zeros((n, n))
        for ax in range(d):
            term = np.ones((1, 1))
            for aa in range(d):
                term = np.kron(term, level_mats[-1][aa][0 if aa == ax else 1])
            a += term
        return cls(coarse_inv=as_dt(np.linalg.inv(a)), factors=tuple(factors),
                   winv=tuple(winv), dims=tuple(dims), nu1=int(nu1), nu2=int(nu2),
                   omega=float(omega))

    # -- the cycle -------------------------------------------------------------

    def _apply(self, level: int, x: torch.Tensor) -> torch.Tensor:
        """y = A_level x: level 0 the uniform stencil; coarse levels the
        Galerkin tensor operator (for each axis term, L along that axis and M
        along the others: d^2 tridiagonal passes)."""
        if level == 0:
            return _stencil_apply(x)
        per_axis = self.factors[level - 1]
        d = x.ndim
        y = None
        for ax in range(d):
            t = x
            for a in range(d):
                dl, ul, dm, um = per_axis[a]
                t = _tridiag_apply(t, dl, ul, a) if a == ax else _tridiag_apply(t, dm, um, a)
            y = t if y is None else y + t
        return y

    def _smooth(self, level: int, x, b, steps: int):
        w = (self.omega / (2.0 * len(self.dims[0])) if level == 0
             else self.winv[level - 1])
        for _ in range(steps):
            x = x + w * (b - self._apply(level, x))
        return x

    def _vcycle(self, b: torch.Tensor, level: int) -> torch.Tensor:
        """One V-cycle for A e = b from a zero initial guess."""
        if level == len(self.dims) - 1:
            flat = self.coarse_inv @ b.reshape(-1).to(self.coarse_inv.dtype)
            return flat.reshape(b.shape).to(b.dtype)
        x = self._smooth(level, torch.zeros_like(b), b, self.nu1)
        rc = b - self._apply(level, x)
        for ax, m in enumerate(self.dims[level + 1]):
            rc = _restrict_1d(rc, m, ax)
        up = self._vcycle(rc, level + 1)
        for ax, m in enumerate(self.dims[level]):
            up = _prolong_1d(up, m, ax)
        return self._smooth(level, x + up, b, self.nu2)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle as a linear operator z ~= A^{-1} r (flat in and out: a
        CG preconditioner's apply)."""
        return self._vcycle(r.reshape(self.dims[0]), 0).reshape(-1)

    def solve(self, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
              max_iterations: int = 100, epsilon: float = 1e-8) -> SolveResult:
        """Stationary V-cycle iteration to ``||r|| <= epsilon``.

        With Galerkin coarse operators it contracts mesh-independently for
        any grid dims.  A runaway guard (the residual grown beyond 1e4 times
        the initial one) reports DIVERGED if the operator is not of the
        supported Laplacian family.
        """
        bg = b.reshape(self.dims[0])
        x0g = torch.zeros_like(bg) if x0 is None else x0.reshape(self.dims[0])
        res = _mg_solve(self, bg, x0g, epsilon, int(max_iterations))
        return dataclasses.replace(res, x=res.x.reshape(-1))


def _mg_solve(mg: PoissonMultigrid, b, x0, eps, maxiter: int) -> SolveResult:
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    eps2 = eps * eps
    r = b - _stencil_apply(x0)
    rr = torch.sum(r * r)
    # the runaway guard: a mismatched operator, not a march to the cap
    rr_cap = 1e4 * rr + 1.0
    x = x0
    status = torch.where(rr <= eps2, int(SolverStatus.SUCCESS), RUNNING)
    k = torch.zeros((), dtype=torch.int64, device=b.device)

    def active_now():
        return (status == RUNNING) & (k < maxiter)

    active = active_now()
    while _loop.running(active):
        for _ in range(_CYCLES_PER_READ):
            x_n = x + mg._vcycle(r, 0)
            r_n = b - _stencil_apply(x_n)
            rr_n = torch.sum(r_n * r_n)
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
