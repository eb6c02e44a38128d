"""Chebyshev polynomial preconditioner: an apply made of products with A.

Port of ``sparse_matrix_math_tpu/precond/cheby_poly.py``, with the two
spectrum helpers it needs from ``solvers/chebyshev.py:41-106``
(:func:`widen_eig_bounds`, :func:`lanczos_extremal`; the Chebyshev solver of
that file is not ported yet).  Classical polynomial preconditioning (Saad,
Iterative Methods 12.3):

    M^{-1} r  =  p_k(A) r  ~=  A^{-1} r   on the spectrum [lmin, lmax]

computed by k steps of the Chebyshev semi-iteration on ``A z = r`` from
``z0 = 0``, a fixed step count with no convergence checks.  A fixed-step run
is a linear operator, symmetric for SPD ``A``, so it is a legitimate PCG
preconditioner.  ``apply`` is built from the matvec the solver uses, so the
grid-stencil solve runs the whole preconditioned iteration in the grid layout
(solvers/_stencil.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["ChebyshevPreconditioner", "cheby_apply_fn", "lanczos_extremal",
           "widen_eig_bounds"]


def cheby_apply_fn(matvec: Callable, lmin: float, lmax: float, degree: int) -> Callable:
    """The ``degree``-step Chebyshev semi-iteration as a closure over any
    matvec, for vectors of any layout."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    def apply(r: torch.Tensor) -> torch.Tensor:
        # the scalar recurrence runs in r's dtype, as the JAX closure's does:
        # 0-d host tensors, which scale a tensor on any device
        th = torch.tensor(theta, dtype=r.dtype)
        de = torch.tensor(delta, dtype=r.dtype)
        # z0 = 0; d0 = r / theta; z1 = d0
        d = r / th
        z = d
        rho = de / th
        for _ in range(degree - 1):
            res = r - matvec(z)
            new_rho = 1.0 / (2.0 / (de / th) - rho)
            d = (new_rho * rho) * d + (2.0 * new_rho / de) * res
            z = z + d
            rho = new_rho
        return z

    return apply


def widen_eig_bounds(lo: float, hi: float) -> Tuple[float, float]:
    """Sign-aware widening of interior Lanczos eigenvalue estimates: margins
    of 10% below and 5% above, a nonpositive ``lo`` clamped to a small
    positive floor (SPD spectra are positive), and a ValueError when the
    result is not a positive interval."""
    lo = lo - 0.1 * abs(lo)
    hi = hi + 0.05 * abs(hi)
    if lo <= 0.0:
        lo = 1e-8 * max(hi, 1.0)
    if hi <= lo:
        raise ValueError(f"estimated spectrum [{lo}, {hi}] is not positive-definite; "
                         "supply eig_bounds= explicitly")
    return lo, hi


def lanczos_extremal(a, k: int = 32, seed: int = 0, n: Optional[int] = None,
                     device=None) -> Tuple[float, float]:
    """Estimate (lmin, lmax) of symmetric ``a`` by ``k`` Lanczos steps from a
    seeded standard-normal start vector (made with NumPy, so the estimates
    differ from the JAX package's in the start vector alone).  The estimates
    are interior to the spectrum: widen them.  For a callable ``a`` pass
    ``n`` and ``device``."""
    from ..ops.spmv import as_operator, matvec_fn

    a = as_operator(a)
    if n is None:
        if not hasattr(a, "shape"):
            raise ValueError("lanczos_extremal needs n= for callable operators "
                             "(no shape to infer the dimension from)")
        n = a.shape[0]
    matvec = matvec_fn(a)
    dtype = getattr(a, "dtype", torch.float32)
    device = getattr(a, "device", device)
    v = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(
        device=device, dtype=dtype)
    v = v / torch.sqrt(torch.dot(v, v))
    v_prev, beta = torch.zeros_like(v), torch.zeros((), dtype=dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(k):
        w = matvec(v) - beta * v_prev
        alpha = torch.dot(w, v)
        w = w - alpha * v
        beta = torch.sqrt(torch.dot(w, w))
        v_prev, v = v, w / torch.clamp(beta, min=1e-30)
        alphas.append(alpha)
        betas.append(beta)
    al = torch.stack(alphas).double().cpu().numpy()
    be = torch.stack(betas).double().cpu().numpy()
    t = np.diag(al) + np.diag(be[:-1], 1) + np.diag(be[:-1], -1)
    eig = np.linalg.eigvalsh(t)  # k x k, on the host, in float64
    return float(eig[0]), float(eig[-1])


@dataclasses.dataclass(frozen=True)
class ChebyshevPreconditioner:
    """Polynomial preconditioner ``M^{-1} = p_degree(A)``.

    Holds the operator it preconditions (any format or matvec source), the
    spectrum bounds and the degree.  PCG needs an SPD ``a``.
    """

    a: object
    lmin: float
    lmax: float
    degree: int

    @classmethod
    def from_matrix(cls, a, *, degree: int = 4,
                    eig_bounds: Optional[Tuple[float, float]] = None
                    ) -> "ChebyshevPreconditioner":
        """With Lanczos-estimated, widened bounds when ``eig_bounds`` is not
        given."""
        if degree < 1:
            raise ValueError("degree must be >= 1")
        if eig_bounds is None:
            eig_bounds = widen_eig_bounds(*lanczos_extremal(a))
        return cls(a=a, lmin=float(eig_bounds[0]), lmax=float(eig_bounds[1]),
                   degree=int(degree))

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import matvec_fn

        return cheby_apply_fn(matvec_fn(self.a), self.lmin, self.lmax, self.degree)(r)
