"""Restarted GMRES, and its communication-avoiding s-step form.

Port of ``sparse_matrix_math_tpu/solvers/gmres.py`` (no reference
equivalent: the reference's nonsymmetric solvers are BiCGStab and CGS,
include/sparse_matrix_math.h:2109-2303).  The Krylov panel V is an
``(m+1, n)`` tensor, so each orthogonalisation is two panel products
(``V @ w``, then ``w - V.T @ h``: classical Gram-Schmidt twice, CGS2) rather
than m dot/axpy pairs.  As in the JAX package:

* every restart cycle runs at most ``m`` Arnoldi steps; a step after in-cycle
  convergence, or past the iteration cap (counted in matvecs), is frozen: H
  gets a unit diagonal and g a zero entry, so the triangular solve gives
  y_j = 0 for it;
* blocked Arnoldi: step j's CGS2 runs over the slice ``V[:8*(j//8 + 1)]``
  (rows past j are zeros);
* Givens rotations keep a running residual estimate ``|g[j+1]|``; ``safe``
  guards the R diagonal at an exact breakdown (h_{j+1,j} = 0);
* right preconditioning (solve ``A M^{-1} u = b``, ``x = M^{-1} u``), so the
  estimate tracks the true residual norm;
* each cycle ends with the true residual ``||b - A x||``; SUCCESS needs both
  the estimate and the true residual at or below ``epsilon``, and
  ``residual_norm`` is always the true one.  There is no ``floor_hit``: the
  JAX package's GMRES has none, and ``solve()`` pre-routes instead.

What differs from the JAX package, and why:

* **The loop** is host-driven: one host read per restart cycle
  (solvers/_loop.py).  Steps statically past the cap are not run at all;
  their frozen columns are written directly, which is what running them
  frozen writes.
* **The rotations.**  JAX applies the accumulated rotations to each new
  column one after another (``fori_loop``, :188-194); as eager torch ops that
  is about 4j tiny launches at step j.  The port keeps their product
  instead: an orthogonal ``(m+1, m+1)`` matrix Q_j = G_j ... G_0, so the new
  column is rotated by one small product ``Q_{j-1} @ h`` and G_j updates two
  rows of Q.  Same rotations, another summation order.  The small
  Hessenberg bookkeeping (H, g, Q) runs on the host in the working dtype:
  h is read back once per step, and the steps after in-cycle convergence
  are not run.  Kept beside V on the card instead, it was about 50 more
  launches per step and slower (PERF.md, phase G).
* **CholQR2** (s-step): ``torch.linalg.cholesky_ex``, with a failed factor
  turned into NaN as ``jnp.linalg.cholesky`` returns it, so the block's
  estimate goes non-finite and the cycle stops, without a host sync; the
  block is ``L^{-1}`` (an (s, s) triangular solve) times the panel: a
  triangular solve with n right-hand sides is far slower on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..formats.reorder import reorder_hoisted
from ..ops.spmv import as_operator, matvec_fn
from . import _loop
from .types import RUNNING, SolveResult, SolverStatus, harmonize_dtypes, resolve_max_iterations

__all__ = ["gmres", "gmres_core"]

# Instrumentation, beside _loop.host_syncs; no user reads it: restart cycles
# and the matvecs their Arnoldi steps (or power chains) ran, frozen ones
# included, since the last reset.  A solve's products are 1 + 2 * cycles +
# matvecs (the initial residual, each cycle's residual and true residual);
# chip_smoke.py holds K1's launches to that count.
loop_counts = {"cycles": 0, "matvecs": 0}

_TINY = 1e-30


@reorder_hoisted
def gmres(
    a,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    restart: int = 32,
    preconditioner=None,
    record_residuals: bool = False,
    s_step: int = 1,
) -> SolveResult:
    """Solve ``a @ x = b`` (any invertible ``a``) by GMRES(restart).

    ``max_iterations`` counts Arnoldi steps (matvecs), not cycles; -1 means
    n.  ``record_residuals`` records the per-step Givens residual estimates.

    ``s_step > 1`` switches to the communication-avoiding (s-step) Arnoldi:
    blocks of ``s_step`` locally orthogonalised matrix powers,
    orthogonalised together (BCGS2 + CholQR2), so the panel is read twice
    per block instead of four times per step.  The residual estimate then
    updates at block boundaries (the trace's other slots stay NaN), the cap
    is honoured at block granularity (the solve may stop up to s-1 matvecs
    short), and ``restart`` is rounded down to a multiple of ``s_step``.
    """
    a = as_operator(a)
    n = b.shape[0]
    b, x0 = harmonize_dtypes(a, b, x0)
    if x0 is None:
        x0 = torch.zeros_like(b)
    m = int(restart)
    if m < 1:
        raise ValueError(f"restart must be >= 1, got {restart}")
    m = min(m, n)
    maxiter = resolve_max_iterations(max_iterations, n)
    matvec = matvec_fn(a)
    mapply = (lambda v: v) if preconditioner is None else preconditioner.apply
    s = max(int(s_step), 1)
    if s > 1:
        if m >= s:
            m = (m // s) * s
        else:
            s = m
        return _ca_gmres_loop(matvec, mapply, b, x0, epsilon, m, s, maxiter,
                              bool(record_residuals))
    return gmres_core(matvec, mapply, torch.dot, lambda V, w: V @ w, b, x0, epsilon, m,
                      maxiter, bool(record_residuals))


def _restart_loop(cycle, matvec, dotfn, b, x0, eps, maxiter: int, record: bool,
                  step: int = 1) -> SolveResult:
    """The restart loop both Arnoldi forms share: a cycle from x, then the
    true residual; stop on SUCCESS (estimate and true residual at or below
    ``eps``), a non-finite one (DIVERGED) or when ``step`` more matvecs would
    pass the cap.  One host read per cycle."""
    eps = torch.as_tensor(eps, dtype=b.dtype, device=b.device)
    r0 = b - matvec(x0)
    res = torch.sqrt(dotfn(r0, r0))
    trace = _loop.new_trace(res, maxiter, record)
    res_h, eps_h = _loop.read(res, eps)
    x, k = x0, 0
    status = SolverStatus.SUCCESS if res_h <= eps_h else RUNNING
    while status == RUNNING and k + step <= maxiter:
        x, est, steps, trace = cycle(x, k, trace, eps)
        r_t = b - matvec(x)
        res = torch.sqrt(dotfn(r_t, r_t))
        est_h, true_h, steps_h = _loop.read(est, res, steps)
        k += int(steps_h)
        if not (math.isfinite(est_h) and math.isfinite(true_h)):
            status = SolverStatus.DIVERGED
        elif est_h <= eps_h and true_h <= eps_h:
            status = SolverStatus.SUCCESS
    if status == RUNNING:
        status = SolverStatus.MAX_ITERATIONS_REACHED
    return SolveResult(x=x, status=int(status), iterations=k, residual_norm=res,
                       residual_trace=trace)


def _arnoldi_step(matvec, mapply, dotfn, paneldot, V, j: int, nrows: int):
    """Step j's new direction by CGS2 over ``V[:nrows]``: (w, h, ||w||)."""
    w = matvec(mapply(V[j]))
    Vj = V[:nrows]
    h = paneldot(Vj, w)
    w = w - h @ Vj
    h2 = paneldot(Vj, w)
    w = w - h2 @ Vj
    return w, h + h2, torch.sqrt(dotfn(w, w))


def gmres_core(matvec, precond_apply, dotfn, paneldot, b, x0, eps, m: int, maxiter: int,
               record: bool) -> SolveResult:
    """GMRES(m) over injectable reductions: ``dotfn(u, v)`` is the (global)
    inner product and ``paneldot(V, w)`` the (global) panel contraction
    ``V @ w``.  On a mesh both reduce over the row axis while ``h @ V`` stays
    local."""
    n, dtype, dev = b.shape[0], b.dtype, b.device

    def cycle(x, k0, trace, eps):
        loop_counts["cycles"] += 1
        cap = maxiter - k0
        r = b - matvec(x)
        beta = torch.sqrt(dotfn(r, r))
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp(beta, min=_TINY)
        beta = beta.cpu()
        _loop.host_syncs["count"] += 1
        # H, g and the rotations so far (Q) live on the host
        H = torch.zeros((m + 1, m), dtype=dtype)
        g = torch.zeros((m + 1,), dtype=dtype)
        g[0] = beta
        q = torch.eye(m + 1, dtype=dtype)
        est, steps = beta, 0
        eps_h = eps.cpu()
        done = bool(beta <= eps_h)
        tr = torch.full((m,), float("nan"), dtype=dtype)
        for j in range(m):
            if j >= cap or done:
                # frozen, as a frozen step writes it
                H[j, j] = 1.0
                g[j] = 0.0
                continue
            loop_counts["matvecs"] += 1
            nrows = min(8 * (j // 8 + 1), m)
            w, h, hj1 = _arnoldi_step(matvec, precond_apply, dotfn, paneldot, V, j, nrows)
            V[j + 1] = w / torch.clamp(hj1, min=_TINY)
            hv = torch.cat([h, hj1.reshape(1)]).cpu()  # one read per step
            _loop.host_syncs["count"] += 1
            hcol = torch.zeros((m + 1,), dtype=dtype)
            hcol[:nrows] = hv[:nrows]
            hcol[j + 1] = hv[nrows]
            hcol = q @ hcol  # rotations 0 .. j-1 (row j+1 untouched)
            hj, hl = hcol[j], hcol[j + 1]
            safe = torch.clamp(torch.sqrt(hj * hj + hl * hl), min=_TINY)
            c, s = hj / safe, hl / safe
            # `safe` also guards the R diagonal: an exact Krylov breakdown
            # (h_{j+1,j} = 0) would otherwise write a zero pivot
            hcol[j], hcol[j + 1] = safe, 0.0
            H[:, j] = hcol
            qj, qj1 = q[j].clone(), q[j + 1].clone()
            q[j], q[j + 1] = c * qj + s * qj1, c * qj1 - s * qj
            g[j], g[j + 1] = c * g[j], -s * g[j]
            est = g[j + 1].abs()
            steps = j + 1
            tr[j] = est
            done = bool(est <= eps_h)
        # y = R^{-1} g over the rotated (upper-triangular) H
        y = torch.linalg.solve_triangular(H[:m], g[:m, None], upper=True)[:, 0]
        x = x + precond_apply(y.to(dev) @ V[:m])
        if trace is not None:
            live = min(m, cap)
            trace[k0 + 1:k0 + 1 + live] = tr[:live].to(dev)
        return x, est.to(dev), torch.tensor(steps, device=dev), trace

    return _restart_loop(cycle, matvec, dotfn, b, x0, eps, maxiter, record)


def _ca_gmres_loop(matvec, mapply, b, x0, eps, m: int, s: int, maxiter: int,
                   record: bool) -> SolveResult:
    """Communication-avoiding GMRES(m) with s-step blocks.

    Each block: ``s`` locally orthogonalised matrix powers (a matvec chain,
    each vector orthogonalised against the previous two: the exact relation
    A z^{(k-1)} = beta_k z^{(k)} + hd_k z^{(k-1)} + ho_k z^{(k-2)}), one BCGS2
    block orthogonalisation against the live basis (two panel passes) plus
    CholQR2 inside the block, and the s new Hessenberg columns rebuilt from
    the power and projection coefficients (all ``(m+1)``-sized dense
    algebra).  The residual estimate comes from a small least-squares solve
    per block; blocks after in-cycle convergence or past the matvec budget
    are frozen (unit H columns at row col+1, so the final solve gives y = 0
    for them).
    """
    n, dtype, dev = b.shape[0], b.dtype, b.device
    nblocks = m // s
    mach = torch.finfo(dtype).eps

    def small_ls(hsub, g):
        """y and ||g - hsub y|| by QR (hsub has more rows than columns)."""
        q, rr = torch.linalg.qr(hsub, mode="reduced")
        y = torch.linalg.solve_triangular(rr, (q.T @ g)[:, None], upper=True)[:, 0]
        resid = g - hsub @ y
        return y, torch.sqrt(torch.sum(resid * resid))

    def cholqr(Y):
        G = Y @ Y.T
        ridge = 10.0 * mach * (torch.trace(G) / s + _TINY)
        eye = torch.eye(s, dtype=dtype, device=dev)
        L, info = torch.linalg.cholesky_ex(G + ridge * eye)
        L = torch.where(info != 0, float("nan"), L)  # jnp.linalg.cholesky's failure
        return torch.linalg.solve_triangular(L, eye, upper=False) @ Y, L

    def cycle(x, k0, trace, eps):
        loop_counts["cycles"] += 1
        budget = maxiter - k0
        r = b - matvec(x)
        beta = torch.sqrt(torch.dot(r, r))
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        V[0] = r / torch.clamp(beta, min=_TINY)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        done = beta <= eps
        est = beta
        steps = torch.zeros((), dtype=torch.int64, device=dev)
        for bi in range(nblocks):
            live = bi * s + 1
            if (bi + 1) * s > budget:
                # past the budget: frozen, as a frozen block writes it
                for i in range(s):
                    H[live + i, live - 1 + i] = 1.0
                continue
            run = ~done
            loop_counts["matvecs"] += s
            # the locally orthogonalised power chain (s matvecs)
            zs, coef = [], []
            zp, zprev = V[live - 1], None
            for _ in range(s):
                t = matvec(mapply(zp))
                h_d = torch.dot(zp, t)
                t = t - h_d * zp
                if zprev is not None:
                    h_o = torch.dot(zprev, t)
                    t = t - h_o * zprev
                else:
                    h_o = torch.zeros((), dtype=dtype, device=dev)
                bk = torch.sqrt(torch.dot(t, t))
                znew = t / torch.clamp(bk, min=_TINY)
                zs.append(znew)
                coef.append((h_o, h_d, bk))
                zprev, zp = zp, znew
            Z = torch.stack(zs)  # (s, n)
            # BCGS2 against the live basis (the two panel passes)
            Vl = V[:live]
            C1 = Vl @ Z.T  # (live, s)
            Zp = Z - C1.T @ Vl
            C2 = Vl @ Zp.T
            Zp = Zp - C2.T @ Vl
            C = C1 + C2
            # CholQR2 inside the block
            Q1, L1 = cholqr(Zp)
            Q, L2 = cholqr(Q1)
            R = (L1 @ L2).T  # upper: Z' (cols) = Q (cols) R
            V[live:live + s] = torch.where(run, Q, V[live:live + s])
            # Hessenberg columns in the extended basis [V | Q]: zc_j is
            # z^{(j)} (zc_0 = e_{live-1}), azw_k = A z^{(k)} by the chain's
            # three-term relation
            p = live + s
            ZC = torch.cat([C, R], dim=0)  # (p, s)
            e = torch.zeros((p,), dtype=dtype, device=dev)
            e[live - 1] = 1.0
            zc = [e] + [ZC[:, j] for j in range(s)]
            azw = []
            for k, (h_o, h_d, bk) in enumerate(coef):
                v = bk * zc[k + 1] + h_d * zc[k]
                if k >= 1:
                    v = v + h_o * zc[k - 1]
                azw.append(v)
            hcols = torch.zeros((m + 1, s), dtype=dtype, device=dev)
            hcols[:p, 0] = azw[0]  # A v_{live-1}
            if s > 1:
                AVW = torch.zeros((p, live), dtype=dtype, device=dev)
                AVW[:, :live - 1] = H[:p, :live - 1]
                AVW[:, live - 1] = azw[0]
                X = torch.stack(azw[1:], dim=1) - AVW @ C[:, :s - 1]
                # X @ R_top^{-1}
                hcols[:p, 1:] = torch.linalg.solve_triangular(
                    R[:s - 1, :s - 1].T, X.T, upper=False).T
            unit = torch.zeros((m + 1, s), dtype=dtype, device=dev)
            for i in range(s):
                unit[live + i, i] = 1.0
            H[:, live - 1:live - 1 + s] = torch.where(run, hcols, unit)
            # the block-boundary residual estimate (small LS)
            filled = live - 1 + s
            g = torch.zeros((filled + 1,), dtype=dtype, device=dev)
            g[0] = beta
            _, est_b = small_ls(H[:filled + 1, :filled], g)
            est = torch.where(run, est_b, est)
            steps = torch.where(run, steps + s, steps)
            if trace is not None:
                trace[k0 + filled] = torch.where(run, est_b, trace[k0 + filled])
            done = done | (est <= eps) | ~torch.isfinite(est)
        g = torch.zeros((m + 1,), dtype=dtype, device=dev)
        g[0] = beta
        y, _ = small_ls(H, g)
        return x + mapply(y @ V[:m]), est, steps, trace

    return _restart_loop(cycle, matvec, torch.dot, b, x0, eps, maxiter, record, step=s)
