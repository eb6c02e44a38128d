"""Breakdowns put to both packages, and frozen iterations that stay frozen.

* The exact breakdown of tests/test_robustness.py: A = diag(1, -1),
  b = (1, 1), f64, eps 1e-12 (p.Ap = 0 on the first iteration).  ``cg``,
  ``pcg`` (Identity), ``bicgstab``, ``cgs`` and ``bicg_symmetric`` return
  the JAX package's status, iteration count and class of ``residual_norm``
  (inf, nan or finite), and x of the same class entry by entry, equal where
  finite.  For CG that is inf: the frozen iterations after the breakdown
  leave x = (inf, inf) as the JAX while-loop leaves it, where an unfrozen
  ``x + 0 * p`` with p = (nan, inf) made it nan.
* A frozen chunk leaves the state bit for bit as it was: a solve whose
  matvec returns inf once, part-way (so the recurrence vectors turn
  non-finite and the solve stops), gives the same x, residual trace, status
  and iterations when the loop runs 32 iterations per host check (the rest
  of the chunk frozen) as when it runs one; and CG's residual r, read at
  every iteration's ``r . r``, stays the breakdown iteration's through the
  frozen rest of the chunk.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.solvers import _loop
from sparse_matrix_math_tpu_torch.solvers.cg import cg_core, pcg_core

SOLVERS = ["cg", "pcg", "bicgstab", "cgs", "bicg_symmetric"]


def _class(v) -> str:
    v = float(v)
    return "nan" if math.isnan(v) else ("inf" if math.isinf(v) else "finite")


def _solve(pkg, name, a, b, **kw):
    if name == "pcg":
        return pkg.cg(a, b, preconditioner=pkg.IdentityPreconditioner(), **kw)
    return getattr(pkg, name)(a, b, **kw)


@pytest.mark.parametrize("name", SOLVERS)
def test_exact_breakdown_matches_jax(name):
    jcsr = csr_from_dense(np.diag([1.0, -1.0]))
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    b = np.array([1.0, 1.0])
    jres = _solve(jsmm, name, jcsr, jnp.asarray(b), epsilon=1e-12)
    tres = _solve(smm, name, tcsr, torch.from_numpy(b), epsilon=1e-12)
    assert tres.status == int(jres.status) == int(smm.SolverStatus.DIVERGED)
    assert tres.iterations == int(jres.iterations) == 1
    assert _class(tres.residual_norm) == _class(jres.residual_norm)
    jx, tx = np.asarray(jres.x), tres.x.numpy()
    assert [_class(v) for v in tx] == [_class(v) for v in jx]
    finite = np.isfinite(jx)
    np.testing.assert_allclose(tx[finite], jx[finite], rtol=0, atol=1e-12)
    if name in ("cg", "pcg"):
        assert _class(tres.residual_norm) == "inf"
        assert tx.tolist() == jx.tolist() == [math.inf, math.inf]


def test_frozen_cg_chunk_keeps_r():
    """CG on the exact breakdown: every ``r . r`` after the breakdown sees
    the breakdown iteration's r, bit for bit, and x stays (inf, inf)."""
    a = torch.diag(torch.tensor([1.0, -1.0], dtype=torch.float64))
    b = torch.ones(2, dtype=torch.float64)
    for core, pre in ((cg_core, None), (pcg_core, lambda v: v.clone())):
        seen = []

        def dotfn(u, v):
            if u is v:
                seen.append(u.clone())
            return torch.dot(u, v)

        args = (lambda v: a @ v, dotfn, b, torch.zeros_like(b), 1e-12, 100, False)
        res = core(*args) if pre is None else core(args[0], pre, *args[1:])
        assert res.status == int(smm.SolverStatus.DIVERGED) and res.iterations == 1
        assert res.x.tolist() == [math.inf, math.inf]
        # r0 . r0, the restart's r . r, then one r . r per loop iteration
        inner = seen[2:2 + _loop.CHUNK]
        assert len(inner) == _loop.CHUNK
        assert inner[0].tolist() == [-math.inf, math.inf]
        for r in inner[1:]:
            assert np.array_equal(r.numpy().view(np.int64), inner[0].numpy().view(np.int64))


def _bomb(a, at: int):
    """``a @ v``, except inf at call number ``at``."""
    calls = [0]

    def matvec(v):
        calls[0] += 1
        return torch.full_like(v, math.inf) if calls[0] == at else a @ v

    return matvec


@pytest.mark.parametrize("at", [4, 6])
@pytest.mark.parametrize("name", SOLVERS)
def test_frozen_chunk_leaves_state(name, at, monkeypatch):
    a = smm.poisson_2d(6, dtype=torch.float64, device="cpu").to_dense()
    b = torch.as_tensor(np.random.default_rng(0).standard_normal(36))
    kw = dict(epsilon=1e-12, max_iterations=200, record_residuals=True)
    if name == "pcg":
        kw["preconditioner"] = smm.JacobiPreconditioner(inv_diag=1.0 / torch.diagonal(a))
    solver = smm.cg if name == "pcg" else getattr(smm, name)
    runs = []
    for chunk in (1, 32):
        monkeypatch.setattr(_loop, "CHUNK", chunk)
        runs.append(solver(_bomb(a, at), b, **kw))
    one, many = runs
    assert one.status == many.status == int(smm.SolverStatus.DIVERGED)
    assert one.iterations == many.iterations
    assert np.array_equal(one.x.numpy().view(np.int64), many.x.numpy().view(np.int64))
    assert np.array_equal(one.residual_trace.numpy().view(np.int64),
                          many.residual_trace.numpy().view(np.int64))
    assert _class(one.residual_norm) == _class(many.residual_norm)
