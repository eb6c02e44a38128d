"""The result contract at the solver cores, held against the JAX package:
the port's twin of tests/test_robustness.py, for the five verified cores
(``cg``, ``pcg``, ``bicg_symmetric``, ``cgs``, ``bicgstab``) and the solver
tail (``gmres``, ``cg_pipelined``, ``chebyshev``).

* A singular, inconsistent system ends in a non-SUCCESS status in both
  packages (the iteration counts may differ: the denominators sit at rounding
  level, where ``torch.dot`` and ``jnp.sum`` differ).
* ``bicg_symmetric``'s serious and critical breakdowns fire as in JAX.
* Repeated runs are bit for bit equal (f32 and f64).
* An affine operator (``v -> v + offset``) makes the recurrence and the
  truth disagree: each core returns the JAX core's status and iteration
  count, and a ``residual_norm`` equal to the JAX core's.  The five verified
  cores refuse the claim; GMRES and Chebyshev, which restart or check from
  ``b - A x``, solve the affine system; pipelined CG reports its recurrence.
* On an honest operator SUCCESS means the true residual passed.
* At the iteration cap ``residual_norm`` is what the JAX core reports (the
  true residual for the verified cores and GMRES); BiCGStab returns its best
  iterate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.utils import generate as jax_gen
from test_torch_wsell import port_csr

S = smm.SolverStatus
VERIFIED = ["cg", "pcg", "bicgstab", "bicg_symmetric", "cgs"]
CORES = VERIFIED + ["gmres", "cg_pipelined", "chebyshev"]


def jax_cores(bounds):
    from sparse_matrix_math_tpu.solvers.bicg_symmetric import bicg_symmetric_core
    from sparse_matrix_math_tpu.solvers.bicgstab import bicgstab_core
    from sparse_matrix_math_tpu.solvers.cg import cg_core, pcg_core
    from sparse_matrix_math_tpu.solvers.cgs import cgs_core
    from sparse_matrix_math_tpu.solvers.chebyshev import chebyshev_core
    from sparse_matrix_math_tpu.solvers.gmres import gmres_core
    from sparse_matrix_math_tpu.solvers.pipelined import _dot2_local, cg_pipelined_core

    def dot(u, v):
        return jnp.sum(u * v)

    def ident(v):
        return v

    z = jnp.zeros_like
    return {
        "cg": lambda mv, b, e, it: cg_core(mv, dot, b, z(b), e, it, False),
        "pcg": lambda mv, b, e, it: pcg_core(mv, ident, dot, b, z(b), e, it, False),
        "bicgstab": lambda mv, b, e, it: bicgstab_core(mv, ident, dot, b, z(b), e, it, False),
        "bicg_symmetric": lambda mv, b, e, it: bicg_symmetric_core(mv, dot, b, z(b), e, it,
                                                                   False),
        "cgs": lambda mv, b, e, it: cgs_core(mv, dot, b, z(b), e, it, False),
        "gmres": lambda mv, b, e, it: gmres_core(mv, ident, dot, lambda V, w: V @ w, b, z(b), e,
                                                 min(32, b.shape[0]), it, False),
        "cg_pipelined": lambda mv, b, e, it: cg_pipelined_core(mv, _dot2_local, b, z(b), e, it,
                                                               False),
        "chebyshev": lambda mv, b, e, it: chebyshev_core(mv, dot, b, z(b), e, *bounds, it, 10,
                                                         False),
    }


def port_cores(bounds):
    from sparse_matrix_math_tpu_torch.solvers.bicg_symmetric import bicg_symmetric_core
    from sparse_matrix_math_tpu_torch.solvers.bicgstab import bicgstab_core
    from sparse_matrix_math_tpu_torch.solvers.cg import cg_core, pcg_core
    from sparse_matrix_math_tpu_torch.solvers.cgs import cgs_core
    from sparse_matrix_math_tpu_torch.solvers.chebyshev import chebyshev_core
    from sparse_matrix_math_tpu_torch.solvers.gmres import gmres_core
    from sparse_matrix_math_tpu_torch.solvers.pipelined import _dot2_local, cg_pipelined_core

    def dot(u, v):
        return torch.sum(u * v)

    def ident(v):
        return v

    z = torch.zeros_like
    return {
        "cg": lambda mv, b, e, it: cg_core(mv, dot, b, z(b), e, it, False),
        "pcg": lambda mv, b, e, it: pcg_core(mv, ident, dot, b, z(b), e, it, False),
        "bicgstab": lambda mv, b, e, it: bicgstab_core(mv, ident, dot, b, z(b), e, it, False),
        "bicg_symmetric": lambda mv, b, e, it: bicg_symmetric_core(mv, dot, b, z(b), e, it,
                                                                   False),
        "cgs": lambda mv, b, e, it: cgs_core(mv, dot, b, z(b), e, it, False),
        "gmres": lambda mv, b, e, it: gmres_core(mv, ident, dot, lambda V, w: V @ w, b, z(b), e,
                                                 min(32, b.shape[0]), it, False),
        "cg_pipelined": lambda mv, b, e, it: cg_pipelined_core(mv, _dot2_local, b, z(b), e, it,
                                                               False),
        "chebyshev": lambda mv, b, e, it: chebyshev_core(mv, dot, b, z(b), e, *bounds, it, 10,
                                                         False),
    }


def entry(pkg, name):
    """The public entry of ``name`` in ``pkg`` (pcg: CG with the identity)."""
    if name == "pcg":
        return lambda a, b, **kw: pkg.cg(a, b, preconditioner=pkg.IdentityPreconditioner(),
                                         **kw)
    return getattr(pkg, name)


# -- breakdowns --------------------------------------------------------------


@pytest.mark.parametrize("name", CORES)
def test_singular_system_is_not_success(name):
    dense = np.zeros((8, 8))
    dense[np.arange(7), np.arange(7)] = 1.0  # the last row and column zero
    jcsr = jsmm.csr_from_dense(dense)
    kw = dict(max_iterations=50, epsilon=1e-10)
    jres = entry(jsmm, name)(jcsr, jnp.ones(8, jnp.float64), **kw)
    tres = entry(smm, name)(port_csr(jcsr), torch.ones(8, dtype=torch.float64), **kw)
    stopped = (int(S.DIVERGED), int(S.MAX_ITERATIONS_REACHED))
    assert int(jres.status) in stopped and tres.status in stopped, (jres, tres)


def test_bicg_symmetric_serious_breakdown():
    """|Ap.p| < eps while ||r||^2 > 1 (reference h:2047-2058): A = diag(1, -1),
    b = ones gives p.Ap = 0 with ||r||^2 = 2 on the first iteration."""
    jcsr = jsmm.csr_from_dense(np.diag([1.0, -1.0]))
    jres = jsmm.bicg_symmetric(jcsr, jnp.ones(2), max_iterations=10, epsilon=1e-10)
    tres = smm.bicg_symmetric(port_csr(jcsr), torch.ones(2, dtype=torch.float64),
                              max_iterations=10, epsilon=1e-10)
    assert tres.status == int(jres.status) == int(S.DIVERGED)
    assert tres.iterations == int(jres.iterations) == 1
    assert tres.x.tolist() == np.asarray(jres.x).tolist() == [0.0, 0.0]


def test_bicg_symmetric_critical_breakdown():
    """||r'||^2 > 1 right after ||r||^2 < eps (reference h:2073-2081), driven
    through the core with tests/test_robustness.py's mock operator."""
    from sparse_matrix_math_tpu.ops.vector import dot as jdot
    from sparse_matrix_math_tpu.solvers.bicg_symmetric import bicg_symmetric_core as jcore
    from sparse_matrix_math_tpu_torch.solvers.bicg_symmetric import bicg_symmetric_core

    def jmatvec(v):
        return jnp.where(jnp.all(v == 0), jnp.zeros_like(v),
                         jnp.asarray([1.0, -1.0 + 1e-10], v.dtype))

    def tmatvec(v):
        return torch.where(torch.all(v == 0), torch.zeros_like(v),
                           torch.tensor([1.0, -1.0 + 1e-10], dtype=v.dtype))

    jb = jnp.asarray([1e-7, 1e-7], jnp.float64)
    jres = jcore(jmatvec, jdot, jb, jnp.zeros_like(jb), jnp.asarray(1e-5, jb.dtype), 10, False)
    tb = torch.tensor([1e-7, 1e-7], dtype=torch.float64)
    tres = bicg_symmetric_core(tmatvec, torch.dot, tb, torch.zeros_like(tb), 1e-5, 10, False)
    assert tres.status == int(jres.status) == int(S.DIVERGED)
    assert tres.iterations == int(jres.iterations) == 1
    assert np.isfinite(float(tres.residual_norm))  # critical, not NaN
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm), rel=1e-12)


# -- determinism -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", CORES)
def test_bitwise_repeatable(name, dtype):
    a = smm.poisson_2d(16, dtype=dtype, device="cpu")
    b = a @ torch.ones(256, dtype=dtype)
    kw = dict(epsilon=1e-5 if dtype == torch.float32 else 1e-9, max_iterations=2000)
    r1, r2 = (entry(smm, name)(a, b, **kw) for _ in range(2))
    word = np.int32 if dtype == torch.float32 else np.int64
    assert np.array_equal(r1.x.numpy().view(word), r2.x.numpy().view(word))
    assert (r1.status, r1.iterations) == (r2.status, r2.iterations)
    assert np.array_equal(r1.residual_norm.numpy().view(word),
                          r2.residual_norm.numpy().view(word))


def test_spmv_bitwise_repeatable():
    a = smm.poisson_2d(16, dtype=torch.float32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))
    assert torch.equal((a @ x).view(torch.int32), (a @ x).view(torch.int32))


# -- verified convergence ------------------------------------------------------


@pytest.mark.parametrize("name", CORES)
def test_refuted_claim_matches_jax(name):
    """Recurrence converges, the truth stalls at ~||offset||: the port's core
    returns the JAX core's status, iterations and residual_norm."""
    rng = np.random.default_rng(0)
    b = rng.standard_normal(64)
    offset = np.full(64, 1e-3)
    jres = jax_cores((0.5, 1.5))[name](lambda v: v + jnp.asarray(offset), jnp.asarray(b),
                                       jnp.float64(1e-6), 200)
    tres = port_cores((0.5, 1.5))[name](lambda v: v + torch.from_numpy(offset),
                                        torch.from_numpy(b), 1e-6, 200)
    assert tres.status == int(jres.status), (tres, jres)
    assert tres.iterations == int(jres.iterations), (tres, jres)
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm), rel=1e-6)
    true = np.linalg.norm(b - (tres.x.numpy() + offset))
    if name in VERIFIED:
        # the verified cores refuse the recurrence's claim
        assert tres.status != int(S.SUCCESS) and true > 1e-6
    if name != "cg_pipelined":
        # the pipelined recurrence reports its own residual; GMRES and
        # Chebyshev restart or check from b - A x, and solve the affine
        # system for real
        assert float(tres.residual_norm) == pytest.approx(true, rel=1e-6)


def _poisson_dense():
    """poisson_2d(16) as a dense float64 array, and its spectrum's ends."""
    dense = np.array(jax_gen.poisson_2d(16).to_dense(), np.float64)
    w = np.linalg.eigvalsh(dense)
    return dense, (float(w[0]), float(w[-1]))


@pytest.mark.parametrize("name", CORES)
def test_success_claim_is_true(name):
    dense, bounds = _poisson_dense()
    b = dense.sum(axis=1)
    amat = torch.from_numpy(dense)
    tres = port_cores(bounds)[name](lambda v: amat @ v, torch.from_numpy(b), 1e-8, 2 * 256)
    jmat = jnp.asarray(dense)
    jres = jax_cores(bounds)[name](lambda v: jmat @ v, jnp.asarray(b), jnp.float64(1e-8),
                                   2 * 256)
    assert tres.status == int(jres.status) == int(S.SUCCESS)
    true = np.linalg.norm(b - dense @ tres.x.numpy())
    assert true <= 1e-8 * (1 + 1e-6)
    band = 0 if name in ("chebyshev",) else 2
    assert abs(tres.iterations - int(jres.iterations)) <= band


@pytest.mark.parametrize("name", CORES)
def test_cap_reports_what_jax_reports(name):
    dense, bounds = _poisson_dense()
    b = dense.sum(axis=1)
    amat, jmat = torch.from_numpy(dense), jnp.asarray(dense)
    tres = port_cores(bounds)[name](lambda v: amat @ v, torch.from_numpy(b), 1e-14, 5)
    jres = jax_cores(bounds)[name](lambda v: jmat @ v, jnp.asarray(b), jnp.float64(1e-14), 5)
    assert tres.status == int(jres.status) == int(S.MAX_ITERATIONS_REACHED)
    assert tres.iterations == int(jres.iterations)
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm), rel=1e-9)
    if name not in ("cg_pipelined", "chebyshev"):
        true = np.linalg.norm(b - dense @ tres.x.numpy())
        assert float(tres.residual_norm) == pytest.approx(true, rel=1e-9)


def test_bicgstab_cap_returns_best_iterate():
    jcsr = jax_gen.poisson_2d(32, dtype=np.float64)
    dense = np.asarray(jcsr.to_dense(), np.float64)
    b = dense.sum(axis=1)
    jres = jsmm.bicgstab(jcsr, jnp.asarray(b), max_iterations=7, epsilon=1e-14)
    tres = smm.bicgstab(port_csr(jcsr), torch.from_numpy(b), max_iterations=7, epsilon=1e-14)
    assert tres.status == int(jres.status) == int(S.MAX_ITERATIONS_REACHED)
    assert tres.iterations == int(jres.iterations)
    true = np.linalg.norm(b - dense @ tres.x.numpy())
    assert float(tres.residual_norm) == pytest.approx(true, rel=1e-9)
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm), rel=1e-6)
    assert true < np.linalg.norm(b)
