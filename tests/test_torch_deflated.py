"""The port's deflated CG (solvers/deflated.py) held against the JAX package's.

* ``_lanczos_panel`` from JAX's own start vector
  (``jax.random.normal(PRNGKey(seed), (n,), dtype)``): panel, alphas and
  betas within 1e-10 in f64, on spectra of distinct eigenvalues (where the
  Krylov space is exhausted, the next vectors are rounding noise in both).
* ``lanczos_deflation_basis`` (the port's start vector is NumPy's): the
  isolated near-null mode found, unconverged Ritz pairs filtered with a
  ``RuntimeWarning``, orthonormal columns, ``steps`` over n refused.
* ``deflated_cg`` on the same basis in both packages: status, iterations
  within max(2, 2%) (the panel products sum in another order), x within
  1e-8 of ||x|| in f64; f32 iterations within max(3, 10%); a Jacobi
  preconditioner; an empty basis (plain CG); a ``ReorderedMatrix``, whose
  basis is permuted with b.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.solvers.deflated import _lanczos_panel as jax_lanczos_panel
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch.solvers.deflated import _lanczos_panel
from test_torch_wsell import port_csr

S = smm.SolverStatus


def ring(n, shift, dtype=np.float64):
    """The periodic Laplacian + shift I of tests/test_deflated.py: one
    isolated tiny eigenvalue (the constant mode)."""
    d = np.zeros((n, n))
    i = np.arange(n)
    d[i, i] = 2.0 + shift
    d[i, (i + 1) % n] = -1.0
    d[i, (i - 1) % n] = -1.0
    return jsmm.csr_from_dense(d.astype(dtype))


def assert_parity(tres, jres, dtype):
    assert tres.status == int(jres.status), (tres, jres)
    its = int(jres.iterations)
    band = max(3, int(0.1 * its)) if dtype == np.float32 else max(2, int(0.02 * its))
    assert abs(tres.iterations - its) <= band, (tres, jres)
    jx, tx = np.asarray(jres.x, np.float64), tres.x.double().numpy()
    xtol = 1e-3 if dtype == np.float32 else 1e-8
    assert np.linalg.norm(tx - jx) <= xtol * np.linalg.norm(jx)


@pytest.mark.parametrize("make,m", [(lambda: jax_gen.poisson_2d(12, 7, dtype=np.float64), 24),
                                    (lambda: jax_gen.laplace_1d(128, dtype=np.float64), 48)])
def test_lanczos_panel_from_jax_start_vector(make, m):
    jcsr = make()
    n = jcsr.shape[0]
    jv, ja, jb = jax_lanczos_panel(jcsr, jnp.int32(3), n, m, jnp.float64)
    v0 = jax.random.normal(jax.random.PRNGKey(3), (n,), dtype=jnp.float64)
    tv, ta, tb = _lanczos_panel(port_csr(jcsr), torch.from_numpy(np.array(v0)), m)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-10)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-10)


def test_basis_finds_isolated_mode_and_is_orthonormal():
    w = smm.lanczos_deflation_basis(port_csr(ring(128, 1e-6)), n_vectors=1, steps=96)
    assert tuple(w.shape) == (128, 1)
    assert abs(float(w[:, 0].sum())) / np.sqrt(128) > 1 - 1e-8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        w2 = smm.lanczos_deflation_basis(port_csr(ring(96, 1e-5)), n_vectors=2, steps=72)
    np.testing.assert_allclose((w2.T @ w2).numpy(), np.eye(w2.shape[1]), atol=1e-8)


def test_basis_filters_unconverged_and_refuses_long_runs():
    a = port_csr(jax_gen.laplace_1d(256, dtype=np.float64))
    with pytest.warns(RuntimeWarning, match="converged"):
        w = smm.lanczos_deflation_basis(a, n_vectors=8, steps=64)
    assert w.shape[1] < 8
    with pytest.raises(ValueError):
        smm.lanczos_deflation_basis(port_csr(jax_gen.poisson_2d(3, dtype=np.float64)),
                                    n_vectors=4, steps=100)


@pytest.mark.parametrize("name", ["laplace_1d(256)", "poisson_2d(17, 11)"])
def test_deflated_cg_exact_basis_matches_jax(name):
    jcsr = (jax_gen.laplace_1d(256, dtype=np.float64) if name.startswith("laplace")
            else jax_gen.poisson_2d(17, 11, dtype=np.float64))
    n = jcsr.shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    evecs = np.linalg.eigh(np.asarray(jcsr.to_dense()))[1][:, :12]
    jres = jsmm.deflated_cg(jcsr, jnp.asarray(b), epsilon=1e-10,
                            deflation_basis=jnp.asarray(evecs))
    tres = smm.deflated_cg(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-10,
                           deflation_basis=torch.from_numpy(evecs))
    plain = smm.cg(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-10)
    assert tres.status == int(S.SUCCESS) and tres.iterations < plain.iterations
    assert_parity(tres, jres, np.float64)
    assert float(tres.residual_norm) <= 1e-10


def test_deflated_cg_lanczos_basis_and_jacobi_matches_jax():
    """JAX's Lanczos basis handed to both packages, with and without a
    Jacobi preconditioner."""
    jcsr = jax_gen.poisson_2d(16, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = np.random.default_rng(1).standard_normal(256)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jw = jsmm.lanczos_deflation_basis(jcsr, n_vectors=4)
    tw = torch.from_numpy(np.asarray(jw))
    for jpre, tpre in ((None, None),
                       (jsmm.JacobiPreconditioner.from_matrix(jcsr),
                        smm.JacobiPreconditioner.from_matrix(tcsr))):
        jres = jsmm.deflated_cg(jcsr, jnp.asarray(b), epsilon=1e-10, deflation_basis=jw,
                                preconditioner=jpre)
        tres = smm.deflated_cg(tcsr, torch.from_numpy(b), epsilon=1e-10, deflation_basis=tw,
                               preconditioner=tpre)
        assert tres.status == int(S.SUCCESS)
        assert_parity(tres, jres, np.float64)


def test_deflated_cg_f32_near_null_matches_jax():
    """tests/test_deflated.py's f32 ring case, one basis for both."""
    jcsr = ring(128, 1e-5, np.float32)
    b = np.random.default_rng(2).standard_normal(128).astype(np.float32)
    jw = jsmm.lanczos_deflation_basis(jcsr, n_vectors=1, steps=96)
    kw = dict(epsilon=1e-5, max_iterations=5000)
    jres = jsmm.deflated_cg(jcsr, jnp.asarray(b), deflation_basis=jw, **kw)
    tres = smm.deflated_cg(port_csr(jcsr), torch.from_numpy(b),
                           deflation_basis=torch.from_numpy(np.asarray(jw)), **kw)
    plain = smm.cg(port_csr(jcsr), torch.from_numpy(b), **kw)
    assert tres.status == int(S.SUCCESS) and tres.iterations < plain.iterations
    assert_parity(tres, jres, np.float32)


def test_deflated_cg_empty_basis_and_cap():
    jcsr = jax_gen.poisson_2d(10, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(100))
    empty = smm.deflated_cg(tcsr, b, epsilon=1e-10, deflation_basis=torch.zeros(100, 0,
                                                                               dtype=b.dtype))
    plain = smm.cg(tcsr, b, epsilon=1e-10)
    assert (empty.status, empty.iterations) == (plain.status, plain.iterations)
    w = torch.from_numpy(np.linalg.eigh(np.asarray(jcsr.to_dense()))[1][:, :3])
    jres = jsmm.deflated_cg(jcsr, jnp.asarray(b.numpy()), epsilon=1e-14, max_iterations=4,
                            deflation_basis=jnp.asarray(w.numpy()))
    tres = smm.deflated_cg(tcsr, b, epsilon=1e-14, max_iterations=4, deflation_basis=w)
    assert tres.status == int(jres.status) == int(S.MAX_ITERATIONS_REACHED)
    assert tres.iterations == int(jres.iterations) == 4
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-10)
    with pytest.raises(ValueError, match="deflation basis"):
        smm.deflated_cg(tcsr, b, deflation_basis=w[:50])


def test_deflated_cg_reordered_permutes_the_basis():
    """A ReorderedMatrix (RCM + W-SELL) solves in the permuted domain with
    the basis rows permuted too: the result is the JAX package's on the
    original matrix."""
    jcsr = jax_gen.poisson_2d(24, dtype=np.float64)
    perm = np.random.default_rng(4).permutation(576)
    from sparse_matrix_math_tpu.formats.reorder import permute_csr as jax_permute_csr

    jshuf = jax_permute_csr(jcsr, perm)
    reordered = smm.reorder_to_wsell(port_csr(jshuf))
    assert isinstance(reordered, smm.ReorderedMatrix)
    b = np.random.default_rng(5).standard_normal(576)
    w = np.linalg.eigh(np.asarray(jshuf.to_dense()))[1][:, :6]
    jres = jsmm.deflated_cg(jshuf, jnp.asarray(b), epsilon=1e-10,
                            deflation_basis=jnp.asarray(w))
    tres = smm.deflated_cg(reordered, torch.from_numpy(b), epsilon=1e-10,
                           deflation_basis=torch.from_numpy(w))
    assert tres.status == int(S.SUCCESS)
    assert_parity(tres, jres, np.float64)
