"""The port's GMRES (solvers/gmres.py) held against the JAX package's.

Same systems (generated, made from a seed with NumPy) through both packages:
restarted GMRES and its s-step form (BCGS2 + CholQR2), right
preconditioning, the cap counted in matvecs (mid-cycle, and at block
granularity), the residual trace, an exact Krylov breakdown, ``restart``
rounded to a multiple of ``s_step``, and a DIA operator (the one-shot DIA
product's plain version on the CPU).

Tolerances: the panel products ``V @ w`` sum in another order than
``jnp``'s, and the port rotates each new column by the product of the
rotations so far, so f64 iterations agree within max(2, 2%) and x within
1e-8 of ||x||; f32 iterations within max(3, 10%), x within 1e-3 of ||x||.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.precond.preconditioners import get_preconditioner as jax_precond
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from test_torch_wsell import port_csr

S = smm.SolverStatus


def band(its: int, dtype) -> int:
    return max(3, int(0.1 * its)) if dtype == np.float32 else max(2, int(0.02 * its))


def assert_parity(tres, jres, dtype):
    assert tres.status == int(jres.status), (tres, jres)
    its = int(jres.iterations)
    assert abs(tres.iterations - its) <= band(its, dtype), (tres, jres)
    jx, tx = np.asarray(jres.x, np.float64), tres.x.double().numpy()
    xtol = 1e-3 if dtype == np.float32 else 1e-8
    assert np.linalg.norm(tx - jx) <= xtol * np.linalg.norm(jx)
    # residual_norm is the true residual in both
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm),
                                                      rel=1e-2 if dtype == np.float32 else 1e-6,
                                                      abs=1e-12)


def conv_system(n=16, dtype=np.float64, seed=0):
    jcsr = jax_gen.convection_diffusion_2d(n, dtype=dtype)
    b = np.random.default_rng(seed).standard_normal(jcsr.shape[0]).astype(dtype)
    return jcsr, port_csr(jcsr), b


@pytest.mark.parametrize("restart,s_step", [(32, 1), (8, 1), (32, 4), (8, 4), (12, 3),
                                            (16, 1), (16, 8), (6, 2)])
def test_gmres_f64_matches_jax(restart, s_step):
    jcsr, tcsr, b = conv_system()
    kw = dict(epsilon=1e-9, restart=restart, s_step=s_step, max_iterations=3000)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), **kw)
    tres = smm.gmres(tcsr, torch.from_numpy(b), **kw)
    assert tres.status == int(S.SUCCESS)
    assert_parity(tres, jres, np.float64)


@pytest.mark.parametrize("s_step", [1, 4])
def test_gmres_f32_matches_jax(s_step):
    jcsr, tcsr, b = conv_system(20, np.float32, seed=1)
    kw = dict(epsilon=1e-3, restart=16, s_step=s_step, max_iterations=4000)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), **kw)
    tres = smm.gmres(tcsr, torch.from_numpy(b), **kw)
    assert_parity(tres, jres, np.float32)


@pytest.mark.parametrize("s_step", [1, 4])
def test_gmres_ilu0_right_preconditioned(s_step):
    jcsr, tcsr, b = conv_system(20, seed=2)
    kw = dict(epsilon=1e-9, restart=16, s_step=s_step)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), preconditioner=jax_precond(jcsr, "ilu0"), **kw)
    tres = smm.gmres(tcsr, torch.from_numpy(b),
                     preconditioner=smm.get_preconditioner(tcsr, "ilu0"), **kw)
    plain = smm.gmres(tcsr, torch.from_numpy(b), **kw)
    assert tres.status == int(S.SUCCESS) and tres.iterations < plain.iterations
    assert_parity(tres, jres, np.float64)


@pytest.mark.parametrize("s_step,cap,expect", [(1, 13, 13), (4, 13, 12), (1, 0, 0),
                                               (1, 5, 5), (4, 9, 8), (1, 21, 21), (4, 21, 20)])
def test_gmres_cap_in_matvecs(s_step, cap, expect):
    jcsr, tcsr, b = conv_system()
    kw = dict(epsilon=1e-12, restart=8, s_step=s_step, max_iterations=cap)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), **kw)
    tres = smm.gmres(tcsr, torch.from_numpy(b), **kw)
    assert tres.status == int(jres.status) == int(S.MAX_ITERATIONS_REACHED)
    assert tres.iterations == int(jres.iterations) == expect
    true = np.linalg.norm(b - tcsr.to_dense().numpy() @ tres.x.numpy())
    assert float(tres.residual_norm) == pytest.approx(true, rel=1e-10)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(jres.x)).max(initial=1.0))


@pytest.mark.parametrize("s_step", [1, 2, 4])
def test_gmres_residual_trace(s_step):
    jcsr, tcsr, b = conv_system(12, seed=3)
    kw = dict(epsilon=1e-8, restart=8, s_step=s_step, max_iterations=200,
              record_residuals=True)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), **kw)
    tres = smm.gmres(tcsr, torch.from_numpy(b), **kw)
    assert tres.iterations == int(jres.iterations)
    jt, tt = np.asarray(jres.residual_trace), tres.residual_trace.numpy()
    assert tt.shape == jt.shape
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    live = ~np.isnan(jt)
    np.testing.assert_allclose(tt[live], jt[live], rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("eigs", [(3.0,), (1.0, 4.0), (1.0, 2.0, 5.0), (1.0, 2.0, 5.0, 9.0)])
def test_gmres_exact_breakdown_is_guarded(eigs):
    """A diagonal matrix with k distinct eigenvalues: the Krylov space is
    exhausted at step k (h_{k,k-1} = 0), which ``safe`` guards; both
    packages return SUCCESS after k steps with the exact solution."""
    d = np.repeat(np.asarray(eigs), 12 // len(eigs))
    jcsr = jsmm.csr_from_dense(np.diag(d))
    tcsr = port_csr(jcsr)
    b = np.random.default_rng(4).standard_normal(12)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), epsilon=1e-10)
    tres = smm.gmres(tcsr, torch.from_numpy(b), epsilon=1e-10)
    assert tres.status == int(jres.status) == int(S.SUCCESS)
    assert tres.iterations == int(jres.iterations) == len(eigs)
    np.testing.assert_allclose(tres.x.numpy(), b / d, rtol=1e-12)


def test_gmres_zero_rhs_and_bad_restart():
    _, tcsr, b = conv_system(8)
    res = smm.gmres(tcsr, torch.zeros(64, dtype=torch.float64))
    assert res.status == int(S.SUCCESS) and res.iterations == 0
    with pytest.raises(ValueError, match="restart"):
        smm.gmres(tcsr, torch.from_numpy(b), restart=0)


@pytest.mark.parametrize("s_step", [1, 4])
def test_gmres_dia_operator(s_step):
    """On a DIA matrix every matvec is the one-shot DIA product (K1 on a
    card; its plain version here)."""
    jcsr, tcsr, b = conv_system(14, seed=5)
    jdia = jsmm.dia_from_csr(jcsr)
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape, jdia.nnz,
                                  "cpu")
    kw = dict(epsilon=1e-9, restart=16, s_step=s_step)
    jres = jsmm.gmres(jdia, jnp.asarray(b), **kw)
    tres = smm.gmres(tdia, torch.from_numpy(b), **kw)
    assert_parity(tres, jres, np.float64)


def test_gmres_sstep_identity_chain():
    """The s-step power chain of the identity collapses (every new power is
    the old one): both packages stop at the same status after the first
    cycle solved the system."""
    jcsr = jsmm.csr_from_dense(np.eye(16))
    tcsr = port_csr(jcsr)
    b = np.random.default_rng(6).standard_normal(16)
    jres = jsmm.gmres(jcsr, jnp.asarray(b), epsilon=1e-10, restart=8, s_step=4)
    tres = smm.gmres(tcsr, torch.from_numpy(b), epsilon=1e-10, restart=8, s_step=4)
    assert tres.status == int(jres.status)
    assert tres.iterations == int(jres.iterations)
