"""The port's CG, PCG-Jacobi and BiCGStab (sparse_matrix_math_tpu_torch)
held against the JAX package's padded solve path, run on the CPU with the
Pallas kernel in interpret mode.

Tolerances: in f64 at eps 1e-8 the status and iteration count are
identical and x agrees to 1e-10 relative to max|x| (only the dots' summation
order differs); BiCGStab's x is held to the bound its residuals give (see
test_f64_matches_jax).  In f32 at eps 1e-5 the status is identical and the
iteration counts agree within max(2, 2%): f32 rounding differences move the
step at which the recurrence crosses eps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.precond.preconditioners import (
    JacobiPreconditioner as JaxJacobi,
)
from sparse_matrix_math_tpu.solvers._padded import padded_solve as jax_padded_solve
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.dia import DIAMatrix

MATRICES = ["poisson_2d", "convection_diffusion_2d"]
SOLVERS = [("cg", False), ("cg", True), ("bicgstab", False)]
SOLVER_IDS = ["cg", "cg_jacobi", "bicgstab"]


def _systems(name, n, dtype, rhs="rand"):
    """JAX DIA matrix, CSR and rhs, and the port's twins through interop."""
    jcsr = getattr(jax_gen, name)(n, dtype=dtype)
    jdia = jax_dia_from_csr(jcsr)
    if rhs == "rand":
        b = np.random.default_rng(0).standard_normal(jcsr.shape[0]).astype(dtype)
    else:
        b = np.asarray(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], dtype)))
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    return jcsr, jdia, tcsr, tdia, b


def _solve_both(core, jacobi, jcsr, jdia, tdia, b, eps, record=False):
    jpre = JaxJacobi.from_matrix(jcsr) if jacobi else None
    jb = jnp.asarray(b)
    jres = jax_padded_solve(core, jdia, jb, jnp.zeros_like(jb), eps, b.shape[0], record,
                            preconditioner=jpre, interpret=True)
    assert jres is not None
    tpre = interop.jacobi_from_numpy(np.asarray(jpre.inv_diag), "cpu") if jacobi else None
    solver = smm.cg if core == "cg" else smm.bicgstab
    tres = solver(tdia, torch.tensor(b), epsilon=eps, preconditioner=tpre,
                  record_residuals=record)
    return jres, tres


@pytest.mark.parametrize("core,jacobi", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("name", MATRICES)
def test_f64_matches_jax(name, core, jacobi):
    """CG's x agrees to 1e-10 relative to max|x|.  BiCGStab's x is held to
    what the two solves guarantee, since its short recurrences carry a
    one-ulp difference in a dot forward: on poisson_2d(16) the traces part at
    step 3, and x moves by up to 3.4e-9 (1.35e-9 max|x|) between summation
    orders of the dots (BLAS ddot, torch.sum, pairwise, sequential, the
    correctly rounded sum) on one CPU, each order's x solving the system.
    With r = b - A x for each solve, x_port - x_jax = A^-1 (r_jax - r_port),
    so |x_port - x_jax|_inf <= ||A^-1||_2 (||r_port||_2 + ||r_jax||_2)."""
    jcsr, jdia, _, tdia, b = _systems(name, 16, np.float64)
    jres, tres = _solve_both(core, jacobi, jcsr, jdia, tdia, b, 1e-8)
    assert tres.status == int(jres.status)
    assert tres.iterations == int(jres.iterations)
    jx, tx = np.asarray(jres.x), tres.x.numpy()
    if core == "bicgstab":
        dense = np.asarray(jcsr.to_dense())
        inv_norm = 1.0 / np.linalg.svd(dense, compute_uv=False)[-1]
        bound = inv_norm * (np.linalg.norm(b - dense @ tx) + np.linalg.norm(b - dense @ jx))
    else:
        bound = 1e-10 * np.abs(jx).max()
    assert np.abs(tx - jx).max() <= bound
    # near eps the residual moves by ||A|| * |dx|: compare it to 0.1 eps
    assert abs(float(tres.residual_norm) - float(jres.residual_norm)) <= 1e-9
    assert tres.floor_hit == bool(jres.floor_hit)


@pytest.mark.parametrize("core,jacobi", SOLVERS, ids=SOLVER_IDS)
@pytest.mark.parametrize("name", MATRICES)
def test_f32_matches_jax(name, core, jacobi):
    jcsr, jdia, _, tdia, b = _systems(name, 16, np.float32)
    jres, tres = _solve_both(core, jacobi, jcsr, jdia, tdia, b, 1e-5)
    assert tres.status == int(jres.status)
    j_its = int(jres.iterations)
    assert abs(tres.iterations - j_its) <= max(2, 0.02 * j_its)
    assert tres.x.dtype == torch.float32 and tres.residual_norm.dtype == torch.float32


@pytest.mark.parametrize("core", ["cg", "bicgstab"])
def test_f32_precision_floor(core):
    """poisson_2d(48), b = A @ ones, f32 at eps 1e-7 is below the f32
    floor: both packages stop with MAX_ITERATIONS_REACHED and floor_hit (the
    JAX side after 152 CG / 121 BiCGStab iterations; the counts are not
    held equal here)."""
    jcsr, jdia, _, tdia, b = _systems("poisson_2d", 48, np.float32, rhs="ones")
    jres, tres = _solve_both(core, False, jcsr, jdia, tdia, b, 1e-7)
    assert int(jres.status) == tres.status == smm.SolverStatus.MAX_ITERATIONS_REACHED
    assert bool(jres.floor_hit) and tres.floor_hit and tres.hit_precision_floor
    assert tres.iterations < b.shape[0]


def test_residual_trace_matches_jax():
    jcsr, jdia, _, tdia, b = _systems("poisson_2d", 16, np.float64)
    for core in ("cg", "bicgstab"):
        jres, tres = _solve_both(core, False, jcsr, jdia, tdia, b, 1e-8, record=True)
        jt, tt = np.asarray(jres.residual_trace), tres.residual_trace.numpy()
        assert tt.shape == jt.shape
        np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
        ok = ~np.isnan(jt)
        np.testing.assert_allclose(tt[ok], jt[ok], rtol=0, atol=1e-9 * jt[0])
        if core == "cg":  # its final residuals agree to the repr's 4 digits
            assert repr(tres) == repr(jres)


@pytest.mark.parametrize("core", ["cg", "bicgstab"])
def test_max_iterations_zero(core):
    jcsr, jdia, _, tdia, b = _systems("poisson_2d", 8, np.float64)
    jsolver, tsolver = (jsmm.cg, smm.cg) if core == "cg" else (jsmm.bicgstab, smm.bicgstab)
    jres = jsolver(jdia, jnp.asarray(b), max_iterations=0)
    tres = tsolver(tdia, torch.from_numpy(b), max_iterations=0)
    assert tres.status == int(jres.status) == smm.SolverStatus.MAX_ITERATIONS_REACHED
    assert tres.iterations == int(jres.iterations) == 0
    np.testing.assert_allclose(float(tres.residual_norm), float(jres.residual_norm), rtol=1e-12)


@pytest.mark.parametrize("core", ["cg", "bicgstab"])
def test_zero_rhs(core):
    _, _, _, tdia, b = _systems("poisson_2d", 8, np.float64)
    tsolver = smm.cg if core == "cg" else smm.bicgstab
    res = tsolver(tdia, torch.zeros(b.shape[0], dtype=torch.float64))
    assert res.success and res.iterations == 0 and float(res.residual_norm) == 0.0
    assert torch.all(res.x == 0)


def test_jacobi_zero_diagonal_raises():
    from sparse_matrix_math_tpu.precond import FactorizationError as JaxFactorizationError

    dense = np.array([[0.0, 1.0], [1.0, 2.0]])
    jcsr = jsmm.csr_from_dense(dense)
    with pytest.raises(JaxFactorizationError):
        JaxJacobi.from_matrix(jcsr)
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    with pytest.raises(smm.FactorizationError):
        smm.JacobiPreconditioner.from_matrix(tcsr)


def test_generic_paths_match_jax():
    """Operators the padded path does not take (CSR, DIA with an Identity
    preconditioner, dense, callables) run the same cores over rmult."""
    jcsr, jdia, tcsr, tdia, b = _systems("poisson_2d", 12, np.float64)
    jres = jsmm.cg(jcsr, jnp.asarray(b), epsilon=1e-10)
    bt = torch.from_numpy(b)
    for op, pre in ((tcsr, None), (tdia, smm.IdentityPreconditioner()),
                    (tcsr.to_dense(), None), (lambda v: tcsr @ v, None)):
        tres = smm.cg(op, bt, epsilon=1e-10, preconditioner=pre)
        assert tres.status == int(jres.status) and tres.iterations == int(jres.iterations)
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    jres = jsmm.bicgstab(jcsr, jnp.asarray(b), epsilon=1e-10)
    tres = smm.bicgstab(tcsr, bt, epsilon=1e-10)
    assert tres.status == int(jres.status) and tres.iterations == int(jres.iterations)


def test_mixed_dtypes_promote():
    _, _, _, tdia, b = _systems("poisson_2d", 8, np.float32)
    res = smm.cg(tdia, torch.from_numpy(b.astype(np.float64)), epsilon=1e-8)
    assert res.success and res.x.dtype == torch.float64
    res = smm.bicgstab(DIAMatrix(diags=tdia.diags.double(), offsets=tdia.offsets,
                                 shape=tdia.shape, nnz=tdia.nnz),
                       torch.from_numpy(b), epsilon=1e-8)
    assert res.success and res.x.dtype == torch.float64
