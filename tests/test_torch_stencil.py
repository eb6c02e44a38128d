"""The port's grid-stencil route, BiCGSymmetric, CGS and the Chebyshev
preconditioner held against the JAX package.

* Detection: ``try_grid_stencil_from_csr`` accepts and refuses what the JAX
  detector does, with the same coefficients, grid offsets and grid shape.
* Apply: ``apply_grid``, ``apply_batched`` and ``rmult`` add the shifted
  slices in the stencil's point order in both packages: f64 to 1e-12 and f32
  to 1e-6 of the largest |y| (XLA may fuse a multiply with an add).
* Solves: ``stencil_solve`` for the four cores and Jacobi / Chebyshev PCG, and
  ``bicg_symmetric`` / ``cgs`` on the generic and the padded path (the JAX
  padded path run in interpret mode).  The status is the JAX package's.  CG
  and BiCGSymmetric: iteration counts within 1 in f64 (the dots sum in
  another order) and max(2, 3%) in f32, x to 1e-9 (f64) or 2e-3 (f32) of
  max|x|.  BiCGStab and CGS square or stabilise the residual polynomial and
  their counts wander with rounding in both packages: within max(3, 5%) in
  f64 and max(3, 10%) in f32, x to 1e-6 (f64) or 2e-3 (f32) of max|x|.
* ``DfGridStencil`` against the JAX double-word stencil: relative 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.formats.stencil import (
    try_grid_stencil_from_csr as jax_try_stencil,
)
from sparse_matrix_math_tpu.ops.df32 import DfGridStencil as JaxDfGridStencil
from sparse_matrix_math_tpu.ops.df32 import df_from_host as jax_df_from_host
from sparse_matrix_math_tpu.precond.cheby_poly import (
    ChebyshevPreconditioner as JaxChebyshev,
)
from sparse_matrix_math_tpu.precond.preconditioners import JacobiPreconditioner as JaxJacobi
from sparse_matrix_math_tpu.solvers._padded import padded_solve as jax_padded_solve
from sparse_matrix_math_tpu.solvers.chebyshev import lanczos_extremal as jax_lanczos
from sparse_matrix_math_tpu.solvers.chebyshev import widen_eig_bounds as jax_widen
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.stencil import (
    GridStencilMatrix,
    try_grid_stencil_from_csr,
    try_grid_stencil_from_dia,
)
from sparse_matrix_math_tpu_torch.ops.df32 import DfGridStencil, df_from_host, df_to_host
from sparse_matrix_math_tpu_torch.precond.cheby_poly import (
    ChebyshevPreconditioner,
    cheby_apply_fn,
    lanczos_extremal,
    widen_eig_bounds,
)
from sparse_matrix_math_tpu_torch.solvers import _padded, _stencil
from sparse_matrix_math_tpu_torch.solvers.df64 import _as_df_operator
from sparse_matrix_math_tpu_torch.solvers.ir_df64 import hi_operator
from test_torch_wsell import port_csr

REL = {np.float32: 1e-6, np.float64: 1e-12}
STENCILS = [
    ("poisson_2d(20)", lambda d: jax_gen.poisson_2d(20, dtype=d), None),
    ("poisson_2d(12x17)", lambda d: jax_gen.poisson_2d(12, 17, dtype=d), (17, 12)),
    ("poisson_3d(7)", lambda d: jax_gen.poisson_3d(7, dtype=d), None),
    ("convection_diffusion_2d(15)", lambda d: jax_gen.convection_diffusion_2d(15, dtype=d), None),
    ("poisson_3d_27pt(6)", lambda d: jax_gen.poisson_3d_27pt(6, dtype=d), None),
]
CORES = ["cg", "bicg_symmetric", "cgs", "bicgstab"]


def port_stencil(jst):
    return interop.grid_stencil_from_numpy(np.asarray(jst.coeffs), jst.doffs, jst.dims,
                                           jst.shape, jst.nnz, "cpu")


def assert_close(got, want, dtype):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL[dtype] * scale)


# -- detection and apply -------------------------------------------------------------


@pytest.mark.parametrize("name,make,dims", STENCILS, ids=[s[0] for s in STENCILS])
def test_detection_matches_jax(name, make, dims, dtype):
    jcsr = make(dtype)
    jst = jax_try_stencil(jcsr, dims)
    tst = try_grid_stencil_from_csr(port_csr(jcsr), dims)
    assert jst is not None and isinstance(tst, GridStencilMatrix)
    assert (tst.doffs, tst.dims, tst.shape, tst.nnz) == (jst.doffs, jst.dims, jst.shape, jst.nnz)
    np.testing.assert_array_equal(tst.coeffs.numpy(), np.asarray(jst.coeffs))
    assert tst.dtype == port_csr(jcsr).dtype
    # from the DIA matrix, and with the DIA matrix handed in
    tdia = smm.dia_from_csr(port_csr(jcsr))
    for other in (try_grid_stencil_from_dia(tdia, dims),
                  try_grid_stencil_from_csr(port_csr(jcsr), dims, dia=tdia)):
        assert other.doffs == tst.doffs and torch.equal(other.coeffs, tst.coeffs)


@pytest.mark.parametrize("name,make,dims", STENCILS, ids=[s[0] for s in STENCILS])
def test_apply_matches_jax(name, make, dims, dtype):
    jcsr = make(dtype)
    jst = jax_try_stencil(jcsr, dims)
    tst = port_stencil(jst)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(jcsr.shape[0]).astype(dtype)
    assert_close((tst @ torch.from_numpy(x)).numpy(), jst @ jnp.asarray(x), dtype)
    assert_close(smm.rmult(tst, torch.from_numpy(x)).numpy(), jsmm.rmult(jcsr, jnp.asarray(x)),
                 dtype)
    xg = x.reshape(jst.dims)
    assert_close(tst.apply_grid(torch.from_numpy(xg)).numpy(), jst.apply_grid(jnp.asarray(xg)),
                 dtype)
    panel = rng.standard_normal((jcsr.shape[0], 3)).astype(dtype)
    assert_close((tst @ torch.from_numpy(panel)).numpy(), jst @ jnp.asarray(panel), dtype)
    lead = rng.standard_normal((2,) + tuple(jst.dims)).astype(dtype)
    assert_close(tst.apply_batched(torch.from_numpy(lead)).numpy(),
                 jst.apply_batched(jnp.asarray(lead)), dtype)


def test_detection_refusals_match_jax():
    # a jittered pattern is no tensor-product stencil
    jit = jax_gen.laplace_3d_jittered(9, dtype=np.float64)
    assert jax_try_stencil(jit) is None and try_grid_stencil_from_csr(port_csr(jit)) is None
    # the stencil's pattern with one value changed
    a = jax_gen.poisson_2d(10, dtype=np.float64)
    data = np.asarray(a.data).copy()
    data[len(data) // 2] *= 1.5
    a2 = a.with_data(jnp.asarray(data))
    assert jax_try_stencil(a2) is None and try_grid_stencil_from_csr(port_csr(a2)) is None
    # a grid shape that does not match, a rectangular matrix, a row count
    # that is neither a square nor a cube
    a3 = jax_gen.poisson_2d(12, 17, dtype=np.float64)
    assert jax_try_stencil(a3, (12, 17)) is None
    assert try_grid_stencil_from_csr(port_csr(a3), (12, 17)) is None
    assert jax_try_stencil(a3) is None and try_grid_stencil_from_csr(port_csr(a3)) is None
    rect = port_csr(jsmm.csr_from_dense(np.eye(4, 9)))
    assert try_grid_stencil_from_csr(rect) is None
    assert try_grid_stencil_from_dia(smm.dia_from_csr(rect)) is None
    # a periodic wrap is an interior cut no tensor-product grid has
    d = np.asarray(jax_gen.poisson_2d(6, dtype=np.float64).to_dense()).copy()
    d[0, 35] = d[35, 0] = -1.0
    wrap = jsmm.csr_from_dense(d)
    assert jax_try_stencil(wrap) is None and try_grid_stencil_from_csr(port_csr(wrap)) is None


def test_diagonal_dense_and_astype():
    jcsr = jax_gen.convection_diffusion_2d(9, dtype=np.float64)
    jst = jax_try_stencil(jcsr)
    tst = port_stencil(jst)
    np.testing.assert_array_equal(tst.diagonal().numpy(), np.asarray(jst.diagonal()))
    np.testing.assert_allclose(tst.to_dense().numpy(), np.asarray(jcsr.to_dense()), atol=1e-14)
    t32 = tst.astype(torch.float32)
    assert t32.dtype == torch.float32 and t32.doffs == tst.doffs
    # rmult promotes as the other formats do
    assert (t32 @ torch.ones(81, dtype=torch.float64)).dtype == torch.float64
    off_diag = GridStencilMatrix(coeffs=torch.ones(1), doffs=((0, 1),), dims=(3, 3),
                                 shape=(9, 9), nnz=6)
    assert bool((off_diag.diagonal() == 0).all())


# -- grid-resident solves ----------------------------------------------------------------


def _stencil_system(dtype, n=24, conv=False):
    make = jax_gen.convection_diffusion_2d if conv else jax_gen.poisson_2d
    jcsr = make(n, dtype=dtype)
    jst = jax_try_stencil(jcsr)
    b = np.random.default_rng(0).standard_normal(jcsr.shape[0]).astype(dtype)
    return jcsr, jst, port_stencil(jst), b


def assert_same_solve(tres, jres, dtype, wanders=False):
    """Status equal, iterations and x within the bands of the module
    docstring; ``wanders`` for BiCGStab and CGS."""
    assert tres.status == int(jres.status), (tres, jres)
    its = int(jres.iterations)
    if wanders:
        band = max(3, int((0.05 if dtype == np.float64 else 0.10) * its))
        tol = 1e-6 if dtype == np.float64 else 2e-3
    else:
        band = 1 if dtype == np.float64 else max(2, int(0.03 * its))
        tol = 1e-9 if dtype == np.float64 else 2e-3
    assert abs(tres.iterations - its) <= band, (tres, jres)
    jx = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - jx).max() <= tol * np.abs(jx).max()
    assert tres.floor_hit == bool(jres.floor_hit)


@pytest.mark.parametrize("core", CORES)
def test_stencil_solve_matches_jax(core, dtype):
    jcsr, jst, tst, b = _stencil_system(dtype)
    eps = 1e-9 if dtype == np.float64 else 1e-4
    jres = getattr(jsmm, core)(jst, jnp.asarray(b), epsilon=eps)
    assert _stencil.eligible(tst)
    tres = getattr(smm, core)(tst, torch.from_numpy(b), epsilon=eps)
    assert tres.x.shape == (jcsr.shape[0],)
    assert_same_solve(tres, jres, dtype, wanders=core in ("cgs", "bicgstab"))
    # the grid path is the flat path's arithmetic in another layout
    flat = getattr(smm, core)(lambda v: tst @ v, torch.from_numpy(b), epsilon=eps)
    assert flat.status == tres.status and abs(flat.iterations - tres.iterations) <= 3


def test_stencil_bicgstab_nonsymmetric_matches_jax():
    jcsr, jst, tst, b = _stencil_system(np.float64, n=20, conv=True)
    jres = jsmm.bicgstab(jst, jnp.asarray(b), epsilon=1e-10)
    tres = smm.bicgstab(tst, torch.from_numpy(b), epsilon=1e-10)
    assert_same_solve(tres, jres, np.float64, wanders=True)


@pytest.mark.parametrize("kind", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("core", ["cg", "bicgstab"])
def test_stencil_preconditioned_matches_jax(core, kind, dtype):
    jcsr, jst, tst, b = _stencil_system(dtype)
    eps = 1e-9 if dtype == np.float64 else 1e-4
    if kind == "jacobi":
        jpre = JaxJacobi(inv_diag=1.0 / jst.diagonal())
        tpre = smm.JacobiPreconditioner(inv_diag=1.0 / tst.diagonal())
    else:
        jpre = JaxChebyshev.from_matrix(jst, degree=3, eig_bounds=(0.02, 8.0))
        tpre = ChebyshevPreconditioner.from_matrix(tst, degree=3, eig_bounds=(0.02, 8.0))
    assert _stencil.eligible(tst, tpre)
    jres = getattr(jsmm, core)(jst, jnp.asarray(b), epsilon=eps, preconditioner=jpre)
    tres = getattr(smm, core)(tst, torch.from_numpy(b), epsilon=eps, preconditioner=tpre)
    assert_same_solve(tres, jres, dtype, wanders=core == "bicgstab")


def test_stencil_trace_matches_jax():
    _, jst, tst, b = _stencil_system(np.float64)
    jres = jsmm.cg(jst, jnp.asarray(b), epsilon=1e-9, record_residuals=True)
    tres = smm.cg(tst, torch.from_numpy(b), epsilon=1e-9, record_residuals=True)
    jt, tt = np.asarray(jres.residual_trace), tres.residual_trace.numpy()
    k = min(tres.iterations, int(jres.iterations))
    np.testing.assert_allclose(tt[:k + 1], jt[:k + 1], rtol=1e-6)
    assert np.isnan(tt[tres.iterations + 1:]).all()


def test_stencil_floor_and_edge_cases_match_jax():
    """The contract of the JAX package's host-driven big-n CG loop
    (the HBM-regime cases of tests/test_stencil.py), which the port's one path
    serves: a floor is reported with floor_hit, a cap is not a floor, a zero
    right-hand side succeeds before iterating."""
    jst = jax_try_stencil(jax_gen.poisson_2d(48, dtype=np.float32))
    tst = port_stencil(jst)
    b = np.asarray(jst @ jnp.ones(jst.shape[0], jnp.float32))
    floored = smm.cg(tst, torch.tensor(b), epsilon=1e-12, max_iterations=4000)
    jfloored = jsmm.cg(jst, jnp.asarray(b), epsilon=1e-12, max_iterations=4000)
    assert floored.status == int(jfloored.status) == smm.SolverStatus.MAX_ITERATIONS_REACHED
    assert floored.floor_hit and bool(jfloored.floor_hit)
    capped = smm.cg(tst, torch.tensor(b), epsilon=1e-5, max_iterations=0)
    assert capped.status == smm.SolverStatus.MAX_ITERATIONS_REACHED
    assert capped.iterations == 0 and not capped.floor_hit
    zero = smm.cg(tst, torch.zeros(jst.shape[0]), epsilon=1e-5)
    assert zero.status == smm.SolverStatus.SUCCESS and zero.iterations == 0
    ok = smm.cg(tst, torch.tensor(b), epsilon=1e-4, max_iterations=4000)
    jok = jsmm.cg(jst, jnp.asarray(b), epsilon=1e-4, max_iterations=4000)
    assert ok.status == int(jok.status) == 0
    assert abs(ok.iterations - int(jok.iterations)) <= 2


def test_stencil_solve_refuses_what_the_grid_cannot_hold():
    _, _, tst, b = _stencil_system(np.float64, n=8)
    other = ChebyshevPreconditioner(a=port_stencil(jax_try_stencil(
        jax_gen.poisson_2d(8, dtype=np.float64))), lmin=0.1, lmax=8.0, degree=2)
    assert not _stencil.eligible(tst, other) and not _stencil.eligible(tst, object())
    assert not _stencil.eligible(smm.dia_from_csr(smm.poisson_2d(8, device="cpu")))
    with pytest.raises(ValueError, match="grid-layout"):
        _stencil.stencil_solve("cg", tst, torch.from_numpy(b), torch.zeros(64, dtype=torch.float64),
                               1e-8, 64, False, preconditioner=other)
    with pytest.raises(ValueError, match="no grid-resident solve"):
        _stencil.stencil_solve("gmres", tst, torch.from_numpy(b),
                               torch.zeros(64, dtype=torch.float64), 1e-8, 64, False)
    # a preconditioner of another operator takes the generic path and still solves
    res = smm.cg(tst, torch.from_numpy(b), epsilon=1e-9, preconditioner=other)
    assert res.status == 0


# -- BiCGSymmetric and CGS -----------------------------------------------------------------

SPD_SYSTEMS = [
    ("poisson_2d(8)", lambda d: jax_gen.poisson_2d(8, 8, dtype=d)),
    ("laplace_1d(40)", lambda d: jax_gen.laplace_1d(40, dtype=d)),
    ("random_spd(120)", lambda d: jax_gen.random_spd_csr(120, density=0.05, seed=3, dtype=d)),
]


@pytest.mark.parametrize("name,make", SPD_SYSTEMS, ids=[s[0] for s in SPD_SYSTEMS])
@pytest.mark.parametrize("method", ["bicg_symmetric", "cgs"])
def test_generic_path_matches_jax(method, name, make, dtype):
    """The JAX solver tests' own form (tests/test_solvers.py): b = row sums,
    x = ones, eps 1e-4 in f32 and 1e-8 in f64."""
    jcsr = make(dtype)
    b = np.asarray(jcsr @ jnp.ones(jcsr.shape[0], dtype)).astype(dtype)
    eps = 1e-4 if dtype == np.float32 else 1e-8
    jres = getattr(jsmm, method)(jcsr, jnp.asarray(b), epsilon=eps)
    tres = getattr(smm, method)(port_csr(jcsr), torch.tensor(b), epsilon=eps)
    assert tres.status == int(jres.status) == 0
    assert abs(tres.iterations - int(jres.iterations)) <= (1 if dtype == np.float64 else 2)
    assert np.abs(tres.x.numpy() - 1.0).max() <= (1e-7 if dtype == np.float64 else 1e-3)
    assert np.abs(tres.x.numpy() - np.asarray(jres.x)).max() <= (1e-9 if dtype == np.float64
                                                                  else 1e-3)


@pytest.mark.parametrize("method", ["bicg_symmetric", "cgs"])
def test_padded_path_matches_jax(method, dtype):
    jcsr = jax_gen.poisson_2d(16, dtype=dtype)
    jdia = jax_dia_from_csr(jcsr)
    tdia = smm.dia_from_csr(port_csr(jcsr))
    b = np.random.default_rng(0).standard_normal(jcsr.shape[0]).astype(dtype)
    eps = 1e-8 if dtype == np.float64 else 1e-5
    jb = jnp.asarray(b)
    jres = jax_padded_solve(method, jdia, jb, jnp.zeros_like(jb), eps, b.shape[0], False,
                            interpret=True)
    assert _padded.eligible(tdia)
    tres = getattr(smm, method)(tdia, torch.from_numpy(b), epsilon=eps)
    assert_same_solve(tres, jres, dtype, wanders=method == "cgs")
    with pytest.raises(ValueError, match="does not take a preconditioner"):
        _padded.padded_solve(method, tdia, torch.from_numpy(b), torch.zeros_like(
            torch.from_numpy(b)), eps, 10, False,
            preconditioner=smm.JacobiPreconditioner.from_matrix(port_csr(jcsr)))


@pytest.mark.parametrize("method", ["bicg_symmetric", "cgs"])
def test_do_while_cap_and_trace_match_jax(method):
    jcsr = jax_gen.poisson_2d(10, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = np.asarray(jcsr @ jnp.ones(100))
    # already converged x0: the first iteration still runs (do-while)
    jres = getattr(jsmm, method)(jcsr, jnp.asarray(b), x0=jnp.ones(100), epsilon=1e-8)
    tres = getattr(smm, method)(tcsr, torch.tensor(b), x0=torch.ones(100, dtype=torch.float64),
                                epsilon=1e-8)
    assert (tres.status, tres.iterations) == (int(jres.status), int(jres.iterations))
    # the cap is reported as such
    jcap = getattr(jsmm, method)(jcsr, jnp.asarray(b), max_iterations=2, epsilon=1e-12)
    tcap = getattr(smm, method)(tcsr, torch.tensor(b), max_iterations=2, epsilon=1e-12)
    assert tcap.status == int(jcap.status) == smm.SolverStatus.MAX_ITERATIONS_REACHED
    assert tcap.iterations == int(jcap.iterations) == 2 and not tcap.floor_hit
    np.testing.assert_allclose(float(tcap.residual_norm), float(jcap.residual_norm), rtol=1e-10)
    jtr = getattr(jsmm, method)(jcsr, jnp.asarray(b), epsilon=1e-8, record_residuals=True)
    ttr = getattr(smm, method)(tcsr, torch.tensor(b), epsilon=1e-8, record_residuals=True)
    k = min(ttr.iterations, int(jtr.iterations))
    np.testing.assert_allclose(ttr.residual_trace.numpy()[:k + 1],
                               np.asarray(jtr.residual_trace)[:k + 1], rtol=1e-6, atol=1e-12)


def test_bicg_symmetric_serious_breakdown_matches_jax():
    """An indefinite diagonal makes Ap . p vanish with a large residual: the
    reference's serious-breakdown heuristic ends in DIVERGED in both."""
    d = np.diag(np.array([1.0, -1.0, 1.0, -1.0]) * 3.0)
    jcsr = jsmm.csr_from_dense(d)
    b = np.array([3.0, 3.0, 3.0, 3.0])
    jres = jsmm.bicg_symmetric(jcsr, jnp.asarray(b), epsilon=1e-8)
    tres = smm.bicg_symmetric(port_csr(jcsr), torch.tensor(b), epsilon=1e-8)
    assert tres.status == int(jres.status) == smm.SolverStatus.DIVERGED
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=1e-12)


def test_cgs_nonsymmetric_matches_jax():
    jcsr = jax_gen.convection_diffusion_2d(12, dtype=np.float64)
    b = np.random.default_rng(1).standard_normal(144)
    jres = jsmm.cgs(jcsr, jnp.asarray(b), epsilon=1e-9)
    tres = smm.cgs(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-9)
    assert_same_solve(tres, jres, np.float64, wanders=True)
    assert smm.conjugate_gradient_squared is smm.cgs


# -- the Chebyshev preconditioner ------------------------------------------------------------


@pytest.mark.parametrize("degree", [1, 2, 5])
def test_chebyshev_apply_matches_jax(degree, dtype):
    jcsr = jax_gen.poisson_2d(12, dtype=dtype)
    jpre = JaxChebyshev.from_matrix(jcsr, degree=degree, eig_bounds=(0.05, 7.9))
    tpre = ChebyshevPreconditioner.from_matrix(port_csr(jcsr), degree=degree,
                                               eig_bounds=(0.05, 7.9))
    r = np.random.default_rng(2).standard_normal(144).astype(dtype)
    got = tpre.apply(torch.from_numpy(r)).numpy()
    want = np.asarray(jpre.apply(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=0, atol=(1e-12 if dtype == np.float64 else 2e-6)
                               * np.abs(want).max())
    # the closure over another layout's matvec: the grid
    tst = try_grid_stencil_from_csr(port_csr(jcsr))
    grid = cheby_apply_fn(tst.apply_grid, 0.05, 7.9, degree)(torch.from_numpy(r).reshape(12, 12))
    np.testing.assert_allclose(grid.reshape(-1).numpy(), got, rtol=0,
                               atol=(1e-12 if dtype == np.float64 else 2e-6) * np.abs(got).max())


def test_chebyshev_bounds_and_checks():
    for lo, hi in ((0.5, 7.0), (-1e-6, 4.0), (0.0, 1.0)):
        assert widen_eig_bounds(lo, hi) == jax_widen(lo, hi)
    with pytest.raises(ValueError, match="not positive-definite"):
        widen_eig_bounds(-3.0, -1.0)
    with pytest.raises(ValueError, match="degree"):
        ChebyshevPreconditioner.from_matrix(None, degree=0, eig_bounds=(1.0, 2.0))
    jcsr = jax_gen.poisson_2d(16, dtype=np.float64)
    true = np.linalg.eigvalsh(np.asarray(jcsr.to_dense()))
    lo, hi = lanczos_extremal(port_csr(jcsr))
    jlo, jhi = jax_lanczos(jcsr)
    # interior estimates of the same spectrum from another start vector
    assert true[0] - 1e-9 <= lo <= 2 * true[0] and 0.9 * true[-1] <= hi <= true[-1] + 1e-9
    assert abs(hi - jhi) <= 0.02 * true[-1] and abs(lo - jlo) <= true[0]
    with pytest.raises(ValueError, match="n="):
        lanczos_extremal(lambda v: v)
    d = torch.linspace(1.0, 3.0, 200)
    lo1, hi1 = lanczos_extremal(lambda v: d * v, n=200, device="cpu")
    assert 1.0 - 1e-5 <= lo1 < 1.2 and 2.8 < hi1 <= 3.0 + 1e-5
    pre = smm.get_preconditioner(port_csr(jcsr), "chebyshev", degree=3)
    assert 0 < pre.lmin < true[0] and pre.lmax > true[-1] and pre.degree == 3


def test_chebyshev_on_the_padded_path_matches_jax():
    """A Chebyshev polynomial of the DIA matrix itself runs in the padded
    layout (its apply is padded products); of another operator, generically."""
    jcsr = jax_gen.poisson_2d(16, dtype=np.float64)
    jdia = jax_dia_from_csr(jcsr)
    tdia = smm.dia_from_csr(port_csr(jcsr))
    b = np.random.default_rng(0).standard_normal(256)
    jpre = JaxChebyshev.from_matrix(jdia, degree=3, eig_bounds=(0.05, 8.0))
    tpre = ChebyshevPreconditioner.from_matrix(tdia, degree=3, eig_bounds=(0.05, 8.0))
    assert _padded.eligible(tdia, tpre)
    assert not _padded.eligible(tdia, ChebyshevPreconditioner.from_matrix(
        port_csr(jcsr), degree=3, eig_bounds=(0.05, 8.0)))
    jb = jnp.asarray(b)
    jres = jax_padded_solve("cg", jdia, jb, jnp.zeros_like(jb), 1e-9, 256, False,
                            preconditioner=jpre, interpret=True)
    tres = smm.cg(tdia, torch.from_numpy(b), epsilon=1e-9, preconditioner=tpre)
    assert_same_solve(tres, jres, np.float64)


# -- the double-word stencil -----------------------------------------------------------------


@pytest.mark.parametrize("name,make,dims", STENCILS[:4], ids=[s[0] for s in STENCILS[:4]])
def test_df_grid_stencil_matches_jax(name, make, dims):
    jcsr = make(np.float64)
    jst = jax_try_stencil(jcsr, dims)
    c64 = np.asarray(jst.coeffs, np.float64) * (1.0 + 1e-9)  # non-trivial lo words
    jdf = JaxDfGridStencil.from_stencil(jst, coeffs64=c64)
    tdf = DfGridStencil.from_stencil(port_stencil(jst), coeffs64=c64)
    np.testing.assert_array_equal(tdf.coeffs_hi.numpy(), np.asarray(jdf.coeffs_hi))
    np.testing.assert_array_equal(tdf.coeffs_lo.numpy(), np.asarray(jdf.coeffs_lo))
    assert (tdf.doffs, tdf.dims, tdf.shape, tdf.nnz) == (jdf.doffs, jdf.dims, jdf.shape, jdf.nnz)
    x = np.random.default_rng(5).standard_normal(jcsr.shape[0])
    got = df_to_host(tdf.rmult_df(df_from_host(x, device="cpu")))
    jy = jdf.rmult_df(jax_df_from_host(x))
    want = np.asarray(jy[0], np.float64) + np.asarray(jy[1], np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    exact = np.asarray(jcsr.to_dense()) * (1.0 + 1e-9) @ x
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-12 * np.abs(exact).max())


def test_df_stencil_operator_choice_and_hi_operator():
    jst = jax_try_stencil(jax_gen.poisson_2d(8, dtype=np.float32))
    tst = port_stencil(jst)
    dfa = _as_df_operator(tst)
    assert isinstance(dfa, DfGridStencil) and bool((dfa.coeffs_lo == 0).all())
    assert _as_df_operator(dfa) is dfa
    hi = hi_operator(dfa)
    assert isinstance(hi, GridStencilMatrix) and torch.equal(hi.coeffs, tst.coeffs)
    assert (hi.doffs, hi.dims, hi.shape) == (tst.doffs, tst.dims, tst.shape)
    t64 = port_stencil(jax_try_stencil(jax_gen.poisson_2d(8, dtype=np.float64)))
    split = DfGridStencil.from_stencil(dataclass_scaled(t64, 1.0 + 1e-9))
    assert bool((split.coeffs_lo != 0).any())


def dataclass_scaled(st, factor):
    return GridStencilMatrix(coeffs=st.coeffs * factor, doffs=st.doffs, dims=st.dims,
                             shape=st.shape, nnz=st.nnz)


@pytest.mark.parametrize("kind", ["none", "jacobi"])
def test_refinement_on_df_stencil_matches_jax(kind):
    """cg_ir_df64 on the double-word stencil, its inner solve grid-resident:
    status and rounds as the JAX package, inner iterations within 5%, x to
    1e-9."""
    jcsr = jax_gen.poisson_2d(32, dtype=np.float64)
    jst = jax_try_stencil(jcsr)
    b64 = np.asarray(jcsr.to_dense()).sum(axis=1)
    c64 = np.asarray(jst.coeffs, np.float64)
    jdf = JaxDfGridStencil.from_stencil(jst, coeffs64=c64)
    tdf = DfGridStencil.from_stencil(port_stencil(jst), coeffs64=c64)
    jpre = tpre = None
    if kind == "jacobi":
        jpre = JaxJacobi(inv_diag=jnp.full(1024, 0.25, jnp.float32))
        tpre = smm.JacobiPreconditioner(inv_diag=torch.full((1024,), 0.25))
    jres = jsmm.cg_ir_df64(jdf, b64, epsilon=1e-10, preconditioner=jpre)
    tres = smm.cg_ir_df64(tdf, b64, epsilon=1e-10, preconditioner=tpre)
    assert tres.status == int(jres.status) == 0
    assert tres.outer_rounds == int(jres.outer_rounds)
    assert abs(tres.iterations - int(jres.iterations)) <= max(2, 0.05 * int(jres.iterations))
    assert np.abs(tres.x_f64() - 1.0).max() < 1e-9
    assert float(np.linalg.norm(b64 - np.asarray(jcsr.to_dense()) @ tres.x_f64())) <= 1e-10
