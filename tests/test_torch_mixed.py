"""The port's mixed-precision solve (bfloat16 matrix, float32 vectors) held
against the JAX package: ``mixed_cg``, ``solve(..., matrix_dtype=...)`` and
the bfloat16-diagonal call shape of K2/K3.

The same seeded float32 systems go to both packages.  The JAX package's
``mixed_cg`` runs its Pallas kernels in interpret mode on the CPU by itself.
Held: the same status; x within atol 5e-4, rtol 1e-3 of the JAX solution;
total inner iterations within max(3, 10%) (the inner dots sum in other
orders: ``torch.dot`` here, ``jnp.sum`` there, which moves the step at
which a round's relative cut is crossed); ``residual_norm`` the float32
true residual within 2e-5.  The plain bfloat16-diagonal K2 is held bit for
bit to the JAX kernel's order written out in NumPy (each value widened
exactly, every product and sum rounded alone, ascending offsets), and to
JAX's padded and streamed kernels within ndiags * 2^-23 * max_i sum_d
|a_id x_i+d|: XLA's CPU backend contracts some of the kernel's
multiply-adds into FMAs (at 27 diagonals: an FMA-rounded NumPy sum equals
its result bit for bit), one rounding fewer per term; where it does not,
the results are equal.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr as jax_try_dia
from sparse_matrix_math_tpu.ops import pallas_spmv as jax_pallas
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.ops import dia_spmv as K

SUCCESS = smm.SolverStatus.SUCCESS
MAX = smm.SolverStatus.MAX_ITERATIONS_REACHED


def _port_dia(jdia, dtype=None):
    return interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape, jdia.nnz,
                                  "cpu", dtype=dtype)


def _port_csr(jcsr):
    return interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")


@pytest.fixture(scope="module")
def poisson():
    """poisson_2d(24) f32 in both packages, with b = A @ ones."""
    jcsr = jax_gen.poisson_2d(24, dtype=np.float32)
    jdia = jax_try_dia(jcsr)
    b = np.array(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], jnp.float32)))
    return jcsr, jdia, _port_csr(jcsr), _port_dia(jdia), b


@pytest.fixture(scope="module")
def scaled():
    """D A D of poisson_2d(24) with a seeded D: every value has full float32
    mantissa bits, so bfloat16 rounds it (tests/test_mixed.py:51-75)."""
    rng = np.random.default_rng(7)
    n = 24 * 24
    d = (1.0 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    dense = (np.asarray(jax_gen.poisson_2d(24, dtype=np.float32).to_dense())
             * np.outer(d, d)).astype(np.float32)
    jdia = jax_try_dia(jsmm.csr_from_dense(dense))
    x_true = rng.standard_normal(n).astype(np.float32)
    b = dense @ x_true
    return dense, jdia, _port_dia(jdia), b


def _assert_same(tres, jres, x_tol=True):
    assert int(tres.status) == int(jres.status)
    jits = int(jres.iterations)
    assert abs(tres.iterations - jits) <= max(3, 0.1 * jits), (tres.iterations, jits)
    if x_tol:
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), atol=5e-4, rtol=1e-3)


# -- the bfloat16-diagonal call shape of K2/K3 -----------------------------------------


def _kernel_case(name):
    if name == "scaled":
        rng = np.random.default_rng(3)
        base = jax_gen.poisson_2d(15, dtype=np.float32)
        d = (1.0 + 0.3 * rng.standard_normal(base.shape[0])).astype(np.float32)
        dense = (np.asarray(base.to_dense()) * np.outer(d, d)).astype(np.float32)
        return jax_try_dia(jsmm.csr_from_dense(dense))
    gen, arg = name.split(":")
    return jsmm.dia_from_csr(getattr(jax_gen, gen)(int(arg), dtype=np.float32))


def _sequential(bits, offsets, x):
    """y = A x in the kernel's order in NumPy float32 from the bf16 bit
    patterns (widened exactly by a 16-bit shift), and sum_d |a_id x_i+d|."""
    diags = (bits.astype(np.uint32) << 16).view(np.float32)
    n = x.shape[0]
    acc = mag = None
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, n - off)
        xs = np.zeros(n, np.float32)
        xs[lo:hi] = x[lo + off:hi + off]
        term = diags[d] * xs
        acc = term if acc is None else acc + term
        mag = np.abs(term) if mag is None else mag + np.abs(term)
    return acc, mag


KERNEL_CASES = ["poisson_2d:37", "poisson_3d_27pt:5", "convection_diffusion_2d:9", "scaled"]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_bf16_plain_matches_jax_kernels(name):
    """5 and 27 diagonals, odd n, values bfloat16 holds exactly and values
    it rounds: the port's plain bf16-diagonal K2 on the same bf16 bits as
    JAX's is the kernel's order bit for bit, guard rows exactly 0, and JAX's
    padded and streamed kernels within the FMA bound of the module doc."""
    jdia = _kernel_case(name)
    x = np.random.default_rng(1).standard_normal(jdia.shape[1]).astype(np.float32)
    jp = jax_pallas.pad_dia(jdia, rows_blk=8)
    jp_lo = dataclasses.replace(jp, diags3=jp.diags3.astype(jnp.bfloat16))
    xj = jp.to_padded(jnp.asarray(x))
    refs = [np.asarray(jp.from_padded(k(jp_lo, xj, interpret=True)))
            for k in (jax_pallas.dia_spmv_padded, jax_pallas.dia_spmv_streamed)]

    tdia = _port_dia(jdia, dtype=torch.bfloat16)
    # the interop cast and the mixed solve's replace() hold JAX's bf16 bits
    jbits = np.asarray(jdia.diags.astype(jnp.bfloat16)).view(np.uint16)
    assert np.array_equal(tdia.diags.view(torch.int16).numpy().view(np.uint16), jbits)
    p_hi = K.pad_dia(_port_dia(jdia))
    p = dataclasses.replace(p_hi, diags_p=p_hi.diags_p.to(torch.bfloat16))
    assert torch.equal(p.diags_p.view(torch.int16), K.pad_dia(tdia).diags_p.view(torch.int16))
    assert p.dtype == torch.bfloat16

    xp = p.to_padded(torch.from_numpy(x))
    yp = K.dia_spmv_padded(p, xp)
    assert yp.dtype == torch.float32 and yp.shape == (p.n_total,)
    y = p.from_padded(yp).numpy()
    seq, mag = _sequential(jbits, jdia.offsets, x)
    np.testing.assert_array_equal(y, seq)
    atol = len(jdia.offsets) * 2.0 ** -23 * float(mag.max())
    for ref in refs:
        assert ref.dtype == np.float32
        np.testing.assert_allclose(y, ref, rtol=0, atol=atol)
    n = jdia.shape[0]
    assert torch.all(yp[:p.lead] == 0) and torch.all(yp[p.lead + n:] == 0)
    assert torch.equal(K.dia_spmv_streamed(p, xp), yp)
    # the plain version widens first: the same as an f32 product on the
    # widened diagonals
    widened = dataclasses.replace(p, diags_p=p.diags_p.float())
    assert torch.equal(K.dia_spmv_padded(widened, xp), yp)


def test_bf16_wrapper_refuses_other_shapes():
    """Only bf16/f16 diagonals with a float32 x: f64 x, integer diagonals
    and the one-shot K1 raise TypeError; the CPU plain version counts no
    launch."""
    jdia = jsmm.dia_from_csr(jax_gen.poisson_2d(7, dtype=np.float32))
    a = _port_dia(jdia, dtype=torch.bfloat16)
    p = K.pad_dia(a)
    xp = torch.zeros(p.n_total, dtype=torch.float32)
    before = dict(K.launches)
    for dt in (torch.bfloat16, torch.float16):
        pd = dataclasses.replace(p, diags_p=p.diags_p.to(dt))
        assert K.dia_spmv_padded(pd, xp).dtype == torch.float32
        with pytest.raises(TypeError, match="float32"):
            K.dia_spmv_padded(pd, xp.double())
    with pytest.raises(TypeError):
        K.dia_spmv_padded(dataclasses.replace(p, diags_p=p.diags_p.to(torch.int32)), xp)
    with pytest.raises(TypeError):
        K.dia_spmv(a, torch.zeros(a.shape[1]))
    assert K.launches == before


# -- mixed_cg: the cases of tests/test_mixed.py, twinned -------------------------------


@pytest.fixture(scope="module")
def poisson_runs(poisson):
    jcsr, jdia, tcsr, tdia, b = poisson
    return (jsmm.mixed_cg(jdia, jnp.asarray(b), epsilon=1e-5),
            smm.mixed_cg(tdia, torch.from_numpy(b), epsilon=1e-5))


def test_exactly_representable_matches_cg(poisson, poisson_runs):
    """Poisson's values (4, -1) are exact in bf16: the port's mixed_cg
    matches JAX's, and its x is the plain f32 cg's."""
    _, _, _, tdia, b = poisson
    jres, tres = poisson_runs
    _assert_same(tres, jres)
    assert tres.status == SUCCESS and float(tres.residual_norm) <= 1e-5
    ref = smm.cg(tdia, torch.from_numpy(b), epsilon=1e-5)
    np.testing.assert_allclose(tres.x.numpy(), ref.x.numpy(), atol=5e-4, rtol=1e-3)


def test_true_residual_reported(poisson, poisson_runs):
    """residual_norm is the float32-operator residual, recomputed."""
    _, _, tcsr, _, b = poisson
    _, tres = poisson_runs
    r = torch.from_numpy(b) - tcsr @ tres.x
    assert abs(float(torch.linalg.norm(r)) - float(tres.residual_norm)) <= 2e-5
    assert tres.x.shape == (tcsr.shape[0],) and tres.x.dtype == torch.float32


def test_general_values_refine_past_bf16_floor(scaled):
    """Full-mantissa values: one bf16 solve alone stalls near 2^-8; the
    refinement still reaches the f32 tolerance, in both packages."""
    dense, jdia, tdia, b = scaled
    eps = 1e-4 * float(np.linalg.norm(b))
    jres = jsmm.mixed_cg(jdia, jnp.asarray(b), epsilon=eps, max_iterations=5000)
    tres = smm.mixed_cg(tdia, torch.from_numpy(b), epsilon=eps, max_iterations=5000)
    _assert_same(tres, jres)
    assert tres.status == SUCCESS
    r = b - dense @ tres.x.numpy()
    assert np.linalg.norm(r) <= eps * 1.1


def test_budget_exhaustion_reports_maxiter(poisson):
    _, jdia, _, tdia, b = poisson
    jres = jsmm.mixed_cg(jdia, jnp.asarray(b), epsilon=1e-6, max_iterations=3)
    tres = smm.mixed_cg(tdia, torch.from_numpy(b), epsilon=1e-6, max_iterations=3)
    assert tres.status == MAX == int(jres.status)
    assert tres.iterations == int(jres.iterations) == 3


def test_stall_and_divergence_statuses(scaled):
    """A round that does not cut ||r||^2 4-fold ends MAX_ITERATIONS_REACHED
    (inner_rho 0.9 with one round at a time: the stall test), and a
    non-finite b ends DIVERGED, as in the JAX package."""
    _, jdia, tdia, b = scaled
    eps = 1e-6 * float(np.linalg.norm(b))
    jres = jsmm.mixed_cg(jdia, jnp.asarray(b), epsilon=eps, inner_rho=0.9)
    tres = smm.mixed_cg(tdia, torch.from_numpy(b), epsilon=eps, inner_rho=0.9)
    assert tres.status == MAX == int(jres.status)
    assert tres.iterations < tdia.shape[0]
    bad = b.copy()
    bad[3] = np.inf
    jres = jsmm.mixed_cg(jdia, jnp.asarray(bad), epsilon=eps)
    tres = smm.mixed_cg(tdia, torch.from_numpy(bad), epsilon=eps)
    assert int(jres.status) == tres.status


def test_rejects_csr_and_non_f32(poisson):
    _, _, tcsr, tdia, b = poisson
    with pytest.raises(ValueError, match="DIA"):
        smm.mixed_cg(tcsr, torch.ones(tcsr.shape[0]))
    with pytest.raises(TypeError, match="float32"):
        smm.mixed_cg(tdia, torch.from_numpy(b).double())


def test_solve_config_routing(poisson):
    jcsr, jdia, _, tdia, b = poisson
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", smm.PerformanceWarning)
        warnings.simplefilter("ignore", jsmm.PerformanceWarning)
        jres = jsmm.solve(jdia, jnp.asarray(b), method="cg", matrix_dtype="bfloat16",
                          epsilon=1e-5)
        tres = smm.solve(tdia, torch.from_numpy(b), method="cg", matrix_dtype="bfloat16",
                         epsilon=1e-5)
        _assert_same(tres, jres)
        assert tres.status == SUCCESS
        with pytest.raises(ValueError, match="cg"):
            smm.solve(tdia, torch.from_numpy(b), method="bicgstab", matrix_dtype="bfloat16")
        with pytest.raises(ValueError, match="preconditioner"):
            smm.solve(tdia, torch.from_numpy(b), matrix_dtype="bfloat16",
                      preconditioner="jacobi")
        with pytest.raises(ValueError, match="residual traces"):
            smm.solve(tdia, torch.from_numpy(b), matrix_dtype="bfloat16",
                      record_residuals=True)


def test_solve_bf16_warns_on_narrow_stencil(poisson):
    """At most 9 diagonals: the front door warns, and still solves."""
    _, _, _, tdia, b = poisson
    with pytest.warns(smm.PerformanceWarning, match="SLOWER"):
        res = smm.solve(tdia, torch.from_numpy(b), method="cg", epsilon=1e-3,
                        matrix_dtype="bfloat16", auto_escalate=False)
    assert res.status in (SUCCESS, MAX)


@pytest.mark.parametrize("gen,arg,warns", [("poisson_2d", 20, True),
                                           ("poisson_3d_27pt", 8, False)])
def test_auto_format_keeps_dia_for_matrix_dtype(gen, arg, warns):
    """With auto_format a grid stencil is laid out as DIA for the bf16
    stream (mixed_cg refuses anything else): the 27-point system solves
    without a warning, the 5-point one warns; both match JAX's front door."""
    jcsr = getattr(jax_gen, gen)(arg, dtype=np.float32)
    tcsr = _port_csr(jcsr)
    assert isinstance(smm.best_format(tcsr), smm.GridStencilMatrix)
    b = np.array(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], jnp.float32)))
    kw = dict(method="cg", auto_format=True, matrix_dtype="bfloat16", epsilon=1e-4)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        jres = jsmm.solve(jcsr, jnp.asarray(b), **kw)
        tres = smm.solve(tcsr, torch.from_numpy(b), **kw)
    port_warned = any(issubclass(w.category, smm.PerformanceWarning)
                      and "matrix_dtype" in str(w.message) for w in seen)
    assert port_warned == warns
    _assert_same(tres, jres)
    assert tres.status == SUCCESS
