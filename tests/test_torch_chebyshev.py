"""The port's Chebyshev semi-iteration (solvers/chebyshev.py) and pipelined CG
(solvers/pipelined.py) held against the JAX package's.

Same systems (generated, including an anisotropic grid with odd sides) and
right-hand sides made from a seed with NumPy.  Chebyshev runs with given
spectrum bounds: the port's Lanczos estimate starts from NumPy's
``default_rng(seed)`` vector, not JAX's, so auto-bounded runs are held to the
spectrum instead.  Tolerances: f64 status and iterations equal, x within
1e-8 of ||x||; f32 iterations within max(3, 10%), x within 1e-3 of ||x||.  A
frozen chunk keeps the state bit for bit (``_loop.CHUNK`` 1 against 32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch.solvers import _loop
from test_torch_wsell import port_csr

S = smm.SolverStatus

SYSTEMS = {
    "poisson_2d(16)": lambda dt: jax_gen.poisson_2d(16, dtype=dt),
    "poisson_2d(15, 9)": lambda dt: jax_gen.poisson_2d(15, 9, dtype=dt),
    "random_spd(120)": lambda dt: jax_gen.random_spd_csr(120, 0.08, seed=4, dtype=dt),
}


def system(name, dtype=np.float64, seed=0):
    jcsr = SYSTEMS[name](dtype)
    b = np.random.default_rng(seed).standard_normal(jcsr.shape[0]).astype(dtype)
    return jcsr, port_csr(jcsr), b


def spectrum(jcsr):
    w = np.linalg.eigvalsh(np.asarray(jcsr.to_dense(), np.float64))
    return float(w[0]), float(w[-1])


def assert_parity(tres, jres, dtype, band=None):
    assert tres.status == int(jres.status), (tres, jres)
    its = int(jres.iterations)
    if band is None:
        band = max(3, int(0.1 * its)) if dtype == np.float32 else 0
    assert abs(tres.iterations - its) <= band, (tres, jres)
    jx, tx = np.asarray(jres.x, np.float64), tres.x.double().numpy()
    xtol = 1e-3 if dtype == np.float32 else 1e-8
    assert np.linalg.norm(tx - jx) <= xtol * np.linalg.norm(jx)


def bits(t):
    return t.numpy().view(np.int64 if t.dtype == torch.float64 else np.int32)


# -- Chebyshev --------------------------------------------------------------


@pytest.mark.parametrize("check_every,cap", [(10, 3000), (1, 3000), (7, 3000), (10, 23)])
@pytest.mark.parametrize("name", ["poisson_2d(16)", "poisson_2d(15, 9)"])
def test_chebyshev_f64_matches_jax(name, check_every, cap):
    jcsr, tcsr, b = system(name)
    kw = dict(epsilon=1e-9, eig_bounds=spectrum(jcsr), check_every=check_every,
              max_iterations=cap, record_residuals=True)
    jres = jsmm.chebyshev(jcsr, jnp.asarray(b), **kw)
    tres = smm.chebyshev(tcsr, torch.from_numpy(b), **kw)
    assert_parity(tres, jres, np.float64)
    assert tres.status == int(S.SUCCESS if cap == 3000 else S.MAX_ITERATIONS_REACHED)
    jt, tt = np.asarray(jres.residual_trace), tres.residual_trace.numpy()
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))
    # each entry is ||b - A x||: its rounding is relative to ||b||
    np.testing.assert_allclose(tt[~np.isnan(jt)], jt[~np.isnan(jt)], rtol=1e-6,
                               atol=1e-12 * jt[0])


def test_chebyshev_f32_matches_jax():
    jcsr, tcsr, b = system("random_spd(120)", np.float32, seed=1)
    kw = dict(epsilon=1e-4, eig_bounds=spectrum(jcsr), max_iterations=2000)
    jres = jsmm.chebyshev(jcsr, jnp.asarray(b), **kw)
    tres = smm.chebyshev(tcsr, torch.from_numpy(b), **kw)
    assert_parity(tres, jres, np.float32)


def test_chebyshev_auto_bounds_and_lanczos():
    """The auto-bounded solve converges like JAX's; the port's Lanczos
    estimates are interior to the spectrum and within 1% of its ends, as
    tests/test_chebyshev.py holds JAX's."""
    jcsr, tcsr, b = system("poisson_2d(16)")
    lo, hi = smm.lanczos_extremal(tcsr)
    w0, w1 = spectrum(jcsr)
    assert lo == pytest.approx(w0, rel=1e-2) and hi == pytest.approx(w1, rel=1e-2)
    assert lo >= w0 - 1e-8 and hi <= w1 + 1e-8
    kw = dict(epsilon=1e-9, max_iterations=3000)
    jres = jsmm.chebyshev(jcsr, jnp.asarray(b), **kw)
    tres = smm.chebyshev(tcsr, torch.from_numpy(b), **kw)
    assert tres.status == int(jres.status) == int(S.SUCCESS)
    assert abs(tres.iterations - int(jres.iterations)) <= max(10, int(0.05 * jres.iterations))


def test_chebyshev_frozen_chunk_bitwise(monkeypatch):
    _, tcsr, b = system("poisson_2d(15, 9)", seed=2)
    kw = dict(epsilon=1e-9, eig_bounds=spectrum(SYSTEMS["poisson_2d(15, 9)"](np.float64)),
              check_every=3, max_iterations=500, record_residuals=True)
    runs = []
    for chunk in (1, 32):
        monkeypatch.setattr(_loop, "CHUNK", chunk)
        runs.append(smm.chebyshev(tcsr, torch.from_numpy(b), **kw))
    one, many = runs
    assert (one.status, one.iterations) == (many.status, many.iterations)
    assert np.array_equal(bits(one.x), bits(many.x))
    assert np.array_equal(bits(one.residual_trace), bits(many.residual_trace))


# -- pipelined CG -----------------------------------------------------------


@pytest.mark.parametrize("replace_every", [50, 7, 0])
@pytest.mark.parametrize("name", ["poisson_2d(16)", "poisson_2d(15, 9)", "random_spd(120)"])
def test_pipelined_f64_matches_jax(name, replace_every):
    jcsr, tcsr, b = system(name, seed=3)
    kw = dict(epsilon=1e-10, replace_every=replace_every, record_residuals=True)
    jres = jsmm.cg_pipelined(jcsr, jnp.asarray(b), **kw)
    tres = smm.cg_pipelined(tcsr, torch.from_numpy(b), **kw)
    assert tres.status == int(S.SUCCESS)
    assert_parity(tres, jres, np.float64)
    assert float(tres.residual_norm) == pytest.approx(float(jres.residual_norm), rel=1e-4)
    jt, tt = np.asarray(jres.residual_trace), tres.residual_trace.numpy()
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(jt))


def test_pipelined_replacement_bounds_drift_f32():
    """tests/test_pipelined.py's drift case in both packages: without
    replacement the f32 recurrence under-reports the true residual more than
    10-fold, with it the two agree to 2x; both packages run to the cap.

    How far the recurrence drifts in 3000 f32 steps is set by rounding alone.
    On poisson_2d(64) and (48), b = A @ ones, the true residual over the
    recurrence's was 588 and 3780 in the JAX package and 68 and 460 in the
    port (torch.dot); summing the port's dots pairwise or with torch.sum gave
    110-899; on poisson_2d(56) the JAX package's fell to 37, and on
    poisson_2d(64) with a standard-normal b the port's to 15, all on one
    CPU.  With replacement every 25 steps the ratio was 1.00 in all of them.
    So the bound that tells the two regimes apart on any rounding path is
    10x, held in both packages."""
    for nx, every in ((64, 0), (64, 25), (48, 0), (48, 25)):
        jcsr = jax_gen.poisson_2d(nx, dtype=np.float32)
        tcsr = port_csr(jcsr)
        b = np.array(jcsr @ jnp.ones(jcsr.shape[0], jnp.float32))
        dense = tcsr.to_dense().double().numpy()
        kw = dict(max_iterations=3000, epsilon=1e-12, replace_every=every)
        jres = jsmm.cg_pipelined(jcsr, jnp.asarray(b), **kw)
        tres = smm.cg_pipelined(tcsr, torch.from_numpy(b), **kw)
        assert tres.status == int(jres.status) == int(S.MAX_ITERATIONS_REACHED)
        assert tres.iterations == int(jres.iterations) == 3000
        for x, claimed in ((tres.x.double().numpy(), float(tres.residual_norm)),
                           (np.asarray(jres.x, np.float64), float(jres.residual_norm))):
            true = np.linalg.norm(b - dense @ x)
            if every == 0:
                assert true > 10 * claimed
            else:
                assert true <= 2 * claimed and true < 1e-2


def test_pipelined_cap_and_solve_front_door():
    jcsr, tcsr, b = system("poisson_2d(16)", seed=4)
    capped = smm.cg_pipelined(tcsr, torch.from_numpy(b), max_iterations=3, epsilon=1e-14)
    assert capped.status == int(S.MAX_ITERATIONS_REACHED) and capped.iterations == 3
    for method in ("cg_pipelined", "chebyshev"):
        jres = jsmm.solve(jcsr, jnp.asarray(b), method=method, epsilon=1e-8,
                          max_iterations=2000)
        tres = smm.solve(tcsr, torch.from_numpy(b), method=method, epsilon=1e-8,
                         max_iterations=2000)
        assert tres.status == int(jres.status) == int(S.SUCCESS)
        band = 0 if method == "cg_pipelined" else max(10, int(0.05 * jres.iterations))
        assert abs(tres.iterations - int(jres.iterations)) <= band


def test_pipelined_frozen_chunk_bitwise(monkeypatch):
    _, tcsr, b = system("random_spd(120)", seed=5)
    runs = []
    for chunk in (1, 32):
        monkeypatch.setattr(_loop, "CHUNK", chunk)
        runs.append(smm.cg_pipelined(tcsr, torch.from_numpy(b), epsilon=1e-10,
                                     replace_every=9, record_residuals=True))
    one, many = runs
    assert (one.status, one.iterations) == (many.status, many.iterations)
    assert np.array_equal(bits(one.x), bits(many.x))
    assert np.array_equal(bits(one.residual_trace), bits(many.residual_trace))
