"""The port's SGS, IC(0) and ILU(0) preconditioners and their solve path
held against the JAX package on the CPU.

* Factorizations: IC(0) and ILU(0) values, port against JAX, to 1e-14 in
  f64; the port's native C++ path against its Python loops.
* Applies: TriangularMatrix solves and the preconditioners' generic applies
  to 1e-12 in f64 and 2e-5 in f32, the JAX tests' own tolerances.
* Solves: the padded solve path with SGS(4), IC0(4) and ILU0(4) against the
  JAX package's ``padded_solve`` (Pallas kernels in interpret mode).  In f64
  at eps 1e-8 the status and iteration count are identical and x agrees to
  1e-10; in f32 at eps 1e-5 the iteration counts agree within max(2, 2%),
  because f32 rounding moves the step at which the recurrence crosses eps.

The preconditioners in the solve tests cross from the JAX objects through
interop, so a solve is held against JAX independently of the factorization.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.precond import FactorizationError as JaxFactorizationError
from sparse_matrix_math_tpu.precond import _factorize as jax_factorize
from sparse_matrix_math_tpu.precond.trisolve import (
    triangular_from_csr_arrays as jax_triangular_from_csr_arrays,
)
from sparse_matrix_math_tpu.solvers._padded import padded_solve as jax_padded_solve
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import formats as tformats
from sparse_matrix_math_tpu_torch import interop, native
from sparse_matrix_math_tpu_torch.precond import _factorize as factorize
from sparse_matrix_math_tpu_torch.precond import PaddedSGS, triangular_from_csr_arrays
from sparse_matrix_math_tpu_torch.solvers import _padded
from test_torch_trisweep import TOL, tri_fields


def _systems(name, n, dtype, rhs="ones"):
    """JAX CSR and DIA matrices, the port's twins, and b (A @ ones, or a
    seeded standard normal)."""
    jcsr = getattr(jax_gen, name)(n, dtype=dtype)
    jdia = jax_dia_from_csr(jcsr)
    if rhs == "ones":
        b = np.array(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], dtype)))
    else:
        b = np.random.default_rng(0).standard_normal(jcsr.shape[0]).astype(dtype)
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    return jcsr, jdia, tcsr, tdia, b


def _csr_arrays(jcsr):
    return (np.asarray(jcsr.data, np.float64), np.asarray(jcsr.indices, np.int64),
            np.asarray(jcsr.indptr, np.int64))


def _port_twin(kind, jpre):
    """The port's preconditioner with the JAX one's factor values."""
    lo, up = ("fwd", "bwd") if kind == "sgs" else ("lower", "upper")
    lo, up = tri_fields(getattr(jpre, lo)), tri_fields(getattr(jpre, up))
    if kind == "sgs":
        return interop.sgs_from_numpy(lo, up, np.asarray(jpre.diag), "cpu")
    if kind == "ic0":
        return interop.ic0_from_numpy(lo, up, "cpu")
    return interop.ilu0_from_numpy(lo, up, jpre.shift, "cpu")


def _csr_from_dense(dense):
    jcsr = jsmm.csr_from_dense(np.asarray(dense, dtype=np.float64))
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    return jcsr, tcsr


# -- factorizations --------------------------------------------------------


def test_ic0_factor_matches_jax():
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    want = jax_factorize.ic0_factorize_host(*_csr_arrays(jcsr))
    got = factorize.ic0_factorize_host(*_csr_arrays(jcsr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-14)


@pytest.mark.parametrize("name", ["poisson_2d", "convection_diffusion_2d"])
def test_ilu0_factor_matches_jax(name):
    jcsr = getattr(jax_gen, name)(12, dtype=np.float64)
    want = jax_factorize.ilu0_factorize_host(*_csr_arrays(jcsr))
    got = factorize.ilu0_factorize_host(*_csr_arrays(jcsr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-14)


@pytest.mark.parametrize("name", ["poisson_2d", "convection_diffusion_2d"])
def test_native_matches_python(name):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native factorization library")
    assert native.available()
    data, indices, indptr = _csr_arrays(getattr(jax_gen, name)(12, dtype=np.float64))
    n = indptr.shape[0] - 1
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    diag_pos = np.nonzero(indices == row_ids)[0]
    fast = factorize.ilu0_factorize_host(data, indices, indptr)[0]
    slow = factorize._ilu0_python(data, indices, indptr, diag_pos, 0.0)
    np.testing.assert_allclose(fast, slow, rtol=0, atol=1e-14)
    if name == "poisson_2d":
        fast = factorize.ic0_factorize_host(data, indices, indptr)
        slow = factorize._ic0_python(data, indices, indptr)
        for f, s in zip(fast, slow):
            np.testing.assert_allclose(f, s, rtol=0, atol=1e-14)


def _indefinite_tridiagonal(n=10):
    return np.diag(np.ones(n)) + 2.0 * (np.eye(n, k=1) + np.eye(n, k=-1))


def test_ic0_non_spd_raises():
    jcsr, tcsr = _csr_from_dense(_indefinite_tridiagonal())
    with pytest.raises(JaxFactorizationError):
        jsmm.get_preconditioner(jcsr, "ic0")
    with pytest.raises(smm.FactorizationError):
        smm.get_preconditioner(tcsr, "ic0")
    with pytest.raises(smm.FactorizationError):  # the Python loops raise too
        factorize._ic0_python(*_csr_arrays(jcsr))


def test_missing_diagonal_raises():
    dense = np.diag(np.full(6, 4.0)) - np.eye(6, k=1) - np.eye(6, k=-1)
    dense[3, 3] = 0.0
    _, tcsr = _csr_from_dense(dense)
    for kind in ("ic0", "ilu0", "sgs", "jacobi"):
        with pytest.raises(smm.FactorizationError):
            smm.get_preconditioner(tcsr, kind)


def test_ilu0_zero_pivot_shift_matches_jax():
    """Row 1's pivot is 1 - 1 * 1 = 0: the factorization retries on
    A + alpha I with the same alpha in both packages."""
    n = 8
    dense = np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    jcsr, tcsr = _csr_from_dense(dense)
    jpre = jsmm.get_preconditioner(jcsr, "ilu0", method="jacobi", sweeps=4)
    tpre = smm.get_preconditioner(tcsr, "ilu0", method="jacobi", sweeps=4)
    assert jpre.shift > 0 and tpre.shift == jpre.shift
    np.testing.assert_allclose(tpre.upper.diag.numpy(), np.asarray(jpre.upper.diag),
                               rtol=0, atol=1e-14)
    with pytest.raises(JaxFactorizationError):
        jsmm.get_preconditioner(jcsr, "ilu0", pivot_shift="never")
    with pytest.raises(smm.FactorizationError):
        smm.get_preconditioner(tcsr, "ilu0", pivot_shift="never")


def test_sgs_small_diagonal_raises():
    dense = np.diag(np.full(5, 1e-6)) + 0.1 * (np.eye(5, k=1) + np.eye(5, k=-1))
    jcsr, tcsr = _csr_from_dense(dense)
    with pytest.raises(JaxFactorizationError):
        jsmm.get_preconditioner(jcsr, "sgs")
    with pytest.raises(smm.FactorizationError):
        smm.get_preconditioner(tcsr, "sgs")


# -- triangular solves and generic applies ---------------------------------


@pytest.mark.parametrize("method,sweeps", [("dense", "exact"), ("jacobi", 1), ("jacobi", 2),
                                           ("jacobi", 4), ("jacobi", "exact")])
@pytest.mark.parametrize("lower", [True, False], ids=["lower", "upper"])
def test_triangular_solve_matches_jax(method, sweeps, lower):
    """L of IC(0) on poisson_2d(12), and its transpose, solved for a vector
    and a 3-column panel."""
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    lv, li, lp = jax_factorize.ic0_factorize_host(*_csr_arrays(jcsr))
    if not lower:  # the transpose: CSR of L^T is CSC of L
        import scipy.sparse as sp

        t = sp.csr_matrix((lv, li, lp)).T.tocsr()
        t.sort_indices()
        lv, li, lp = t.data, t.indices.astype(np.int64), t.indptr.astype(np.int64)
    kw = dict(lower=lower, method=method, sweeps=sweeps)
    jt = jax_triangular_from_csr_arrays(lv, li, lp, strict_layout="csr", **kw)
    tt = triangular_from_csr_arrays(lv, li, lp, **kw)
    assert (tt.method, tt.sweeps, tt.depth) == (jt.method, jt.sweeps, jt.depth)
    rhs = np.random.default_rng(0).standard_normal((lp.shape[0] - 1, 3))
    for b in (rhs[:, 0], rhs):
        want = np.asarray(jt.solve(jnp.asarray(b)))
        got = tt.solve(torch.from_numpy(b)).numpy()
        assert got.shape == b.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL[np.float64])


def test_exact_sweeps_warn_past_depth_64():
    n = 100
    dense = np.eye(n) * 2.0 - np.eye(n, k=-1)  # lower bidiagonal: depth n
    _, tcsr = _csr_from_dense(dense)
    with pytest.warns(RuntimeWarning, match="100 Jacobi sweeps"):
        tt = triangular_from_csr_arrays(tcsr.data.numpy(), tcsr.indices.numpy(),
                                        tcsr.indptr.numpy(), lower=True, method="jacobi")
    assert tt.sweeps == tt.depth == n
    b = torch.ones(n, dtype=torch.float64)
    np.testing.assert_allclose((tcsr.to_dense() @ tt.solve(b)).numpy(), 1.0, rtol=0, atol=1e-12)
    auto = triangular_from_csr_arrays(tcsr.data.numpy(), tcsr.indices.numpy(),
                                      tcsr.indptr.numpy(), lower=True)
    assert auto.method == "dense"  # n <= 4096


APPLY_CASES = [("sgs", "poisson_2d"), ("sgs", "convection_diffusion_2d"),
               ("ic0", "poisson_2d"), ("ilu0", "poisson_2d"),
               ("ilu0", "convection_diffusion_2d")]


@pytest.mark.parametrize("method", ["dense", "jacobi"])
@pytest.mark.parametrize("kind,name", APPLY_CASES, ids=[f"{k}-{n}" for k, n in APPLY_CASES])
def test_generic_apply_matches_jax(kind, name, method, dtype):
    """Each package builds the preconditioner from the same CSR matrix; the
    applies of a vector and of a 2-column panel agree."""
    jcsr = getattr(jax_gen, name)(12, dtype=dtype)
    tcsr = interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")
    kw = dict(method=method, sweeps=4) if method == "jacobi" else dict(method="dense")
    jpre = jsmm.get_preconditioner(jcsr, kind, **kw)
    tpre = smm.get_preconditioner(tcsr, kind, **kw)
    rhs = np.random.default_rng(1).standard_normal((jcsr.shape[0], 2)).astype(dtype)
    for r in (rhs[:, 0], rhs):
        want = np.asarray(jpre.apply(jnp.asarray(r)))
        got = tpre.apply(torch.from_numpy(r)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


# -- solves through the padded path ----------------------------------------


SOLVES = [("cg", "sgs"), ("bicgstab", "sgs"), ("cg", "ic0"), ("bicgstab", "ic0"),
          ("bicgstab", "ilu0")]
SIZES = [(16, np.float64), (40, np.float64), (40, np.float32)]


def _solve_both(core, kind, nx, dtype):
    eps = 1e-8 if dtype == np.float64 else 1e-5
    jcsr, jdia, _, tdia, b = _systems("poisson_2d", nx, dtype)
    jpre = jsmm.get_preconditioner(jcsr, kind, method="jacobi", sweeps=4)
    jb = jnp.asarray(b)
    jres = jax_padded_solve(core, jdia, jb, jnp.zeros_like(jb), eps, b.shape[0], False,
                            preconditioner=jpre, interpret=True)
    tpre = _port_twin(kind, jpre)
    assert _padded.eligible(tdia, tpre)
    solver = smm.cg if core == "cg" else smm.bicgstab
    tres = solver(tdia, torch.from_numpy(b), epsilon=eps, preconditioner=tpre)
    return jres, tres


@pytest.mark.parametrize("nx,dtype", SIZES, ids=["p16-f64", "p40-f64", "p40-f32"])
@pytest.mark.parametrize("core,kind", SOLVES, ids=[f"{c}-{k}" for c, k in SOLVES])
def test_padded_solve_matches_jax(core, kind, nx, dtype):
    jres, tres = _solve_both(core, kind, nx, dtype)
    assert tres.status == int(jres.status) == smm.SolverStatus.SUCCESS
    j_its = int(jres.iterations)
    if dtype == np.float64:
        assert tres.iterations == j_its
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)
    else:
        assert abs(tres.iterations - j_its) <= max(2, 0.02 * j_its)
        assert tres.x.dtype == torch.float32


@pytest.mark.parametrize("kind", ["sgs", "ic0", "ilu0"])
def test_public_entry_routes_csr_to_the_padded_path(kind, monkeypatch):
    """cg/bicgstab on a CSR matrix with a preconditioner built by
    from_matrix: auto-route to DIA (forced here for CPU tensors at a small
    size), padded solve, the same iterations as JAX's padded solve."""
    monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
    monkeypatch.setattr(tformats, "_AUTOROUTE_MIN_ROWS", 1)
    monkeypatch.setattr(tformats, "_AUTOROUTE_MIN_NNZ", 1)
    jcsr, jdia, tcsr, _, b = _systems("poisson_2d", 16, np.float64)
    assert isinstance(smm.auto_route_for_solve(tcsr), smm.DIAMatrix)
    cls = {"sgs": smm.SGSPreconditioner, "ic0": smm.IC0Preconditioner,
           "ilu0": smm.ILU0Preconditioner}[kind]
    tpre = cls.from_matrix(tcsr, method="jacobi", sweeps=4)
    jpre = jsmm.get_preconditioner(jcsr, kind, method="jacobi", sweeps=4)
    for core, solver in (("cg", smm.cg), ("bicgstab", smm.bicgstab)):
        if kind == "ilu0" and core == "cg":
            continue
        jb = jnp.asarray(b)
        jres = jax_padded_solve(core, jdia, jb, jnp.zeros_like(jb), 1e-8, b.shape[0], False,
                                preconditioner=jpre, interpret=True)
        tres = solver(tcsr, torch.from_numpy(b), epsilon=1e-8, preconditioner=tpre)
        assert tres.success and tres.iterations == int(jres.iterations)
        np.testing.assert_allclose(tres.x.numpy(), 1.0, rtol=0, atol=1e-7)


def test_padded_sgs_object_solves_like_sgs():
    """A PaddedSGS passed in directly (as the JAX bench does) solves as the
    SGSPreconditioner it re-lays."""
    _, _, tcsr, tdia, b = _systems("poisson_2d", 16, np.float64)
    bt = torch.from_numpy(b)
    via_sgs = smm.bicgstab(tdia, bt, epsilon=1e-8, preconditioner=smm.SGSPreconditioner
                           .from_matrix(tcsr, method="jacobi", sweeps=4))
    direct = smm.bicgstab(tdia, bt, epsilon=1e-8,
                          preconditioner=PaddedSGS.from_dia(tdia, sweeps=4))
    assert direct.iterations == via_sgs.iterations
    assert torch.equal(direct.x, via_sgs.x)


# -- routing probes ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["sgs", "ic0", "ilu0"])
def test_dense_method_takes_the_generic_path(kind):
    jcsr, jdia, tcsr, tdia, b = _systems("poisson_2d", 12, np.float64, rhs="rand")
    tpre = smm.get_preconditioner(tcsr, kind, method="dense")
    assert not _padded.eligible(tdia, tpre)
    jpre = jsmm.get_preconditioner(jcsr, kind, method="dense")
    core = "cg" if kind != "ilu0" else "bicgstab"
    jsolver, tsolver = (jsmm.cg, smm.cg) if core == "cg" else (jsmm.bicgstab, smm.bicgstab)
    jres = jsolver(jdia, jnp.asarray(b), epsilon=1e-10, preconditioner=jpre)
    tres = tsolver(tdia, torch.from_numpy(b), epsilon=1e-10, preconditioner=tpre)
    assert tres.status == int(jres.status) and tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-10)


def test_wsell_strict_layout_raises():
    """``strict_layout="wsell"`` lays every Jacobi factor's strict part out
    as W-SELL (it raised before the W-SELL kernel was ported); an unknown
    layout raises.  At n=64 the strict parts pad past the slot-ratio cap at
    both window widths and keep the gather path, as in the JAX package."""
    _, _, tiny, _, _ = _systems("poisson_2d", 8, np.float64)
    _, _, tcsr, _, _ = _systems("poisson_2d", 40, np.float64)
    for kind in ("sgs", "ic0", "ilu0"):
        for csr, packs in ((tiny, False), (tcsr, True)):
            pre = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=2,
                                         strict_layout="wsell")
            factors = (pre.fwd, pre.bwd) if kind == "sgs" else (pre.lower, pre.upper)
            assert all(isinstance(t.wsell, smm.WSellMatrix) == packs for t in factors)
        with pytest.raises(ValueError, match="strict_layout"):
            smm.get_preconditioner(tcsr, kind, method="jacobi", sweeps=2,
                                   strict_layout="ell")


@pytest.mark.parametrize("kind", ["sgs", "ic0", "ilu0"])
def test_zero_sweeps_raises(kind):
    _, _, tcsr, tdia, b = _systems("poisson_2d", 8, np.float64)
    pre = smm.get_preconditioner(tcsr, kind, method="jacobi", sweeps=0)
    with pytest.raises(ValueError, match="sweeps"):
        smm.bicgstab(tdia, torch.from_numpy(b), preconditioner=pre)


def test_factory_kinds_and_aliases():
    jcsr, _, tcsr, _, _ = _systems("poisson_2d", 8, np.float64)
    expect = {
        "none": smm.IdentityPreconditioner, "jacobi": smm.JacobiPreconditioner,
        "diagonal": smm.JacobiPreconditioner, "sgs": smm.SGSPreconditioner,
        "symmetric_gauss_seidel": smm.SGSPreconditioner,
        "SYMMETRIC_GAUS_SEIDEL": smm.SGSPreconditioner, "ilu0": smm.ILU0Preconditioner,
        "ic0": smm.IC0Preconditioner,
        smm.SolverPreconditioner.IC0: smm.IC0Preconditioner,
    }
    for kind, cls in expect.items():
        pre = smm.get_preconditioner(tcsr, kind)
        assert isinstance(pre, cls)
        jkind = kind.value if isinstance(kind, smm.SolverPreconditioner) else kind
        assert type(jsmm.get_preconditioner(jcsr, jkind)).__name__ == cls.__name__
    for kind in ("cheby", "chebyshev", "poly", "polynomial"):
        pre = smm.get_preconditioner(tcsr, kind, eig_bounds=(0.1, 8.0))
        assert isinstance(pre, smm.ChebyshevPreconditioner) and pre.a is tcsr
        jpre = jsmm.get_preconditioner(jcsr, kind, eig_bounds=(0.1, 8.0))
        assert (pre.lmin, pre.lmax, pre.degree) == (jpre.lmin, jpre.lmax, jpre.degree)
    with pytest.raises(KeyError):
        smm.get_preconditioner(tcsr, "ssor")
