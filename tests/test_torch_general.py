"""The port's general-pattern solve path held against the JAX package on the CPU.

* Generators: ``laplace_3d_jittered``, ``uniform_random_csr`` and
  ``random_spd_csr`` give the JAX package's matrices exactly.
* Reordering: ``rcm_permutation`` (SciPy's and the NumPy BFS), ``permute_csr``
  and ``reorder_to_wsell`` equal JAX's; a ``ReorderedMatrix`` acts as the
  original matrix; the hoisted solve returns x in the original order.
* Routing with ``SMM_FORCE_AUTOROUTE=1``: stencil -> DIA, jittered -> W-SELL,
  shuffled stencil -> RCM + W-SELL, the permuting route refused with a
  preconditioner bound (a warning), the cache, the opt-out.
* Solves: ``cg``/``bicgstab`` on W-SELL, ELL, HYB and reordered operators,
  and PCG with SGS/IC0/ILU0 whose strict products run through W-SELL, against
  the JAX package (Pallas kernels in interpret mode).  In f64 at eps 1e-8 the
  status and iteration count are identical and x agrees to 1e-9; in f32 the
  iteration counts agree within max(2, 2%), because f32 rounding moves the
  step at which the recurrence crosses eps.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats import auto_route_for_solve as jax_auto_route
from sparse_matrix_math_tpu.formats import reorder as jax_reorder
from sparse_matrix_math_tpu.formats.wsell import try_wsell_from_csr as jax_try_wsell
from sparse_matrix_math_tpu.ops.pallas_spmv import ell_spmv as jax_ell_spmv
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats import reorder
from test_torch_wsell import assert_same_planes, port_csr, wsell_fields
from torch_layout_code import same_layout_code  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sparse_matrix_math_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k.startswith('sparse_matrix_math_tpu.') or k == 'sparse_matrix_math_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def assert_same_csr(t, j):
    assert t.shape == j.shape
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


GEN_CASES = [
    ("laplace_3d_jittered", (14,), {}),
    ("laplace_3d_jittered", (16,), dict(symmetric=True, shift=0.25)),
    ("laplace_3d_jittered", (9,), dict(jitter=3, seed=4, symmetric=True)),
    ("uniform_random_csr", (3000,), dict(per_row=4, seed=1)),
    ("random_spd_csr", (300,), dict(density=0.03, seed=2)),
]


@pytest.mark.parametrize("name,args,kw", GEN_CASES, ids=[f"{n}{a}{kw}" for n, a, kw in GEN_CASES])
def test_generators_match_jax(name, args, kw, dtype):
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    tcsr = getattr(smm, name)(*args, dtype=tdtype, **kw, device="cpu")
    assert_same_csr(tcsr, getattr(jax_gen, name)(*args, dtype=dtype, **kw))


def _shuffle_jax(jcsr, seed):
    return jax_reorder.permute_csr(jcsr, np.random.default_rng(seed).permutation(jcsr.shape[0]))


@pytest.mark.parametrize("nx,seed", [(16, 5), (30, 7), (90, 9)])
def test_rcm_and_permute_match_jax(nx, seed):
    jcsr = _shuffle_jax(jax_gen.poisson_2d(nx), seed)
    tcsr = port_csr(jcsr)
    perm = reorder.rcm_permutation(tcsr)
    jperm = jax_reorder.rcm_permutation(jcsr)
    np.testing.assert_array_equal(perm, jperm)
    assert_same_csr(reorder.permute_csr(tcsr, perm), jax_reorder.permute_csr(jcsr, jperm))


def test_numpy_rcm_matches_jax():
    """The BFS used when SciPy does not import, on a graph with two components."""
    d = np.zeros((40, 40))
    for lo, hi in ((0, 25), (25, 40)):
        i = np.arange(lo, hi - 1)
        d[i, i + 1] = d[i + 1, i] = 1.0
    rng = np.random.default_rng(3)
    p = rng.permutation(40)
    d = d[p][:, p]
    indptr = np.concatenate([[0], np.cumsum((d != 0).sum(axis=1))]).astype(np.int64)
    indices = np.nonzero(d)[1].astype(np.int64)
    np.testing.assert_array_equal(reorder._rcm_numpy(indptr, indices, 40),
                                  jax_reorder._rcm_numpy(indptr, indices, 40))


def test_rcm_rejects_rectangular():
    wide = dataclasses.replace(port_csr(jax_gen.poisson_2d(4)), shape=(16, 17))
    with pytest.raises(ValueError, match="square"):
        reorder.rcm_permutation(wide)


def test_reorder_to_wsell_matches_jax_and_acts_as_original():
    jcsr = _shuffle_jax(jax_gen.poisson_2d(16), 5)
    tcsr = port_csr(jcsr)
    ro, jro = reorder.reorder_to_wsell(tcsr), jax_reorder.reorder_to_wsell(jcsr)
    np.testing.assert_array_equal(ro.perm.numpy(), np.asarray(jro.perm))
    np.testing.assert_array_equal(ro.iperm.numpy(), np.asarray(jro.iperm))
    assert_same_planes(ro.inner, jro.inner)
    assert_same_csr(ro.inner_csr, jro.inner_csr)
    x = np.random.default_rng(6).standard_normal((256, 2))
    for xs in (torch.from_numpy(x[:, 0].copy()), torch.from_numpy(x)):
        np.testing.assert_allclose((ro @ xs).numpy(), (tcsr @ xs).numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ro.to_dense().numpy(), tcsr.to_dense().numpy(), rtol=0,
                               atol=1e-15)
    # a zero-locality pattern that RCM cannot pack under a tight cap
    scattered = jax_gen.uniform_random_csr(8000, per_row=4, seed=1)
    assert jax_reorder.reorder_to_wsell(scattered, max_slot_ratio=1.5) is None
    assert reorder.reorder_to_wsell(port_csr(scattered), max_slot_ratio=1.5) is None


def test_hyb_matches_jax():
    jcsr = jax_gen.laplace_3d_jittered(12, symmetric=True, shift=0.25)
    jh = jsmm.hyb_from_csr(jcsr, min_diag_fill=0.3)
    th = smm.hyb_from_csr(port_csr(jcsr), min_diag_fill=0.3)
    assert th.dia.offsets == jh.dia.offsets and th.nnz == jh.nnz
    np.testing.assert_array_equal(th.dia.diags.numpy(), np.asarray(jh.dia.diags))
    assert_same_csr(th.rest, jh.rest)
    assert th.diagonal_fraction == jh.diagonal_fraction
    carried = interop.hyb_from_numpy(
        dict(diags=np.asarray(jh.dia.diags), offsets=jh.dia.offsets, nnz=jh.dia.nnz),
        dict(indptr=np.asarray(jh.rest.indptr), indices=np.asarray(jh.rest.indices),
             data=np.asarray(jh.rest.data)), jh.shape, jh.nnz, "cpu")
    x = np.random.default_rng(0).standard_normal(jcsr.shape[1])
    ref = np.asarray(jsmm.rmult(jh, jnp.asarray(x)))
    for h in (th, carried):
        np.testing.assert_allclose((h @ torch.from_numpy(x)).numpy(), ref, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(th.to_dense().numpy(), np.asarray(jh.to_dense()))


# -- routing ----------------------------------------------------------------------


class TestAutoRoute:
    """The solver front door's routing, forced on for CPU tensors."""

    def test_jittered_routes_to_wsell_and_caches(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        jcsr = jax_gen.laplace_3d_jittered(24, symmetric=True, shift=0.25)
        tcsr = port_csr(jcsr)
        assert tcsr.nnz >= 100_000
        routed, jrouted = smm.auto_route_for_solve(tcsr), jax_auto_route(jcsr)
        assert isinstance(routed, smm.WSellMatrix) and routed.nway == 4
        assert_same_planes(routed, jrouted)
        assert smm.auto_route_for_solve(tcsr) is routed
        # a W-SELL route is also kept with a preconditioner bound
        assert smm.auto_route_for_solve(tcsr, has_preconditioner=True) is routed

    def test_shuffled_stencil_reorders(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        jcsr = _shuffle_jax(jax_gen.poisson_2d(160), 1)
        tcsr = port_csr(jcsr)
        routed, jrouted = smm.auto_route_for_solve(tcsr), jax_auto_route(jcsr)
        assert isinstance(routed, smm.ReorderedMatrix)
        assert isinstance(jrouted, jax_reorder.ReorderedMatrix)
        np.testing.assert_array_equal(routed.perm.numpy(), np.asarray(jrouted.perm))
        assert_same_planes(routed.inner, jrouted.inner)
        assert smm.auto_route_for_solve(tcsr) is routed  # cached
        # a bound preconditioner forbids the permuting route, cached or not
        with pytest.warns(smm.PerformanceWarning, match="preconditioner"):
            assert smm.auto_route_for_solve(tcsr, has_preconditioner=True) is tcsr
        fresh = port_csr(jcsr)
        with pytest.warns(smm.PerformanceWarning, match="preconditioner"):
            assert smm.auto_route_for_solve(fresh, has_preconditioner=True) is fresh
        with pytest.warns(jsmm.PerformanceWarning):
            assert jax_auto_route(jcsr, has_preconditioner=True) is jcsr

    def test_stencil_routes_to_dia_and_opt_out(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        tcsr = smm.poisson_2d(160, device="cpu")
        assert isinstance(smm.auto_route_for_solve(tcsr), smm.DIAMatrix)
        monkeypatch.setenv("SMM_NO_AUTOROUTE", "1")
        other = smm.laplace_3d_jittered(24, symmetric=True, device="cpu")
        assert smm.auto_route_for_solve(other) is other

    def test_unroutable_warning_names_the_layouts(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        tcsr = smm.uniform_random_csr(25_000, per_row=4, seed=1, device="cpu")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert smm.auto_route_for_solve(tcsr) is tcsr
        msgs = [str(x.message) for x in w if issubclass(x.category, smm.PerformanceWarning)]
        assert msgs and all(k in msgs[0] for k in ("DIA", "W-SELL", "RCM + W-SELL"))

    def test_solver_entry_solves_in_the_permuted_domain(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        jcsr = _shuffle_jax(jax_gen.poisson_2d(160), 2)
        tcsr = port_csr(jcsr)
        x_true = np.random.default_rng(0).standard_normal(tcsr.shape[0])
        b = tcsr @ torch.from_numpy(x_true)
        res = smm.cg(tcsr, b, epsilon=1e-8)
        assert isinstance(tcsr._auto_routed[1], smm.ReorderedMatrix)
        assert res.success
        # x comes back in the original order
        r = b - tcsr @ res.x
        assert float(torch.linalg.norm(r)) < 1e-8


# -- solves -----------------------------------------------------------------------


def _jittered(dtype, symmetric=True):
    return jax_gen.laplace_3d_jittered(16, dtype=dtype, symmetric=symmetric,
                                       shift=0.25 if symmetric else 0.0)


def _operators(kind, jcsr):
    """The JAX operator of ``kind`` and its port twin carried over by interop."""
    tcsr = port_csr(jcsr)
    if kind == "wsell":
        j = jax_try_wsell(jcsr)
        return j, interop.wsell_from_numpy(wsell_fields(j), "cpu")
    if kind == "ell":
        # JAX's rmult on an ELLMatrix sums in XLA's order; its Pallas kernel
        # in interpret mode sums in K6's, which the port follows
        j = jsmm.ell_from_csr(jcsr)
        return (lambda x: jax_ell_spmv(j, x, interpret=True)), interop.ell_from_numpy(np.asarray(j.vals), np.asarray(j.cols), j.shape,
                                         j.nnz, "cpu")
    if kind == "hyb":
        return jsmm.hyb_from_csr(jcsr, min_diag_fill=0.3), smm.hyb_from_csr(
            tcsr, min_diag_fill=0.3)
    j = jax_reorder.reorder_to_wsell(jcsr, max_slot_ratio=64)
    inner = interop.wsell_from_numpy(wsell_fields(j.inner), "cpu")
    return j, interop.reordered_from_numpy(inner, port_csr(j.inner_csr), np.asarray(j.perm),
                                           np.asarray(j.iperm), j.shape, j.nnz)


def _check_same(tres, jres, dtype):
    assert tres.status == int(jres.status)
    if dtype == np.float64:
        assert tres.iterations == int(jres.iterations)
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=0, atol=1e-9)
    else:
        assert abs(tres.iterations - int(jres.iterations)) <= max(2, 0.02 * int(jres.iterations))


SOLVE_CASES = [
    ("cg", "wsell", lambda d: _jittered(d)),
    ("bicgstab", "wsell", lambda d: _jittered(d, symmetric=False)),
    ("cg", "ell", lambda d: _jittered(d)),
    ("bicgstab", "ell", lambda d: jax_gen.poisson_2d(32, dtype=d)),
    ("cg", "hyb", lambda d: _jittered(d)),
    ("cg", "reorder", lambda d: _shuffle_jax(jax_gen.poisson_2d(32, dtype=d), 7)),
    ("bicgstab", "reorder", lambda d: _shuffle_jax(jax_gen.poisson_2d(32, dtype=d), 8)),
]


@pytest.mark.parametrize("solver,kind,make", SOLVE_CASES,
                         ids=[f"{s}-{k}-{i}" for i, (s, k, _) in enumerate(SOLVE_CASES)])
def test_solves_match_jax(solver, kind, make, dtype):
    jcsr = make(dtype)
    jop, top = _operators(kind, jcsr)
    b = np.array(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], dtype)))
    eps = 1e-8 if dtype == np.float64 else 1e-4
    jres = getattr(jsmm, solver)(jop, jnp.asarray(b), epsilon=eps, max_iterations=2000)
    tres = getattr(smm, solver)(top, torch.from_numpy(b), epsilon=eps, max_iterations=2000)
    _check_same(tres, jres, dtype)
    if kind == "reorder":  # x in the original order: the true residual passes
        r = b.astype(np.float64) - np.asarray(jcsr.to_dense(), np.float64) @ tres.x.numpy()
        assert np.linalg.norm(r) < (1e-8 if dtype == np.float64 else 1e-3)


PRECOND_CASES = [("ic0", "cg", _jittered), ("sgs", "cg", _jittered),
                 ("ilu0", "bicgstab", lambda d: _jittered(d, symmetric=False)),
                 ("ic0", "cg", lambda d: jax_gen.poisson_2d(32, dtype=d)),
                 ("sgs", "bicgstab", lambda d: jax_gen.poisson_2d(32, dtype=d))]


def _factors(pre):
    return (pre.fwd, pre.bwd) if hasattr(pre, "fwd") else (pre.lower, pre.upper)


@pytest.mark.parametrize("kind,solver,make", PRECOND_CASES,
                         ids=[f"{k}-{s}-{i}" for i, (k, s, _) in enumerate(PRECOND_CASES)])
def test_wsell_strict_products_match_jax(kind, solver, make, dtype):
    """PCG/BiCGStab on a W-SELL operator with a preconditioner whose strict
    factor products run through W-SELL (K7), built by both packages."""
    jcsr = make(dtype)
    jop, top = _operators("wsell", jcsr)
    kw = dict(method="jacobi", sweeps=4, strict_layout="wsell")
    jpre = jsmm.get_preconditioner(jcsr, kind, **kw)
    tpre = smm.get_preconditioner(port_csr(jcsr), kind, **kw)
    for jt, tt in zip(_factors(jpre), _factors(tpre)):
        assert tt.wsell is not None
        assert_same_planes(tt.wsell, jt.wsell)
    b = np.array(jsmm.rmult(jcsr, jnp.ones(jcsr.shape[0], dtype)))
    eps = 1e-8 if dtype == np.float64 else 1e-4
    jres = getattr(jsmm, solver)(jop, jnp.asarray(b), epsilon=eps, preconditioner=jpre)
    tres = getattr(smm, solver)(top, torch.from_numpy(b), epsilon=eps, preconditioner=tpre)
    _check_same(tres, jres, dtype)
    # an (n, m) panel runs the strict products through K8's plain version
    panel = torch.from_numpy(np.stack([b, -2.0 * b], axis=1))
    z = tpre.apply(panel)
    for j in range(2):
        np.testing.assert_allclose(z[:, j].numpy(), tpre.apply(panel[:, j].contiguous()).numpy(),
                                   rtol=0, atol=0)


def test_strict_layout_auto_is_csr_on_the_cpu():
    csr = smm.laplace_3d_jittered(10, symmetric=True, shift=0.25, device="cpu")
    pre = smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=2)
    assert pre.lower.wsell is None and pre.upper.wsell is None
    forced = smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=2,
                                               strict_layout="wsell")
    assert forced.lower.wsell.window_f == 1 and forced.lower.wsell.nway == 1
    # a dense solve has no strict products: no layout
    dense = smm.IC0Preconditioner.from_matrix(csr, method="dense", strict_layout="wsell")
    assert dense.lower.wsell is None
