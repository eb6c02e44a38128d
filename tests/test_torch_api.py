"""The port's front door, ``solve()`` and ``best_format``, held against the JAX
package's.

* ``best_format`` picks the JAX package's layout on one matrix per branch
  (grid stencil, DIA, W-SELL, RCM + W-SELL, R-SELL, CSR), with equal
  ``slot_ratio`` where the layout has one.
* ``solve()``: configuration and overrides, the preconditioner strings and
  objects, the df64 methods, ``auto_format`` and its DIA exception, the
  pre-route and the floor escalation (tests/test_floor_escalation.py's cases),
  a 2-D ``b`` through ``cg_multi``, the solver tail (GMRES, Chebyshev,
  pipelined CG, ``preconditioner="multigrid"``) and a wrong-length ``b``.  A
  solve
  is compared with the JAX package's by status, iterations (within 1 in f64
  for CG, the dots sum in another order; within max(3, 5%) for BiCGStab,
  whose counts wander with rounding) and x (1e-8 of max|x| in f64).  A
  double-word solve's count agrees within max(3, 5%), a refinement's f32
  inner count within max(3, 10%); an escalated solve is held to the float64
  residual on the host.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from conftest import SHERMAN1, asset_path
from sparse_matrix_math_tpu.formats.reorder import permute_csr as jax_permute_csr
from sparse_matrix_math_tpu.solvers.api import SOLVERS as JAX_SOLVERS
from sparse_matrix_math_tpu.solvers.api import SolverConfig as JaxSolverConfig
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch.formats.stencil import try_grid_stencil_from_csr
from sparse_matrix_math_tpu_torch.precond import PaddedSGS
from sparse_matrix_math_tpu_torch.precond.cheby_poly import ChebyshevPreconditioner
from sparse_matrix_math_tpu_torch.solvers import api
from test_torch_wsell import port_csr
from torch_layout_code import same_layout_code  # noqa: F401  (an autouse fixture)

S = smm.SolverStatus


def _variable_coefficients():
    a = jax_gen.poisson_2d(12, dtype=np.float64)
    d = np.asarray(a.data).copy()
    return a.with_data(jnp.asarray(d * (1.0 + 0.01 * (np.arange(d.size) % 7))))


def _shuffled():
    return jax_permute_csr(jax_gen.poisson_2d(64, dtype=np.float32),
                           np.random.default_rng(0).permutation(4096))


FORMAT_CASES = [
    ("grid_stencil", lambda: jax_gen.poisson_2d(16, dtype=np.float64), "GridStencilMatrix"),
    ("grid_stencil_3d", lambda: jax_gen.poisson_3d(6, dtype=np.float32), "GridStencilMatrix"),
    ("dia", _variable_coefficients, "DIAMatrix"),
    ("wsell", lambda: jax_gen.laplace_3d_jittered(14, symmetric=True, shift=0.25,
                                                   dtype=np.float32), "WSellMatrix"),
    ("rcm_wsell", _shuffled, "ReorderedMatrix"),
    ("routed", lambda: jax_gen.uniform_random_csr(20_000, per_row=5, seed=7, dtype=np.float32),
     "RoutedMatrix"),
    ("csr", lambda: jax_gen.uniform_random_csr(20_000, per_row=2, dtype=np.float32),
     "CSRMatrix"),
]


@pytest.mark.parametrize("name,make,expect", FORMAT_CASES, ids=[c[0] for c in FORMAT_CASES])
def test_best_format_matches_jax(name, make, expect):
    jcsr = make()
    tcsr = port_csr(jcsr)
    jbest, tbest = jsmm.best_format(jcsr), smm.best_format(tcsr)
    assert type(tbest).__name__ == type(jbest).__name__ == expect
    if expect == "CSRMatrix":
        assert tbest is tcsr
    for get in (lambda m: getattr(m, "slot_ratio", None),
                lambda m: getattr(getattr(m, "inner", None), "slot_ratio", None)):
        assert get(tbest) == get(jbest)
    x = np.random.default_rng(0).standard_normal(jcsr.shape[1]).astype(np.asarray(jcsr.data).dtype)
    want = np.asarray(jsmm.rmult(jcsr, jnp.asarray(x)))
    np.testing.assert_allclose((tbest @ torch.from_numpy(x)).numpy(), want, rtol=0,
                               atol=2e-6 * max(np.abs(want).max(), 1.0))


def test_best_format_without_reordering_matches_jax():
    jcsr = _shuffled()
    jbest = jsmm.best_format(jcsr, allow_reorder=False)
    tbest = smm.best_format(port_csr(jcsr), allow_reorder=False)
    assert type(tbest).__name__ == type(jbest).__name__ == "WSellMatrix"
    assert tbest.slot_ratio == jbest.slot_ratio
    # a tighter cap refuses the raw layout and keeps the CSR
    assert isinstance(smm.best_format(port_csr(jcsr), allow_reorder=False, max_slot_ratio=1.5),
                      smm.CSRMatrix)


def test_auto_route_warning_names_the_front_door(monkeypatch):
    monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
    tcsr = port_csr(jax_gen.uniform_random_csr(20_000, per_row=5, seed=7, dtype=np.float32))
    with pytest.warns(smm.PerformanceWarning, match="auto_format=True"):
        assert smm.auto_route_for_solve(tcsr) is tcsr


# -- configuration ---------------------------------------------------------------------


def test_solver_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(smm.SolverConfig)
            if f.default is not dataclasses.MISSING}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxSolverConfig)
              if f.default is not dataclasses.MISSING}
    assert ours == theirs
    assert [f.name for f in dataclasses.fields(smm.SolverConfig)] == [
        f.name for f in dataclasses.fields(JaxSolverConfig)]
    cfg = smm.SolverConfig(method="bicgstab").replace(epsilon=1e-6)
    assert (cfg.method, cfg.epsilon, cfg.preconditioner_options) == ("bicgstab", 1e-6, {})
    assert set(smm.SOLVERS) == set(JAX_SOLVERS)
    assert smm.SOLVERS["cg"] is smm.conjugate_gradient and smm.SOLVERS["cgs"] is smm.cgs


def _system(dtype=np.float64, n=16, conv=False):
    make = jax_gen.convection_diffusion_2d if conv else jax_gen.poisson_2d
    jcsr = make(n, dtype=dtype)
    b = np.random.default_rng(0).standard_normal(jcsr.shape[0]).astype(dtype)
    return jcsr, port_csr(jcsr), b


def assert_same(tres, jres, band=1, xtol=1e-8):
    assert tres.status == int(jres.status), (tres, jres)
    assert abs(tres.iterations - int(jres.iterations)) <= band, (tres, jres)
    jx = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - jx).max() <= xtol * np.abs(jx).max()


@pytest.mark.parametrize("method", ["cg", "conjugate_gradient", "bicg_symmetric", "cgs",
                                    "conjugate_gradient_squared", "bicgstab", "CG"])
def test_solve_methods_match_jax(method):
    jcsr, tcsr, b = _system()
    jres = jsmm.solve(jcsr, jnp.asarray(b), method=method, epsilon=1e-9)
    tres = smm.solve(tcsr, torch.from_numpy(b), method=method, epsilon=1e-9)
    wanders = method.lower() in ("cgs", "conjugate_gradient_squared", "bicgstab")
    assert_same(tres, jres, band=3 if wanders else 1, xtol=1e-6 if wanders else 1e-8)


def test_solve_config_and_overrides():
    _, tcsr, b = _system()
    tb = torch.from_numpy(b)
    cfg = smm.SolverConfig(method="cg", epsilon=1e-3, max_iterations=3)
    capped = smm.solve(tcsr, tb, config=cfg)
    assert capped.status == S.MAX_ITERATIONS_REACHED and capped.iterations == 3
    # an override beats the config, the config stays as it was
    res = smm.solve(tcsr, tb, config=cfg, max_iterations=-1, record_residuals=True)
    assert res.status == S.SUCCESS and res.residual_trace is not None
    assert cfg.max_iterations == 3
    direct = smm.cg(tcsr, tb, epsilon=1e-3)
    assert res.iterations == direct.iterations and torch.equal(res.x, direct.x)
    x0 = smm.solve(tcsr, tb, x0=direct.x, epsilon=1e-3)
    assert x0.iterations == 0 and x0.status == S.SUCCESS
    with pytest.raises(TypeError):
        smm.solve(tcsr, tb, tolerance=1e-3)


def test_unknown_method_lists_every_name():
    _, tcsr, b = _system()
    with pytest.raises(ValueError, match="unknown method 'sor'") as err:
        smm.solve(tcsr, torch.from_numpy(b), method="sor")
    for name in ("gmres", "chebyshev", "cg_pipelined", "cg_ir_df64", "bicg_symmetric"):
        assert name in str(err.value)
    with pytest.raises(ValueError, match="unknown method"):
        jsmm.solve(jax_gen.poisson_2d(4), jnp.ones(16), method="sor")


@pytest.mark.parametrize("what,kw", [
    ("gmres", dict(method="gmres")),
    ("chebyshev", dict(method="chebyshev")),
    ("cg_pipelined", dict(method="cg_pipelined")),
    ("multigrid", dict(preconditioner="multigrid")),
    ("mg", dict(preconditioner="mg", auto_format=True)),
])
def test_not_ported_yet_raises(what, kw):
    """The solver tail, which raised NotImplementedError until it was ported:
    each case now gives the JAX package's result (status, iterations within
    max(3, 10%) in f32, x), or the JAX package's exception type where it
    raises."""
    jcsr, tcsr, b = _system(np.float32)
    try:
        jres = jsmm.solve(jcsr, jnp.asarray(b), epsilon=1e-4, **kw)
    except Exception as err:  # noqa: BLE001  (the port must raise the same type)
        with pytest.raises(type(err)):
            smm.solve(tcsr, torch.from_numpy(b), epsilon=1e-4, **kw)
        return
    tres = smm.solve(tcsr, torch.from_numpy(b), epsilon=1e-4, **kw)
    assert type(tres).__name__ == type(jres).__name__
    assert tres.status == int(jres.status) == int(S.SUCCESS), (what, tres, jres)
    assert_same(tres, jres, band=max(3, int(jres.iterations) // 10), xtol=1e-3)


def test_wrong_length_b_raises_type_error():
    """A b whose length is not the matrix's: the JAX package's TypeError (it
    fails in broadcasting; the port checks the length)."""
    jcsr, tcsr, _ = _system(n=3)
    with pytest.raises(TypeError):
        jsmm.solve(jcsr, jnp.ones(10))
    for method in ("cg", "gmres", "cg_df64"):
        with pytest.raises(TypeError, match="rows"):
            smm.solve(tcsr, torch.ones(10, dtype=torch.float64), method=method)


def test_panel_rhs_raises():
    """A 2-D b goes to cg_multi (it raised before cg_multi was ported): a
    MultiSolveResult whose columns are the JAX package's; a method other
    than CG raises the JAX package's ValueError."""
    jcsr, tcsr, b = _system()
    panel = np.stack([b, -2.0 * b], axis=1)
    jres = jsmm.solve(jcsr, jnp.asarray(panel), epsilon=1e-9)
    tres = smm.solve(tcsr, torch.from_numpy(panel), epsilon=1e-9)
    assert isinstance(tres, smm.MultiSolveResult) and tres.x.shape == panel.shape
    for j in range(2):
        assert_same(tres[j], jres[j])
    with pytest.raises(ValueError, match="cg_multi"):
        smm.solve(tcsr, torch.from_numpy(panel), method="bicgstab")


# -- preconditioners through the front door -----------------------------------------------


@pytest.mark.parametrize("kind", ["jacobi", "sgs", "symmetric_gaus_seidel", "ic0", "ilu0"])
@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_preconditioner_strings_match_jax(method, kind):
    jcsr, tcsr, b = _system()
    jres = jsmm.solve(jcsr, jnp.asarray(b), method=method, preconditioner=kind, epsilon=1e-9)
    tres = smm.solve(tcsr, torch.from_numpy(b), method=method, preconditioner=kind,
                     epsilon=1e-9)
    assert_same(tres, jres, band=1 if method == "cg" else 3, xtol=1e-7)
    direct = getattr(smm, method)(tcsr, torch.from_numpy(b), epsilon=1e-9,
                                  preconditioner=smm.get_preconditioner(tcsr, kind))
    assert direct.iterations == tres.iterations and torch.equal(direct.x, tres.x)


def test_preconditioner_options_objects_and_refusals():
    jcsr, tcsr, b = _system()
    tb = torch.from_numpy(b)
    opts = dict(degree=3, eig_bounds=(0.05, 8.0))
    jres = jsmm.solve(jcsr, jnp.asarray(b), preconditioner="chebyshev",
                      preconditioner_options=opts, epsilon=1e-9)
    tres = smm.solve(tcsr, tb, preconditioner="chebyshev", preconditioner_options=opts,
                     epsilon=1e-9)
    assert_same(tres, jres)
    # an object passes through as it is
    pre = smm.JacobiPreconditioner.from_matrix(tcsr)
    assert api._build_preconditioner(tcsr, pre, {}) is pre
    obj = smm.solve(tcsr, tb, preconditioner=pre, epsilon=1e-9)
    named = smm.solve(tcsr, tb, preconditioner="jacobi", epsilon=1e-9)
    assert obj.iterations == named.iterations and torch.equal(obj.x, named.x)
    assert smm.solve(tcsr, tb, preconditioner=None, epsilon=1e-9).status == S.SUCCESS
    for method in ("cgs", "bicg_symmetric"):
        with pytest.raises(ValueError, match="does not take a preconditioner"):
            smm.solve(tcsr, tb, method=method, preconditioner="jacobi")
    with pytest.raises(KeyError):
        smm.solve(tcsr, tb, preconditioner="ssor")


def test_preconditioner_per_format():
    """DIA builds SGS as a PaddedSGS (sweeps 4) and Chebyshev directly; what a
    layout cannot build falls back to the CSR source, never across a
    permutation."""
    jcsr, tcsr, b = _system()
    tdia = smm.dia_from_csr(tcsr)
    psgs = api._build_preconditioner(tdia, "sgs", {})
    assert isinstance(psgs, PaddedSGS) and psgs.sweeps == 4
    assert api._build_preconditioner(tdia, "SGS", dict(sweeps=2)).sweeps == 2
    cheb = api._build_preconditioner(tdia, "poly", dict(eig_bounds=(0.1, 8.0)))
    assert isinstance(cheb, ChebyshevPreconditioner) and cheb.a is tdia
    with pytest.raises(ValueError, match="not buildable for DIAMatrix"):
        api._build_preconditioner(tdia, "ic0", {})
    assert isinstance(api._build_preconditioner_for(tdia, tcsr, "ic0", {}),
                      smm.IC0Preconditioner)
    with pytest.raises(ValueError, match="not buildable"):
        api._build_preconditioner_for(tdia, tdia, "ic0", {})
    jres = jsmm.solve(jsmm.dia_from_csr(jcsr), jnp.asarray(b), method="bicgstab",
                      preconditioner="sgs", epsilon=1e-9)
    tres = smm.solve(tdia, torch.from_numpy(b), method="bicgstab", preconditioner="sgs",
                     epsilon=1e-9)
    assert_same(tres, jres, band=3, xtol=1e-7)
    # a reordered operator factors its PERMUTED matrix
    shuffled = port_csr(_shuffled())
    ro = smm.reorder_to_wsell(shuffled)
    pre = api._build_preconditioner(ro, "jacobi", {})
    assert torch.equal(pre.inv_diag, smm.JacobiPreconditioner.from_matrix(ro.inner_csr).inv_diag)
    bare = dataclasses.replace(ro, inner_csr=None)
    with pytest.raises(ValueError, match="no permuted CSR"):
        api._build_preconditioner_for(bare, shuffled, "jacobi", {})


# -- auto_format ------------------------------------------------------------------------------


def _spy_solvers(monkeypatch):
    """Record the operator each solver of the table is called with."""
    seen = []
    for name, fn in list(api.SOLVERS.items()):
        def spy(a, *args, _fn=fn, **kw):
            seen.append(a)
            return _fn(a, *args, **kw)
        monkeypatch.setitem(api.SOLVERS, name, spy)
    return seen


@pytest.mark.parametrize("name,make,expect", FORMAT_CASES[:6], ids=[c[0] for c in FORMAT_CASES[:6]])
def test_solve_auto_format_routes_and_solves(monkeypatch, name, make, expect):
    jcsr = make()
    tcsr = port_csr(jcsr)
    seen = _spy_solvers(monkeypatch)
    x_true = np.random.default_rng(1).standard_normal(jcsr.shape[0]).astype(
        np.asarray(jcsr.data).dtype)
    b = tcsr @ torch.from_numpy(x_true)
    method = "bicgstab" if name == "routed" else "cg"
    eps = 1e-9 if b.dtype == torch.float64 else 1e-3
    res = smm.solve(tcsr, b, method=method, auto_format=True, epsilon=eps)
    assert type(seen[-1]).__name__ == expect
    assert res.status == S.SUCCESS and res.x.shape == b.shape
    assert float(torch.linalg.norm(b - tcsr @ res.x)) <= 1.5 * eps
    plain = smm.solve(tcsr, b, method=method, epsilon=eps)
    assert type(seen[-1]).__name__ == "CSRMatrix" and plain.status == S.SUCCESS


def test_solve_auto_format_matches_jax():
    jcsr, tcsr, b = _system(n=24)
    jres = jsmm.solve(jcsr, jnp.asarray(b), auto_format=True, epsilon=1e-9)
    tres = smm.solve(tcsr, torch.from_numpy(b), auto_format=True, epsilon=1e-9)
    assert_same(tres, jres)
    jres = jsmm.solve(jcsr, jnp.asarray(b), auto_format=True, preconditioner="jacobi",
                      method="bicgstab", epsilon=1e-9)
    tres = smm.solve(tcsr, torch.from_numpy(b), auto_format=True, preconditioner="jacobi",
                     method="bicgstab", epsilon=1e-9)
    assert_same(tres, jres, band=3, xtol=1e-7)


@pytest.mark.parametrize("kind,expect", [("sgs", "DIAMatrix"), ("ic0", "DIAMatrix"),
                                         ("ilu0", "DIAMatrix"), ("jacobi", "GridStencilMatrix"),
                                         ("chebyshev", "GridStencilMatrix"),
                                         ("none", "GridStencilMatrix")])
def test_auto_format_keeps_dia_for_dia_features(monkeypatch, kind, expect):
    """A stencil-detectable matrix stays on the DIA layout when the
    preconditioner rides the padded machinery (tests/test_stencil.py)."""
    jcsr, tcsr, b = _system(np.float32)
    seen = _spy_solvers(monkeypatch)
    opts = dict(eig_bounds=(0.05, 8.0)) if kind == "chebyshev" else {}
    res = smm.solve(tcsr, torch.from_numpy(b), method="cg", preconditioner=kind,
                    preconditioner_options=opts, auto_format=True, epsilon=1e-3)
    assert type(seen[-1]).__name__ == expect and res.status == S.SUCCESS
    jres = jsmm.solve(jcsr, jnp.asarray(b), method="cg", preconditioner=kind,
                      preconditioner_options=opts, auto_format=True, epsilon=1e-3)
    assert res.status == int(jres.status) and abs(res.iterations - int(jres.iterations)) <= 2


def test_auto_format_with_reordering_and_a_preconditioner():
    jcsr = _shuffled()
    tcsr = port_csr(jcsr)
    x_true = np.random.default_rng(2).standard_normal(4096).astype(np.float32)
    b = tcsr @ torch.from_numpy(x_true)
    res = smm.solve(tcsr, b, auto_format=True, preconditioner="ic0", epsilon=1e-3)
    jres = jsmm.solve(jcsr, jnp.asarray(b.numpy()), auto_format=True, preconditioner="ic0",
                      epsilon=1e-3)
    assert res.status == int(jres.status) == S.SUCCESS
    assert abs(res.iterations - int(jres.iterations)) <= 2
    assert float(torch.linalg.norm(b - tcsr @ res.x)) <= 2e-3


# -- the double-word methods, the pre-route and the floor escalation --------------------------


def _f32_system(nx=64):
    """tests/test_floor_escalation.py's system: f32 Poisson, b = row sums."""
    a64 = jax_gen.poisson_2d(nx, dtype=np.float64)
    data = np.asarray(a64.data, np.float64)
    indptr = np.asarray(a64.indptr, np.int64)
    b64 = np.add.reduceat(data, indptr[:-1])
    jcsr = jax_gen.poisson_2d(nx, dtype=np.float32)
    return jcsr, port_csr(jcsr), b64, (data, np.asarray(a64.indices, np.int64), indptr)


def _true_res(host, b64, x):
    data, indices, indptr = host
    return float(np.linalg.norm(b64 - np.add.reduceat(data * np.asarray(x, np.float64)[indices],
                                                      indptr[:-1])))


@pytest.mark.parametrize("method", ["cg_df64", "bicgstab_df64", "cg_ir_df64",
                                    "bicgstab_ir_df64"])
def test_df64_methods_through_solve_match_jax(method):
    jcsr, tcsr, b64, host = _f32_system(24)
    jres = jsmm.solve(jcsr, b64, method=method, epsilon=1e-9)
    tres = smm.solve(tcsr, b64, method=method, epsilon=1e-9)
    assert isinstance(tres, smm.DfSolveResult)
    assert tres.status == int(jres.status) == S.SUCCESS
    # the refinements' f32 inner counts move with the inner dots' summation order
    band = 0.10 if "_ir_" in method else 0.05
    assert abs(tres.iterations - int(jres.iterations)) <= max(3, band * int(jres.iterations))
    assert _true_res(host, b64, tres.x_f64()) <= 1e-9
    with pytest.raises(ValueError, match="does not record residual traces"):
        smm.solve(tcsr, b64, method=method, record_residuals=True)


def test_df64_methods_preconditioner_rules():
    _, tcsr, b64, host = _f32_system(24)
    pre = smm.JacobiPreconditioner.from_matrix(tcsr)
    res = smm.solve(tcsr, b64, method="cg_ir_df64", preconditioner=pre, epsilon=1e-9)
    assert res.status == S.SUCCESS and _true_res(host, b64, res.x_f64()) <= 1e-9
    with pytest.raises(ValueError, match="preconditioner OBJECT"):
        smm.solve(tcsr, b64, method="bicgstab_ir_df64", preconditioner="sgs")
    with pytest.raises(ValueError, match="does not take a preconditioner yet"):
        smm.solve(tcsr, b64, method="cg_df64", preconditioner=pre)


def test_capped_run_is_no_floor_and_floored_run_is():
    jcsr, tcsr, b64, _ = _f32_system(64)
    b = torch.tensor(b64, dtype=torch.float32)
    capped = smm.cg(tcsr, b, max_iterations=3, epsilon=1e-5)
    assert capped.status == S.MAX_ITERATIONS_REACHED
    assert capped.floor_hit is False and not capped.hit_precision_floor
    floored = smm.cg(tcsr, b, epsilon=1e-6)
    jfloored = jsmm.cg(jcsr, jnp.asarray(b64, jnp.float32), epsilon=1e-6)
    assert floored.status == int(jfloored.status) == S.MAX_ITERATIONS_REACHED
    assert floored.floor_hit and bool(jfloored.floor_hit) and floored.hit_precision_floor


@pytest.mark.parametrize("auto_format", [False, True], ids=["csr", "auto_format"])
def test_solve_pre_routes_to_1e8(monkeypatch, auto_format):
    """solve(a, b, epsilon=1e-8) on f32 data returns SUCCESS with a true
    residual at the bar through the double-word refinement, and never runs
    the doomed f32 pass."""
    jcsr, tcsr, b64, host = _f32_system(64)
    seen = _spy_solvers(monkeypatch)
    res = smm.solve(tcsr, torch.tensor(b64, dtype=torch.float32), method="cg", epsilon=1e-8,
                    auto_format=auto_format)
    assert isinstance(res, smm.DfSolveResult) and res.status == S.SUCCESS and not seen
    data32 = host[0].astype(np.float32).astype(np.float64)
    tr = _true_res((data32,) + host[1:], np.add.reduceat(data32, host[2][:-1]), res.x_f64())
    assert tr <= 1e-7  # b was rounded to f32 too
    jres = jsmm.solve(jcsr, jnp.asarray(b64, jnp.float32), method="cg", epsilon=1e-8,
                      auto_format=auto_format)
    assert type(jres).__name__ == "DfSolveResult" and int(jres.status) == S.SUCCESS
    assert res.outer_rounds == int(jres.outer_rounds)
    assert abs(res.iterations - int(jres.iterations)) <= 0.05 * int(jres.iterations)


def test_solve_escalates_a_floored_run(monkeypatch):
    """An epsilon above the pre-route's estimate and below the f32 floor:
    the f32 pass runs, stops with floor_hit, and the refinement goes on from
    its iterate."""
    jcsr, tcsr, b64, host = _f32_system(64)
    b = torch.tensor(b64, dtype=torch.float32)
    eps = 4e-6
    assert eps > float(torch.finfo(torch.float32).eps) * float(torch.linalg.norm(b))
    seen = _spy_solvers(monkeypatch)
    res = smm.solve(tcsr, b, method="cg", epsilon=eps)
    assert len(seen) == 1 and isinstance(res, smm.DfSolveResult) and res.status == S.SUCCESS
    assert float(res.residual_norm2) ** 0.5 <= eps
    jres = jsmm.solve(jcsr, jnp.asarray(b64, jnp.float32), method="cg", epsilon=eps)
    assert type(jres).__name__ == "DfSolveResult" and int(jres.status) == S.SUCCESS
    # what does not apply: a success, a cap, an opt-out, a solver with no floor_hit
    ok = smm.cg(tcsr, b, epsilon=1e-3)
    assert api._maybe_escalate(ok, tcsr, b, smm.SolverConfig(epsilon=1e-3), "cg", {}) is None
    capped = smm.cg(tcsr, b, epsilon=eps, max_iterations=3)
    assert api._maybe_escalate(capped, tcsr, b, smm.SolverConfig(epsilon=eps), "cg", {}) is None
    floored = smm.cg(tcsr, b, epsilon=eps)
    assert api._maybe_escalate(floored, tcsr, b, smm.SolverConfig(epsilon=eps), "cgs", {}) is None
    assert isinstance(api._maybe_escalate(floored, tcsr, b, smm.SolverConfig(epsilon=eps), "cg",
                                          {}), smm.DfSolveResult)


def test_escalation_opt_outs():
    _, tcsr, b64, _ = _f32_system(48)
    b = torch.tensor(b64, dtype=torch.float32)
    res = smm.solve(tcsr, b, method="cg", epsilon=1e-8, auto_escalate=False)
    assert isinstance(res, smm.SolveResult) and res.status != S.SUCCESS
    traced = smm.solve(tcsr, b, method="cg", epsilon=1e-8, record_residuals=True)
    assert isinstance(traced, smm.SolveResult) and traced.residual_trace is not None
    # bicg_symmetric and cgs report no floor to escalate from
    assert isinstance(smm.solve(tcsr, b, method="cgs", epsilon=1e-8, max_iterations=50),
                      smm.SolveResult)
    # f64 data is never pre-routed
    b64t = torch.tensor(b64)
    res64 = smm.solve(port_csr(jax_gen.poisson_2d(48, dtype=np.float64)), b64t, epsilon=1e-8)
    assert isinstance(res64, smm.SolveResult) and res64.status == S.SUCCESS


def test_solve_escalates_bicgstab_with_a_preconditioner():
    """The nonsymmetric refinement through the front door, its SGS object
    carried into the inner solve."""
    jcsr = jax_gen.convection_diffusion_2d(32, dtype=np.float32)
    tcsr = port_csr(jcsr)
    data = np.asarray(jcsr.data, np.float64)
    indptr = np.asarray(jcsr.indptr, np.int64)
    host = (data, np.asarray(jcsr.indices, np.int64), indptr)
    x_true = np.random.default_rng(0).standard_normal(1024)
    b64 = np.add.reduceat(data * x_true[host[1]], indptr[:-1])
    res = smm.solve(tcsr, torch.tensor(b64, dtype=torch.float32), method="bicgstab",
                    preconditioner="sgs", epsilon=1e-8)
    assert isinstance(res, smm.DfSolveResult) and res.status == S.SUCCESS
    b32 = b64.astype(np.float32).astype(np.float64)
    assert _true_res(host, b32, res.x_f64()) <= 1e-8


def test_solve_escalates_sherman1_bicgstab():
    """sherman1 (not SPD) at 1e-8 through the front door with SGS."""
    tcsr = smm.load_matrix_csr(asset_path(SHERMAN1), dtype=torch.float32, device="cpu")
    data = tcsr.data.numpy().astype(np.float64)
    host = (data, tcsr.indices.numpy(), tcsr.indptr.numpy())
    b64 = np.add.reduceat(data, host[2][:-1])
    res = smm.solve(tcsr, torch.tensor(b64, dtype=torch.float32), method="bicgstab",
                    epsilon=1e-8, preconditioner="sgs")
    assert isinstance(res, smm.DfSolveResult) and res.status == S.SUCCESS
    assert _true_res(host, b64, res.x_f64()) <= 1e-7


def test_stencil_operator_escalates_through_its_double_word_twin():
    jcsr, tcsr, b64, host = _f32_system(32)
    st32 = try_grid_stencil_from_csr(tcsr)
    res = smm.solve(st32, torch.tensor(b64, dtype=torch.float32), method="cg", epsilon=1e-8)
    assert isinstance(res, smm.DfSolveResult) and res.status == S.SUCCESS
    assert _true_res(host, b64, res.x_f64()) <= 1e-7
    jres = jsmm.solve(jsmm.try_grid_stencil_from_csr(jcsr), jnp.asarray(b64, jnp.float32),
                      method="cg", epsilon=1e-8)
    assert res.outer_rounds == int(jres.outer_rounds)


def test_df_operator_for_each_format():
    _, tcsr, _, _ = _f32_system(16)
    assert isinstance(api._df_operator_for(tcsr), smm.DfDiaMatrix)
    dia = smm.dia_from_csr(tcsr)
    dfd = api._df_operator_for(dia)
    assert isinstance(dfd, smm.DfDiaMatrix) and torch.equal(dfd.diags_hi, dia.diags)
    assert bool((dfd.diags_lo == 0).all()) and api._df_operator_for(dfd) is dfd
    assert isinstance(api._df_operator_for(try_grid_stencil_from_csr(tcsr)), smm.DfGridStencil)
    ws = smm.wsell_from_csr(tcsr)
    assert api._df_operator_for(ws) is None
    # no double-word twin: the pre-route steps aside and the plain solve runs
    b = tcsr @ torch.ones(256)
    res = smm.solve(ws, b, epsilon=1e-8, max_iterations=400)
    assert isinstance(res, smm.SolveResult)
