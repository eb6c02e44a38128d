"""The port's multi-RHS CG (solvers/block.py: ``cg_multi``, ``MultiSolveResult``,
``solve()`` with a 2-D ``b``) held against the JAX package's.

The cases twin tests/test_block.py, each run through both packages on the
same seeded numpy inputs, plus the port's own operator branches (ELL and
R-SELL panels, the explicit DIA panel apply, RCM + W-SELL through the
hoist, the padded DIA preconditioners column by column) and its loop (a
frozen chunk iteration keeps the state bit for bit).  Tolerances: status
equal; iterations within 1 in f64 and within max(3, 10%) in f32 (the dots
sum in another order than XLA's); x to 1e-8 of max|x| in f64 and 1e-3 in
f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense as jax_csr_from_dense
from sparse_matrix_math_tpu.formats.reorder import permute_csr as jax_permute_csr
from sparse_matrix_math_tpu.formats.stencil import try_grid_stencil_from_csr as jax_stencil
from sparse_matrix_math_tpu.formats.wsell import wsell_from_csr as jax_wsell_from_csr
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.solvers import _loop
from sparse_matrix_math_tpu_torch.solvers import block as B
from test_torch_wsell import port_csr
from torch_layout_code import same_layout_code  # noqa: F401  (an autouse fixture)

S = smm.SolverStatus
XTOL = {np.float32: 1e-3, np.float64: 1e-8}


def its_band(dtype, its: int) -> int:
    return 1 if dtype == np.float64 else max(3, int(0.1 * its))


def assert_columns_match(tres, jres, dtype):
    """Status equal per column, iterations within the band, x close."""
    tstat, jstat = tres.status.tolist(), np.asarray(jres.status).tolist()
    assert tstat == jstat, (tstat, jstat)
    for t_it, j_it in zip(tres.iterations.tolist(), np.asarray(jres.iterations).tolist()):
        assert abs(t_it - j_it) <= its_band(dtype, j_it), (tres.iterations, jres.iterations)
    jx = np.asarray(jres.x)
    assert tres.x.shape == jx.shape
    assert np.abs(tres.x.numpy() - jx).max() <= XTOL[dtype] * max(np.abs(jx).max(), 1.0)


def _panel(n, m, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal((n, m)).astype(dtype)


# -- tests/test_block.py::TestCGMulti ---------------------------------------------------


def test_matches_per_column_cg(dtype):
    jcsr = jax_gen.poisson_2d(12, dtype=dtype)
    tcsr = port_csr(jcsr)
    b = _panel(jcsr.shape[0], 4, dtype)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-5)
    tres = smm.cg_multi(tcsr, torch.from_numpy(b), epsilon=1e-5)
    assert isinstance(tres, smm.MultiSolveResult) and tres.x.shape == b.shape
    assert tres.status.dtype == tres.iterations.dtype == torch.int32
    assert_columns_match(tres, jres, dtype)
    for j in range(4):
        single = smm.cg(tcsr, torch.from_numpy(b[:, j].copy()), epsilon=1e-5)
        assert int(tres.status[j]) == single.status == S.SUCCESS
        assert abs(int(tres.iterations[j]) - single.iterations) <= its_band(dtype,
                                                                            single.iterations)
        tol = XTOL[dtype] * float(single.x.abs().max())
        assert float((tres.x[:, j] - single.x).abs().max()) <= tol


def test_mixed_convergence_freezes_columns():
    """A zero column converges at iteration 0 and freezes there while the
    other column goes on."""
    jcsr = jax_gen.poisson_2d(10, dtype=np.float64)
    n = jcsr.shape[0]
    b = np.stack([np.zeros(n), np.asarray(jcsr @ jnp.ones(n))], axis=1)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-10)
    tres = smm.cg_multi(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-10)
    assert_columns_match(tres, jres, np.float64)
    assert tres.status.tolist() == [S.SUCCESS, S.SUCCESS]
    assert int(tres.iterations[0]) == 0 and int(tres.iterations[1]) > 0
    assert torch.equal(tres.x[:, 0], torch.zeros(n, dtype=torch.float64))
    np.testing.assert_allclose(tres.x[:, 1].numpy(), 1.0, atol=1e-8)


def test_per_column_divergence_isolated():
    """diag(1, -1): column 0 hits p.A.p = 0 and reports DIVERGED without
    poisoning column 1, solvable in one step."""
    d = np.diag([1.0, -1.0])
    b = np.array([[1.0, 1.0], [1.0, 0.0]])
    jres = jsmm.cg_multi(jax_csr_from_dense(d), jnp.asarray(b), max_iterations=50,
                         epsilon=1e-12)
    tres = smm.cg_multi(port_csr(jax_csr_from_dense(d)), torch.from_numpy(b),
                        max_iterations=50, epsilon=1e-12)
    assert_columns_match(tres, jres, np.float64)
    assert tres.status.tolist() == [S.DIVERGED, S.SUCCESS]
    np.testing.assert_allclose(tres.x[:, 1].numpy(), [1.0, 0.0], atol=1e-12)


def test_getitem_view():
    jcsr = jax_gen.poisson_2d(6, dtype=np.float64)
    n = jcsr.shape[0]
    b = np.array(jcsr @ jnp.ones((n, 3)))
    tres = smm.cg_multi(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-10)
    jone = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-10)[1]
    one = tres[1]
    assert isinstance(one, smm.SolveResult) and one.residual_trace is None
    assert one.status == int(jone.status) == S.SUCCESS
    assert abs(one.iterations - int(jone.iterations)) <= 1
    assert torch.equal(one.x, tres.x[:, 1]) and torch.equal(one.residual_norm,
                                                            tres.residual_norm[1])
    np.testing.assert_allclose(one.x.numpy(), 1.0, atol=1e-8)


def test_solve_api_routes_2d_b():
    jcsr = jax_gen.poisson_2d(6, dtype=np.float64)
    n = jcsr.shape[0]
    b = np.array(jcsr @ jnp.ones((n, 2)))
    tcsr = port_csr(jcsr)
    tres = smm.solve(tcsr, torch.from_numpy(b), method="cg", epsilon=1e-10)
    assert_columns_match(tres, jsmm.solve(jcsr, jnp.asarray(b), method="cg", epsilon=1e-10),
                         np.float64)
    assert tres.x.shape == (n, 2)
    for method in ("bicgstab", "cgs", "bicg_symmetric"):
        with pytest.raises(ValueError, match="method='cg'"):
            smm.solve(tcsr, torch.from_numpy(b), method=method)
        with pytest.raises(ValueError):
            jsmm.solve(jcsr, jnp.asarray(b), method=method)


def test_rejects_1d():
    jcsr = jax_gen.poisson_2d(4, dtype=np.float64)
    with pytest.raises(ValueError):
        jsmm.cg_multi(jcsr, jnp.ones(16))
    with pytest.raises(ValueError, match=r"\(n, m\)"):
        smm.cg_multi(port_csr(jcsr), torch.ones(16, dtype=torch.float64))


# -- tests/test_block.py::TestCGMultiOverFormats, and the port's branches ----------------


def test_wsell_operator_matches_csr():
    """Over a W-SELL operator every panel product is the panel kernel's
    plain version (K8's); it matches the CSR run and the JAX W-SELL run."""
    jcsr = jax_gen.poisson_2d(16, dtype=np.float32)
    b = _panel(jcsr.shape[0], 3, np.float32, seed=3)
    ws = smm.wsell_from_csr(port_csr(jcsr))
    ref = smm.cg_multi(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-4)
    got = smm.cg_multi(ws, torch.from_numpy(b), epsilon=1e-4)
    jgot = jsmm.cg_multi(jax_wsell_from_csr(jcsr), jnp.asarray(b), epsilon=1e-4)
    assert got.status.tolist() == ref.status.tolist()
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), rtol=1e-3, atol=1e-4)
    assert_columns_match(got, jgot, np.float32)


@pytest.mark.parametrize("fmt", ["ell", "routed", "dia", "dense"])
def test_operator_branches_match_jax(fmt, dtype):
    """ELL (the panel kernel over its layout), R-SELL (one chain per column),
    DIA (the explicit shifted-slice panel apply) and a dense tensor, each
    against the JAX cg_multi over the same matrix's CSR."""
    if fmt == "routed":
        jcsr = jax_gen.random_spd_csr(400, density=0.02, seed=3, dtype=dtype)
    else:
        jcsr = jax_gen.poisson_2d(14, dtype=dtype)
    tcsr = port_csr(jcsr)
    op = {"ell": lambda: smm.ell_from_csr(tcsr),
          "routed": lambda: smm.routed_from_csr(tcsr, max_slot_ratio=99.0),
          "dia": lambda: smm.dia_from_csr(tcsr),
          "dense": lambda: tcsr.to_dense()}[fmt]()
    b = _panel(jcsr.shape[0], 3, dtype, seed=5)
    eps = 1e-4 if dtype == np.float32 else 1e-9
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=eps)
    assert_columns_match(smm.cg_multi(op, torch.from_numpy(b), epsilon=eps), jres, dtype)


def test_dia_panel_apply_equals_rmult():
    """The explicit DIA panel apply (offsets on both sides, rectangular)
    equals the port's per-column DIA product."""
    rng = np.random.default_rng(8)
    d = np.zeros((50, 40))
    for off in (-7, -1, 0, 3, 12):
        i = np.arange(50)
        ok = (i + off >= 0) & (i + off < 40)
        d[i[ok], i[ok] + off] = rng.standard_normal(int(ok.sum()))
    dia = smm.dia_from_csr(port_csr(jax_csr_from_dense(d)))
    xs = torch.from_numpy(rng.standard_normal((40, 3)))
    got = B._dia_panel_matvec(dia)(xs)
    want = torch.stack([smm.rmult(dia, xs[:, j].contiguous()) for j in range(3)], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-14)
    np.testing.assert_allclose(got.numpy(), d @ xs.numpy(), rtol=0, atol=1e-13)


def test_reordered_operator_hoists_the_permutation():
    """RCM + W-SELL: cg_multi runs in the permuted domain (reorder_hoisted)
    and returns x in the original order, as the JAX package does."""
    jcsr = jax_permute_csr(jax_gen.poisson_2d(24, dtype=np.float64),
                           np.random.default_rng(0).permutation(576))
    op = smm.reorder_to_wsell(port_csr(jcsr), max_slot_ratio=64)
    assert isinstance(op, smm.ReorderedMatrix)
    b = _panel(576, 2, np.float64, seed=6)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-9)
    assert_columns_match(smm.cg_multi(op, torch.from_numpy(b), epsilon=1e-9), jres, np.float64)


def test_callable_operator_runs_column_by_column():
    jcsr = jax_gen.poisson_2d(8, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = _panel(64, 2, np.float64, seed=2)
    seen = []

    def matvec(v):
        seen.append(tuple(v.shape))
        return smm.rmult(tcsr, v)

    tres = smm.cg_multi(matvec, torch.from_numpy(b), epsilon=1e-10)
    assert set(seen) == {(64,)}
    assert_columns_match(tres, jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-10), np.float64)


def test_max_iterations_reports_the_true_residual():
    """Columns stopped at the cap get the panel's true residual, as JAX."""
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    b = _panel(144, 3, np.float64, seed=4)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), max_iterations=7, epsilon=1e-12)
    B.reset_loop_counts()
    tres = smm.cg_multi(port_csr(jcsr), torch.from_numpy(b), max_iterations=7, epsilon=1e-12)
    assert_columns_match(tres, jres, np.float64)
    assert tres.status.tolist() == [S.MAX_ITERATIONS_REACHED] * 3
    assert tres.iterations.tolist() == [7] * 3 and B.loop_counts["residual_fixes"] == 1
    true = np.linalg.norm(b - np.asarray(jcsr.to_dense()) @ tres.x.numpy(), axis=0)
    np.testing.assert_allclose(tres.residual_norm.numpy(), true, rtol=1e-10)
    np.testing.assert_allclose(tres.residual_norm.numpy(), np.asarray(jres.residual_norm),
                               rtol=1e-8)


def test_frozen_chunk_iterations_keep_the_state(monkeypatch):
    """The loop with one iteration per chunk (no frozen iteration) and with
    the default chunk gives the same result bit for bit."""
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    b = _panel(144, 3, np.float64, seed=7)
    b[:, 1] = 0.0
    pre = smm.get_preconditioner(port_csr(jcsr), "jacobi")
    runs = []
    for chunk in (1, _loop.CHUNK):
        monkeypatch.setattr(_loop, "CHUNK", chunk)
        runs.append(smm.cg_multi(port_csr(jcsr), torch.from_numpy(b), epsilon=1e-9,
                                 preconditioner=pre, record_residuals=True))
    one, many = runs
    for f in ("x", "status", "iterations", "residual_norm"):
        assert torch.equal(getattr(one, f), getattr(many, f)), f
    assert torch.equal(one.residual_trace.isnan(), many.residual_trace.isnan())
    assert torch.equal(one.residual_trace.nan_to_num(), many.residual_trace.nan_to_num())


def test_loop_counts_predict_the_panel_products():
    """Panel products of a solve: steps + rounds + 1 + residual fixes; a
    preconditioner's applies: steps + rounds + 1."""
    jcsr = jax_gen.poisson_2d(10, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = _panel(100, 2, np.float64, seed=1)
    calls = {"mv": 0, "pre": 0}
    jac = smm.get_preconditioner(tcsr, "jacobi")

    class Counted:
        def apply(self, r):
            calls["pre"] += 1
            return jac.apply(r)

    def matvec(xs):
        calls["mv"] += 1
        return smm.rmult(tcsr, xs)

    B.reset_loop_counts()
    pn = B._Panel.of(tcsr, Counted(), 2)
    pn = B._Panel(pn.lift, pn.drop, matvec, pn.mapply, pn.cb, pn.coldot)
    res = B._cg_multi_loop(pn, torch.from_numpy(b), torch.zeros(100, 2, dtype=torch.float64),
                           1e-10, 100, False)
    c = B.loop_counts
    assert res.status.tolist() == [S.SUCCESS, S.SUCCESS]
    assert c["steps"] >= int(res.iterations.max()) and c["rounds"] >= 1
    assert calls["mv"] == c["steps"] + c["rounds"] + 1 + c["residual_fixes"]
    assert calls["pre"] == c["steps"] + c["rounds"] + 1


# -- tests/test_block.py::TestCGMultiPreconditioned ---------------------------------------


@pytest.mark.parametrize("kind", ["jacobi", "sgs", "ic0"])
def test_matches_per_column_pcg(kind):
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = _panel(144, 3, np.float64, seed=1)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-8,
                         preconditioner=jsmm.get_preconditioner(jcsr, kind))
    pre = smm.get_preconditioner(tcsr, kind)
    tres = smm.cg_multi(tcsr, torch.from_numpy(b), epsilon=1e-8, preconditioner=pre)
    assert_columns_match(tres, jres, np.float64)
    for j in range(3):
        single = smm.cg(tcsr, torch.from_numpy(b[:, j].copy()), preconditioner=pre,
                        epsilon=1e-8)
        assert int(tres.status[j]) == single.status == S.SUCCESS
        assert abs(int(tres.iterations[j]) - single.iterations) <= 1
        np.testing.assert_allclose(tres.x[:, j].numpy(), single.x.numpy(), rtol=5e-6,
                                   atol=5e-8)


def test_preconditioning_reduces_iterations():
    jcsr = jax_gen.poisson_2d(24, dtype=np.float64)
    tcsr = port_csr(jcsr)
    b = np.array(jcsr @ jnp.ones((576, 2)))
    plain = smm.cg_multi(tcsr, torch.from_numpy(b), epsilon=1e-10)
    pre = smm.solve(tcsr, torch.from_numpy(b), method="cg", preconditioner="sgs",
                    epsilon=1e-10)
    jpre = jsmm.solve(jcsr, jnp.asarray(b), method="cg", preconditioner="sgs", epsilon=1e-10)
    assert_columns_match(pre, jpre, np.float64)
    assert pre.status.tolist() == [S.SUCCESS] * 2
    assert int(pre.iterations.max()) < int(plain.iterations.max())
    np.testing.assert_allclose(pre.x.numpy(), 1.0, atol=1e-7)


def test_wsell_strict_factors_through_the_panel_kernel():
    """IC0 with W-SELL strict parts: each sweep's strict product of the
    panel is the panel kernel's plain version, against JAX's IC0 panel."""
    jcsr = jax_gen.laplace_3d_jittered(12, symmetric=True, shift=0.25, dtype=np.float64)
    kw = dict(method="jacobi", sweeps=4, strict_layout="wsell")
    pre = smm.IC0Preconditioner.from_matrix(port_csr(jcsr), **kw)
    assert pre.lower.wsell is not None and pre.upper.wsell is not None
    b = _panel(jcsr.shape[0], 3, np.float64, seed=9)
    jres = jsmm.cg_multi(jcsr, jnp.asarray(b), epsilon=1e-9,
                         preconditioner=jsmm.get_preconditioner(jcsr, "ic0", **kw))
    ws = smm.wsell_from_csr(port_csr(jcsr))
    assert_columns_match(smm.cg_multi(ws, torch.from_numpy(b), epsilon=1e-9,
                                      preconditioner=pre), jres, np.float64)


def test_padded_dia_preconditioner_runs_column_by_column():
    """solve() on a DIA matrix with 'sgs' builds a PaddedSGS, whose apply
    takes one vector: the panel goes through it column by column."""
    jcsr = jax_gen.poisson_2d(12, dtype=np.float64)
    dia = smm.dia_from_csr(port_csr(jcsr))
    b = _panel(144, 2, np.float64, seed=3)
    tres = smm.solve(dia, torch.from_numpy(b), preconditioner="sgs", epsilon=1e-9)
    jres = jsmm.solve(jsmm.dia_from_csr(jcsr), jnp.asarray(b), preconditioner="sgs",
                      epsilon=1e-9)
    assert_columns_match(tres, jres, np.float64)


# -- tests/test_block.py::TestCGMultiTraces and the regression cases ----------------------


def test_per_column_trace_matches_single():
    jcsr = jax_gen.poisson_2d(10, dtype=np.float64)
    tcsr = port_csr(jcsr)
    n = 100
    b = np.stack([np.asarray(jcsr @ jnp.ones(n)), np.zeros(n)], axis=1)
    tres = smm.solve(tcsr, torch.from_numpy(b), method="cg", epsilon=1e-10,
                     record_residuals=True)
    jres = jsmm.solve(jcsr, jnp.asarray(b), method="cg", epsilon=1e-10, record_residuals=True)
    assert tres.residual_trace.shape == (n + 1, 2)
    single = smm.cg(tcsr, torch.from_numpy(b[:, 0].copy()), epsilon=1e-10,
                    record_residuals=True)
    k = single.iterations
    np.testing.assert_allclose(tres.residual_trace[:k + 1, 0].numpy(),
                               single.residual_trace[:k + 1].numpy(), rtol=1e-10, atol=5e-14)
    jt = np.asarray(jres.residual_trace)
    np.testing.assert_array_equal(np.isnan(tres.residual_trace.numpy()), np.isnan(jt))
    np.testing.assert_allclose(np.nan_to_num(tres.residual_trace.numpy()), np.nan_to_num(jt),
                               rtol=1e-10, atol=5e-14)
    col1 = tres.residual_trace[:, 1].numpy()
    assert col1[0] == 0.0 and np.isnan(col1[1:]).all()
    assert torch.equal(tres[0].residual_trace.nan_to_num(),
                       tres.residual_trace[:, 0].nan_to_num())


def test_trace_off_by_default():
    tcsr = port_csr(jax_gen.poisson_2d(6, dtype=np.float64))
    b = smm.rmult(tcsr, torch.ones(36, 2, dtype=torch.float64))
    assert smm.cg_multi(tcsr, b).residual_trace is None


def test_broken_column_keeps_last_finite_iterate():
    d = np.diag(np.array([1.0, -1.0, 2, 3, 4, 5, 6, 7]))
    b = np.zeros((8, 2))
    b[0, 0] = b[1, 0] = 1.0  # indefinite column -> breakdown
    b[:, 1] = d @ np.ones(8)
    jres = jsmm.cg_multi(jax_csr_from_dense(d), jnp.asarray(b), epsilon=1e-8)
    tres = smm.cg_multi(port_csr(jax_csr_from_dense(d)), torch.from_numpy(b), epsilon=1e-8)
    assert_columns_match(tres, jres, np.float64)
    assert tres.status.tolist() == [S.DIVERGED, S.SUCCESS]
    assert bool(torch.isfinite(tres.x[:, 0]).all())
    assert bool(torch.isfinite(tres.residual_norm[0]))
    np.testing.assert_allclose(tres.x[:, 1].numpy(), 1.0, atol=1e-7)


def test_stencil_preconditioned_matches_csr():
    """Grid-layout panels with a preconditioner: the apply crosses through
    the (n, m) layout; it matches the CSR route and the JAX stencil route."""
    jcsr = jax_gen.poisson_2d(24, dtype=np.float64)
    tcsr = port_csr(jcsr)
    st = smm.try_grid_stencil_from_csr(tcsr)
    assert st is not None
    b = np.array(jcsr @ jnp.asarray(_panel(576, 3, np.float64, seed=3)))
    pre = smm.get_preconditioner(tcsr, "jacobi")
    ref = smm.cg_multi(tcsr, torch.from_numpy(b), epsilon=1e-10, preconditioner=pre)
    got = smm.cg_multi(st, torch.from_numpy(b), epsilon=1e-10, preconditioner=pre)
    assert got.status.tolist() == [S.SUCCESS] * 3
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), atol=1e-8)
    jgot = jsmm.cg_multi(jax_stencil(jcsr), jnp.asarray(b), epsilon=1e-10,
                         preconditioner=jsmm.get_preconditioner(jcsr, "jacobi"))
    assert_columns_match(got, jgot, np.float64)


def test_solve_auto_format_stencil_panel_matches_jax():
    """solve(csr, B, auto_format=True) on a grid system goes through the
    grid stencil (leading-batch grid panels), as in the JAX package."""
    jcsr = jax_gen.poisson_2d(20, dtype=np.float64)
    b = _panel(400, 4, np.float64, seed=11)
    jres = jsmm.solve(jcsr, jnp.asarray(b), auto_format=True, epsilon=1e-9)
    tres = smm.solve(port_csr(jcsr), torch.from_numpy(b), auto_format=True, epsilon=1e-9)
    assert isinstance(smm.best_format(port_csr(jcsr)), smm.GridStencilMatrix)
    assert_columns_match(tres, jres, np.float64)


def test_interop_wsell_planes_solve_like_jax():
    """W-SELL planes carried over from the JAX package (the layout derived
    by rule) give the JAX W-SELL cg_multi's result."""
    from test_torch_wsell import wsell_fields

    jcsr = jax_gen.laplace_3d_jittered(10, symmetric=True, shift=0.25, dtype=np.float32)
    jws = jax_wsell_from_csr(jcsr, nway=4)
    tws = interop.wsell_from_numpy(wsell_fields(jws), "cpu")
    b = _panel(jcsr.shape[0], 5, np.float32, seed=12)
    jres = jsmm.cg_multi(jws, jnp.asarray(b), epsilon=1e-4)
    assert_columns_match(smm.cg_multi(tws, torch.from_numpy(b), epsilon=1e-4), jres,
                         np.float32)
