"""The port's formats, generators, loader, routing and interop
(sparse_matrix_math_tpu_torch) held against the JAX package on the CPU.

Construction is exact on both sides (the same NumPy arithmetic), so arrays
are compared for equality; products are compared to 1e-12 (f64) and 1e-5
(f32) absolute, the summation order of the CSR product being free.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats import auto_route_for_solve as jax_auto_route
from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr as jax_try_dia
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.dia import dia_from_csr

GENERATORS = [
    ("laplace_1d", (23,)),
    ("poisson_2d", (6,)),
    ("poisson_2d", (5, 7)),
    ("poisson_3d", (4,)),
    ("poisson_3d_27pt", (3, 4, 5)),
    ("convection_diffusion_2d", (6,)),
]
GEN_IDS = [f"{n}{a}" for n, a in GENERATORS]
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _port_csr(jcsr):
    return interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")


@pytest.mark.parametrize("name,args", GENERATORS, ids=GEN_IDS)
def test_generators_match_jax(name, args, dtype):
    jcsr = getattr(jax_gen, name)(*args, dtype=dtype)
    tcsr = getattr(smm, name)(*args, dtype=TORCH_DTYPE[dtype], device="cpu")
    assert tcsr.shape == jcsr.shape and tcsr.nnz == jcsr.nnz
    assert tcsr.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_array_equal(tcsr.indptr.numpy(), np.asarray(jcsr.indptr))
    np.testing.assert_array_equal(tcsr.indices.numpy(), np.asarray(jcsr.indices))
    np.testing.assert_array_equal(tcsr.row_ids.numpy(), np.asarray(jcsr.row_ids))
    np.testing.assert_array_equal(tcsr.data.numpy(), np.asarray(jcsr.data))


@pytest.mark.parametrize("name,args", GENERATORS, ids=GEN_IDS)
def test_dia_conversion_matches_jax(name, args):
    jcsr = getattr(jax_gen, name)(*args)
    jdia = jsmm.dia_from_csr(jcsr)
    tdia = dia_from_csr(_port_csr(jcsr))
    assert tdia.offsets == jdia.offsets and tdia.shape == jdia.shape
    assert tdia.nnz == jdia.nnz
    np.testing.assert_array_equal(tdia.diags.numpy(), np.asarray(jdia.diags))
    np.testing.assert_array_equal(tdia.to_dense().numpy(), np.asarray(jcsr.to_dense()))


def test_try_dia_refuses_like_jax():
    rng = np.random.default_rng(0)
    n = 200
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size)
    jcsr = jsmm.csr_from_coo(jsmm.coo_from_arrays(rows, cols, vals, (n, n)))
    tcsr = smm.csr_from_coo(smm.coo_from_arrays(rows, cols, vals, (n, n), device="cpu"))
    assert jax_try_dia(jcsr) is None and smm.try_dia_from_csr(tcsr) is None
    with pytest.raises(ValueError):
        dia_from_csr(tcsr, max_diags=8)
    # a few full diagonals convert
    jp = jax_gen.poisson_2d(9)
    assert smm.try_dia_from_csr(_port_csr(jp)).offsets == jax_try_dia(jp).offsets


def test_coo_build_sums_duplicates_like_jax():
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 7, 60)
    vals = rng.standard_normal(60)
    jcsr = jsmm.csr_from_coo(jsmm.coo_from_arrays(rows, cols, vals, (9, 7)))
    coo = smm.coo_from_arrays(rows, cols, vals, (9, 7), device="cpu")
    tcsr = smm.csr_from_coo(coo)
    np.testing.assert_array_equal(tcsr.indptr.numpy(), np.asarray(jcsr.indptr))
    np.testing.assert_array_equal(tcsr.indices.numpy(), np.asarray(jcsr.indices))
    np.testing.assert_allclose(tcsr.data.numpy(), np.asarray(jcsr.data), rtol=0, atol=1e-15)
    np.testing.assert_array_equal(tcsr.to_dense().numpy() != 0, np.asarray(jcsr.to_dense()) != 0)
    # unsorted raw arrays sort on request
    order = rng.permutation(tcsr.nnz)
    raw = smm.COOArrays(rows=tcsr.row_ids[order], cols=tcsr.indices[order],
                        vals=tcsr.data[order], shape=(9, 7))
    again = smm.csr_from_coo(raw, needs_sort=True)
    assert torch.equal(again.indices, tcsr.indices) and torch.equal(again.data, tcsr.data)
    with pytest.raises(ValueError):
        smm.coo_from_arrays([0, 9], [0, 0], [1.0, 1.0], (9, 7), device="cpu")


def test_csr_products_match_jax(dtype):
    jcsr = jax_gen.convection_diffusion_2d(7, dtype=dtype)
    tcsr = _port_csr(jcsr)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(jcsr.shape[1]).astype(dtype)
    lhs = rng.standard_normal(jcsr.shape[0]).astype(dtype)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    jx, tx, tl = jnp.asarray(x), torch.from_numpy(x), torch.from_numpy(lhs)
    np.testing.assert_allclose((tcsr @ tx).numpy(), np.asarray(jcsr @ jx), rtol=0, atol=tol)
    np.testing.assert_allclose(tcsr.rmult_add(tl, tx).numpy(),
                               np.asarray(jcsr.rmult_add(jnp.asarray(lhs), jx)), rtol=0, atol=tol)
    np.testing.assert_allclose(tcsr.rmult_sub(tl, tx).numpy(),
                               np.asarray(jcsr.rmult_sub(jnp.asarray(lhs), jx)), rtol=0, atol=tol)
    xs = np.stack([x, -x], axis=1)
    np.testing.assert_allclose((tcsr @ torch.from_numpy(xs)).numpy(),
                               np.asarray(jcsr @ jnp.asarray(xs)), rtol=0, atol=tol)
    np.testing.assert_allclose(smm.rmult(tcsr.to_dense(), tx).numpy(),
                               np.asarray(jcsr @ jx), rtol=0, atol=tol)
    with pytest.raises(TypeError):
        smm.rmult("not a matrix", tx)


class TestAutoRoute:
    """Routing of a large CSR matrix to DIA at the solver front door; on
    the CPU it is forced on with SMM_FORCE_AUTOROUTE, as in the JAX tests."""

    def test_small_matrix_untouched(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        jcsr = jax_gen.poisson_2d(64)  # 4096 rows but 20224 nnz < 100k
        tcsr = _port_csr(jcsr)
        assert jax_auto_route(jcsr) is jcsr
        assert smm.auto_route_for_solve(tcsr) is tcsr

    def test_routes_to_dia_and_caches(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        jcsr = jax_gen.poisson_2d(160)  # 25600 rows, ~127k nnz
        tcsr = _port_csr(jcsr)
        jrouted = jax_auto_route(jcsr)
        routed = smm.auto_route_for_solve(tcsr)
        assert isinstance(routed, smm.DIAMatrix)
        assert routed.offsets == jrouted.offsets
        np.testing.assert_array_equal(routed.diags.numpy(), np.asarray(jrouted.diags))
        assert smm.auto_route_for_solve(tcsr) is routed  # cached

    def test_inactive_on_cpu_and_opt_out(self, monkeypatch):
        tcsr = smm.poisson_2d(160, device="cpu")
        monkeypatch.delenv("SMM_FORCE_AUTOROUTE", raising=False)
        assert smm.auto_route_for_solve(tcsr) is tcsr  # CPU tensors: no route
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        monkeypatch.setenv("SMM_NO_AUTOROUTE", "1")
        assert smm.auto_route_for_solve(tcsr) is tcsr

    def test_unroutable_pattern_warns(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        rng = np.random.default_rng(0)
        n, per_row = 32768, 4
        key = np.unique(np.repeat(np.arange(n), per_row).astype(np.int64) * n
                        + rng.integers(0, n, n * per_row))
        rows, cols = key // n, key % n
        tcsr = smm.csr_from_coo(smm.coo_from_arrays(
            rows, cols, rng.standard_normal(rows.size), (n, n), device="cpu"))
        assert tcsr.nnz >= 100_000
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert smm.auto_route_for_solve(tcsr) is tcsr
        assert any(issubclass(x.category, smm.PerformanceWarning) for x in w)

    def test_solver_entry_routes_and_solves(self, monkeypatch):
        monkeypatch.setenv("SMM_FORCE_AUTOROUTE", "1")
        tcsr = smm.poisson_2d(160, device="cpu")
        b = tcsr @ torch.ones(160 * 160, dtype=torch.float64)
        res = smm.cg(tcsr, b, epsilon=1e-8)
        kind, routed = tcsr._auto_routed  # the cached (kind, operator) route
        assert kind == "dia" and isinstance(routed, smm.DIAMatrix)
        assert res.success
        np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-6)


_SYM_MTX = """%%MatrixMarket matrix coordinate real symmetric
% a comment
4 4 6
1 1 4.0
2 1 -1.0
2 2 4.0
3 3 4.0
4 3 -1.5
4 4 4.0
"""

_GEN_MTX = """%%MatrixMarket matrix coordinate real general
3 4 5
1 1 2.0
1 4 1.0
2 2 3.0
3 1 -1.0
3 3 5.0
"""


@pytest.mark.parametrize("text,general", [(_SYM_MTX, False), (_GEN_MTX, True)],
                         ids=["symmetric", "general"])
def test_load_matrix_csr_matches_jax(tmp_path, text, general, dtype):
    path = tmp_path / "m.mtx"
    path.write_text(text)
    jcsr = jsmm.load_matrix_csr(str(path), dtype=dtype, allow_general=general)
    tcsr = smm.load_matrix_csr(path, dtype=TORCH_DTYPE[dtype], allow_general=general,
                               device="cpu")
    assert tcsr.shape == jcsr.shape and tcsr.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_array_equal(tcsr.indptr.numpy(), np.asarray(jcsr.indptr))
    np.testing.assert_array_equal(tcsr.indices.numpy(), np.asarray(jcsr.indices))
    np.testing.assert_array_equal(tcsr.data.numpy(), np.asarray(jcsr.data))


def test_load_errors(tmp_path):
    S = smm.MatrixLoadStatus
    cases = [
        ("m.txt", _SYM_MTX, {}, S.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT),
        ("m.mtx", _GEN_MTX, {}, S.UNSUPPORTED_FORMAT),
        ("m.mtx", "%%MatrixMarket matrix array real general\n1 1\n1.0\n", {},
         S.UNSUPPORTED_FORMAT),
        ("m.mtx", "not a banner\n", {}, S.PARSE_ERROR),
        ("m.mtx", _SYM_MTX.replace("4 4 6", "4 4 7"), {}, S.PARSE_ERROR),
        ("m.mtx", _SYM_MTX.replace("4 3 -1.5", "5 3 -1.5"), {}, S.PARSE_ERROR),
    ]
    for name, text, kw, status in cases:
        path = tmp_path / name
        path.write_text(text)
        with pytest.raises(smm.MatrixMarketError) as err:
            smm.load_matrix_csr(path, device="cpu", **kw)
        assert err.value.status == status, (name, text)
    with pytest.raises(smm.MatrixMarketError) as err:
        smm.load_matrix_csr(tmp_path / "missing.mtx", device="cpu")
    assert err.value.status == S.FAILED_TO_OPEN_FILE


def test_interop_converters():
    jcsr = jax_gen.convection_diffusion_2d(5)
    tcsr = _port_csr(jcsr)
    for field in ("indptr", "indices", "row_ids", "data"):
        np.testing.assert_array_equal(getattr(tcsr, field).numpy(),
                                      np.asarray(getattr(jcsr, field)))
    assert tcsr.indices.dtype == tcsr.indptr.dtype == torch.int64
    jdia = jsmm.dia_from_csr(jcsr)
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    assert tdia.offsets == jdia.offsets and tdia.nnz == jdia.nnz
    np.testing.assert_array_equal(tdia.diags.numpy(), np.asarray(jdia.diags))
    jjac = jsmm.JacobiPreconditioner.from_matrix(jcsr)
    tjac = interop.jacobi_from_numpy(np.asarray(jjac.inv_diag), "cpu")
    np.testing.assert_array_equal(tjac.inv_diag.numpy(),
                                  smm.JacobiPreconditioner.from_matrix(tcsr).inv_diag.numpy())
    r = np.random.default_rng(0).standard_normal(jcsr.shape[0])
    np.testing.assert_array_equal(tjac.apply(torch.from_numpy(r)).numpy(),
                                  np.asarray(jjac.apply(jnp.asarray(r))))
    with pytest.raises(ValueError):
        interop.csr_from_numpy(np.asarray(jcsr.indptr)[:-1], np.asarray(jcsr.indices),
                               np.asarray(jcsr.data), jcsr.shape, "cpu")
    with pytest.raises(ValueError):
        interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets[:-1], jdia.shape,
                               jdia.nnz, "cpu")
