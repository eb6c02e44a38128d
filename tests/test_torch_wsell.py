"""The port's W-SELL and ELL layouts and products held against the JAX package.

* Layout: the port's ``wsell_from_csr`` gives the JAX package's planes
  (``vals``, ``meta``, ``base``, ``slab``) bit for bit, and the same
  ``slot_ratio``, nway auto-bail and refusal, for nway 1/2/4/8, window_f 1
  and 8, empty rows and slabs, a rectangular matrix and duplicate-column
  reads.  Each case runs with the native layout code (skipped only when
  g++ is missing) and with the NumPy colouring in both packages.
* Products: the plain versions of K7 (``wsell_spmv``), K8 (``wsell_spmm``)
  and K6 (``ell_spmv``), on the JAX planes carried over by ``interop``,
  against the Pallas kernels in interpret mode.  Both sum in the kernel's
  order, so only the XLA CPU backend's rounding can differ: f32 to a
  relative 1e-6 and f64 to 1e-12 of the largest |y|.

On the CPU the wrappers run the plain versions; the CUDA kernels are checked
by tests/test_torch_cuda_kernels.py on a card.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu.native as jax_native
from sparse_matrix_math_tpu.formats.csr import csr_from_dense as jax_csr_from_dense
from sparse_matrix_math_tpu.formats.ell import ell_from_csr as jax_ell_from_csr
from sparse_matrix_math_tpu.formats.wsell import _wsell_from_coo as jax_wsell_from_coo
from sparse_matrix_math_tpu.formats.wsell import wsell_from_csr as jax_wsell_from_csr
from sparse_matrix_math_tpu.ops.pallas_spmv import ell_spmv as jax_ell_spmv
from sparse_matrix_math_tpu.ops.pallas_wsell import wsell_spmm as jax_wsell_spmm
from sparse_matrix_math_tpu.ops.pallas_wsell import wsell_spmv as jax_wsell_spmv
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop, native
from sparse_matrix_math_tpu_torch.formats import ell_from_csr, try_wsell_from_csr, wsell_from_csr
from sparse_matrix_math_tpu_torch.formats.wsell import _wsell_from_coo
from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
from sparse_matrix_math_tpu_torch.ops.spmv import rmult
from torch_layout_code import jax_native_loaded, same_layout_code  # noqa: F401  (autouse)

REL = {np.float32: 1e-6, np.float64: 1e-12}


def port_csr(jcsr):
    return interop.csr_from_numpy(np.asarray(jcsr.indptr), np.asarray(jcsr.indices),
                                  np.asarray(jcsr.data), jcsr.shape, "cpu")


def wsell_fields(jws):
    """The JAX W-SELL matrix's fields, as interop takes them."""
    return dict(vals=np.asarray(jws.vals), meta=np.asarray(jws.meta),
                base=np.asarray(jws.base), slab=np.asarray(jws.slab), shape=jws.shape,
                nnz=jws.nnz, n_slabs=jws.n_slabs, x_rows=jws.x_rows,
                slot_ratio=jws.slot_ratio, window_f=jws.window_f, nway=jws.nway)


def assert_same_planes(tws, jws):
    assert (tws.shape, tws.nnz, tws.n_slabs, tws.x_rows, tws.window_f, tws.nway) == (
        jws.shape, jws.nnz, jws.n_slabs, jws.x_rows, jws.window_f, jws.nway)
    assert tws.slot_ratio == jws.slot_ratio
    for name in ("vals", "meta", "base", "slab"):
        np.testing.assert_array_equal(getattr(tws, name).numpy(), np.asarray(getattr(jws, name)),
                                      err_msg=name)
    ptr = tws.slab_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == tws.n_vregs and np.all(np.diff(ptr) >= 1)


def assert_close(got, want, dtype):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL[dtype] * scale)


@pytest.fixture(params=["native", "numpy"])
def layout_code(request, monkeypatch):
    """Both packages build with the native layout code, or both with NumPy."""
    if request.param == "native":
        if shutil.which("g++") is None:
            pytest.skip("the native layout code needs g++ to build smm_native.cpp")
        assert native.available() and jax_native_loaded(), (
            "g++ is present but a native layout library did not build or load")
    else:
        for name in ("wsell_plan", "wsell_color", "wsell_emit"):
            monkeypatch.setattr(native, name, lambda *a, **k: None)
            monkeypatch.setattr(jax_native, f"{name}_native", lambda *a, **k: None)
    return request.param


def _dense(kind):
    rng = np.random.default_rng(11)
    if kind == "empty_rows_and_slabs":
        d = np.zeros((2500, 2500), np.float32)
        d[3, 5], d[0, 0], d[4, 2400] = 2.5, 1.0, -1.5  # later slabs hold no entry
    elif kind == "rectangular":
        d = np.zeros((700, 1500), np.float32)
        m = rng.random((700, 1500)) < 0.01
        d[m] = rng.standard_normal(int(m.sum()))
    else:  # duplicate-column reads: every row reads column 7
        d = np.zeros((400, 400), np.float32)
        d[:, 7] = 1.5
        d[np.arange(400), np.arange(400)] = 2.0
    return jax_csr_from_dense(d)


BUILD_CASES = [
    ("poisson_2d(16)", lambda: jax_gen.poisson_2d(16), {}),
    ("poisson_2d(48)", lambda: jax_gen.poisson_2d(48), dict(nway=2)),
    ("jittered(14)", lambda: jax_gen.laplace_3d_jittered(14, symmetric=True, shift=0.25), {}),
    ("jittered(14)", lambda: jax_gen.laplace_3d_jittered(14, symmetric=True, shift=0.25),
     dict(nway=4)),
    ("jittered(14)", lambda: jax_gen.laplace_3d_jittered(14, symmetric=True, shift=0.25),
     dict(nway=8)),
    ("jittered(14)", lambda: jax_gen.laplace_3d_jittered(14), dict(window_f=8)),
    ("jittered(14)", lambda: jax_gen.laplace_3d_jittered(14), dict(window_f=8, nway=4)),
    ("random_spd(600)", lambda: jax_gen.random_spd_csr(600, density=0.012, seed=5),
     dict(max_slot_ratio=64.0, nway=4)),
    ("empty_rows_and_slabs", lambda: _dense("empty_rows_and_slabs"), dict(max_slot_ratio=1e9)),
    ("rectangular", lambda: _dense("rectangular"), {}),
    ("duplicate_columns", lambda: _dense("duplicate_columns"), {}),
]


@pytest.mark.parametrize("name,make,kw", BUILD_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, _, kw in BUILD_CASES])
def test_planes_match_jax(layout_code, name, make, kw):
    jcsr = make()
    assert_same_planes(wsell_from_csr(port_csr(jcsr), **kw), jax_wsell_from_csr(jcsr, **kw))


@pytest.mark.parametrize("window_f", [1, 8])
def test_strict_factor_layout_matches_jax(layout_code, window_f):
    """The layout of a strict triangle from COO arrays, as the Jacobi-sweep
    factors build it (nway 1)."""
    jcsr = jax_gen.laplace_3d_jittered(14, symmetric=True, shift=0.25)
    r = np.asarray(jcsr.row_ids, np.int64)
    c = np.asarray(jcsr.indices, np.int64)
    low = c < r
    v = np.asarray(jcsr.data)[low]
    args = (r[low], c[low], v, jcsr.shape, int(low.sum()))
    tws = _wsell_from_coo(*args, device="cpu", window_f=window_f)
    assert_same_planes(tws, jax_wsell_from_coo(*args, window_f=window_f))


def test_refusal_on_tile_sparse(layout_code):
    """About one entry per (slab, window) tile: both packages refuse."""
    rng = np.random.default_rng(13)
    d = np.zeros((4000, 4000), np.float32)
    d[rng.integers(0, 4000, 500), rng.integers(0, 4000, 500)] = 1.0
    jcsr = jax_csr_from_dense(d)
    with pytest.raises(ValueError):
        jax_wsell_from_csr(jcsr)
    with pytest.raises(ValueError, match="padding too high"):
        wsell_from_csr(port_csr(jcsr))
    assert try_wsell_from_csr(port_csr(jcsr)) is None


def test_nway_auto_bail(layout_code):
    """A fully dense slab-by-window tile gains nothing from nway 4: both
    packages come back with the shift-free nway 1 layout."""
    d = np.zeros((1024, 1024), np.float32)
    d[:, :128] = np.random.default_rng(0).standard_normal((1024, 128))
    jcsr = jax_csr_from_dense(d)
    tws = wsell_from_csr(port_csr(jcsr), max_slot_ratio=64.0, nway=4)
    assert tws.nway == 1
    assert_same_planes(tws, jax_wsell_from_csr(jcsr, max_slot_ratio=64.0, nway=4))


def test_try_wsell_defaults_to_nway4():
    jcsr = jax_gen.laplace_3d_jittered(16, symmetric=True, shift=0.25)
    w4 = try_wsell_from_csr(port_csr(jcsr))
    assert w4.nway == 4
    assert w4.slot_ratio < wsell_from_csr(port_csr(jcsr)).slot_ratio


def test_bad_arguments():
    csr = port_csr(jax_gen.poisson_2d(8))
    with pytest.raises(ValueError, match="window_f"):
        wsell_from_csr(csr, window_f=17)
    with pytest.raises(ValueError, match="nway"):
        wsell_from_csr(csr, nway=3)


# -- products -------------------------------------------------------------------

PRODUCT_CASES = [
    ("poisson_2d(48)", lambda d: jax_gen.poisson_2d(48, dtype=d), {}),
    ("jittered(14)-nway4",
     lambda d: jax_gen.laplace_3d_jittered(14, dtype=d, symmetric=True, shift=0.25),
     dict(nway=4)),
    ("jittered(14)-nway2-wf8", lambda d: jax_gen.laplace_3d_jittered(14, dtype=d),
     dict(nway=2, window_f=8)),
    ("random_spd(600)-nway8", lambda d: jax_gen.random_spd_csr(600, density=0.012, seed=5,
                                                               dtype=d),
     dict(max_slot_ratio=64.0, nway=8)),
]


def _jax_case(make, kw, dtype):
    jcsr = make(dtype)
    jws = jax_wsell_from_csr(jcsr, **kw)
    return jcsr, jws, interop.wsell_from_numpy(wsell_fields(jws), "cpu")


@pytest.mark.parametrize("name,make,kw", PRODUCT_CASES, ids=[c[0] for c in PRODUCT_CASES])
def test_spmv_plain_matches_jax_interpret(name, make, kw, dtype):
    jcsr, jws, tws = _jax_case(make, kw, dtype)
    x = np.random.default_rng(1).standard_normal(jws.shape[1]).astype(dtype)
    ref = jax_wsell_spmv(jws, jnp.asarray(x), interpret=True)
    before = dict(W.launches)
    y = W.wsell_spmv(tws, torch.from_numpy(x))
    assert y.shape == (jws.shape[0],) and y.dtype == tws.dtype
    assert_close(y.numpy(), ref, dtype)
    assert W.launches == before  # the plain version counts no launch
    assert_close(rmult(tws, torch.from_numpy(x)).numpy(), ref, dtype)


@pytest.mark.parametrize("k", [1, 3, 8, 9])
@pytest.mark.parametrize("name,make,kw", PRODUCT_CASES[:2], ids=[c[0] for c in PRODUCT_CASES[:2]])
def test_spmm_plain_matches_jax_interpret(name, make, kw, k, dtype):
    jcsr, jws, tws = _jax_case(make, kw, dtype)
    xs = np.random.default_rng(2).standard_normal((jws.shape[1], k)).astype(dtype)
    ref = jax_wsell_spmm(jws, jnp.asarray(xs), interpret=True)
    ys = W.wsell_spmm(tws, torch.from_numpy(xs))
    assert ys.shape == (jws.shape[0], k)
    assert_close(ys.numpy(), ref, dtype)
    # each column of K8 is K7's product of that column, bit for bit
    for j in range(k):
        assert torch.equal(ys[:, j], W.wsell_spmv(tws, torch.from_numpy(xs[:, j].copy())))


def test_spmv_empty_slabs_and_rectangular():
    for kind, kw in (("empty_rows_and_slabs", dict(max_slot_ratio=1e9)), ("rectangular", {})):
        jcsr = _dense(kind)
        jws = jax_wsell_from_csr(jcsr, **kw)
        tws = interop.wsell_from_numpy(wsell_fields(jws), "cpu")
        x = np.random.default_rng(0).standard_normal(jws.shape[1]).astype(np.float32)
        ref = jax_wsell_spmv(jws, jnp.asarray(x), interpret=True)
        assert_close(W.wsell_spmv(tws, torch.from_numpy(x)).numpy(), ref, np.float32)


def test_wrapper_checks():
    tws = wsell_from_csr(port_csr(jax_gen.poisson_2d(16)))
    with pytest.raises(TypeError):
        W.wsell_spmv(tws, torch.ones(256, dtype=torch.float32))
    with pytest.raises(ValueError):
        W.wsell_spmv(tws, torch.ones(255, dtype=torch.float64))
    with pytest.raises(ValueError):
        W.wsell_spmm(tws, torch.ones(256, dtype=torch.float64))
    # rmult promotes, as the JAX result_type does
    y = rmult(tws, torch.ones(256, dtype=torch.float32))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(tws.to_dense().numpy(),
                               np.asarray(jax_gen.poisson_2d(16).to_dense()), rtol=0, atol=0)


# -- ELL ------------------------------------------------------------------------

ELL_CASES = [("poisson_2d(20)", lambda d: jax_gen.poisson_2d(20, dtype=d)),
             ("jittered(14)", lambda d: jax_gen.laplace_3d_jittered(14, dtype=d, symmetric=True,
                                                                     shift=0.25)),
             ("rectangular", lambda d: jax_csr_from_dense(
                 np.asarray(_dense("rectangular").to_dense()).astype(d)))]


@pytest.mark.parametrize("name,make", ELL_CASES, ids=[c[0] for c in ELL_CASES])
def test_ell_matches_jax(name, make, dtype):
    jcsr = make(dtype)
    jell = jax_ell_from_csr(jcsr)
    tell = ell_from_csr(port_csr(jcsr))
    np.testing.assert_array_equal(tell.vals.numpy(), np.asarray(jell.vals))
    np.testing.assert_array_equal(tell.cols.numpy(), np.asarray(jell.cols))
    assert tell.cols.dtype == torch.int32 and tell.fill_ratio == jell.fill_ratio
    x = np.random.default_rng(3).standard_normal(jcsr.shape[1]).astype(dtype)
    ref = jax_ell_spmv(jell, jnp.asarray(x), interpret=True)
    carried = interop.ell_from_numpy(np.asarray(jell.vals), np.asarray(jell.cols), jell.shape,
                                     jell.nnz, "cpu")
    before = dict(E.launches)
    assert_close(E.ell_spmv(carried, torch.from_numpy(x)).numpy(), ref, dtype)
    assert E.launches == before
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal((jcsr.shape[1], 2))
                          .astype(dtype))
    ys = rmult(tell, xs)  # one K6 product per column
    for j in range(2):
        assert torch.equal(ys[:, j], E.ell_spmv(tell, xs[:, j].contiguous()))
    np.testing.assert_array_equal(tell.to_dense().numpy(), np.asarray(jcsr.to_dense()))
