"""The port's R-SELL routed layout and its routing pass held against the JAX
package.

* Layout: ``routed_from_csr`` gives the JAX package's planes bit for bit:
  ``vals``, ``meta``, ``base``, ``x_rows`` of every routing pass, the final
  W-SELL planes, and ``slot_ratio``, on uniform-random, rectangular and
  power-law-column patterns and every ``window_f`` of the JAX test.  Each case
  runs with the native routed-chain routines in both packages (skipped only
  when g++ is missing) and with the NumPy expressions in both.
* Routing pass: ``stream_gather_plain`` (what the wrapper runs on CPU
  tensors) equals the JAX Pallas kernel in interpret mode, in its resident
  and its ``force_hbm`` variant, exactly: one product per slot, no sum.
* Product: ``rmult`` of a ``RoutedMatrix`` against the JAX package's, for a
  vector and a panel.  The routing is exact and the final W-SELL pass sums in
  the kernel's order, so only the XLA CPU backend's rounding can differ: f32
  to a relative 1e-6 and f64 to 1e-12 of the largest |y|.
* Fold: ``rmult`` reads the chain folded into the final pass's layout
  (``RoutedMatrix.sell``), and equals the chain itself
  (``ops/spmv.py:routed_chain_rmult``, K11's and K7's plain versions) bit
  for bit, vector and panel; the fold's column words are columns of x with
  the final layout's ``CONT`` bits; every constructor carries the same fold.

On the CPU the wrapper runs the plain version; the CUDA kernel is checked by
tests/test_torch_cuda_kernels.py on a card.
"""

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu.formats.rsell as jax_rsell
import sparse_matrix_math_tpu.native as jax_native
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_coo as jax_csr_from_coo
from sparse_matrix_math_tpu.formats.triplet import coo_from_arrays as jax_coo_from_arrays
from sparse_matrix_math_tpu.ops.pallas_rsell import stream_gather as jax_stream_gather
from sparse_matrix_math_tpu.ops.spmv import rmult as jax_rmult
from sparse_matrix_math_tpu.solvers.cg import cg as jax_cg
from sparse_matrix_math_tpu.utils.generate import uniform_random_csr as jax_uniform_random
from sparse_matrix_math_tpu_torch import interop, native
from sparse_matrix_math_tpu_torch.formats.rsell import (
    RoutedMatrix,
    _plan_digits,
    fold_chain,
    routed_from_csr,
    try_routed_from_csr,
)
from sparse_matrix_math_tpu_torch.formats.sell import CONT
from sparse_matrix_math_tpu_torch.ops import stream_gather as S
from sparse_matrix_math_tpu_torch.ops.spmv import routed_chain_rmult
from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
from test_torch_wsell import port_csr, wsell_fields
from torch_layout_code import jax_native_loaded, same_layout_code  # noqa: F401  (autouse)

REL = {np.float32: 1e-6, np.float64: 1e-12}
STREAM_NATIVES = ("stream_pack_cf", "sort_perm", "stream_group", "stream_emit", "stream_level")


@pytest.fixture(params=["native", "numpy"])
def chain_code(request, monkeypatch):
    """Both packages build the routing passes with the native routines, or
    both with the NumPy expressions (rsell.py:160-193, 225-273, 419-438).  The
    final W-SELL layout keeps the native colouring either way."""
    if shutil.which("g++") is None:
        pytest.skip("the native layout code needs g++ to build smm_native.cpp")
    assert native.available() and jax_native_loaded(), (
        "g++ is present but a native layout library did not build or load")
    if request.param == "numpy":
        for name in STREAM_NATIVES:
            monkeypatch.setattr(native, name, lambda *a, **k: None)
            monkeypatch.setattr(jax_native, f"{name}_native", lambda *a, **k: None)
        # the JAX module binds these two names when it is imported
        monkeypatch.setattr(jax_rsell, "sort_perm_native", lambda *a, **k: None)
        monkeypatch.setattr(jax_rsell, "stream_level_native", lambda *a, **k: None)
    return request.param


def _from_entries(r, c, v, shape):
    return jax_csr_from_coo(jax_coo_from_arrays(r, c, v, shape), needs_sort=True)


def _rectangular():
    rng = np.random.default_rng(11)
    n_rows, n_cols, nnz = 3_000, 7_000, 12_000
    r, c = rng.integers(0, n_rows, nnz), rng.integers(0, n_cols, nnz)
    _, idx = np.unique(r * n_cols + c, return_index=True)
    v = rng.standard_normal(idx.shape[0]).astype(np.float32)
    return _from_entries(r[idx], c[idx], v, (n_rows, n_cols))


def _power_law():
    # heavy column reuse: duplicated sources share a claim
    rng = np.random.default_rng(13)
    n, nnz = 6_000, 40_000
    r = rng.integers(0, n, nnz)
    c = (n * rng.random(nnz) ** 3).astype(np.int64)
    _, idx = np.unique(r * n + c, return_index=True)
    v = rng.standard_normal(idx.shape[0]).astype(np.float32)
    return _from_entries(r[idx], c[idx], v, (n, n))


def _spd(n=4_000, per=3):
    """The JAX solver-integration system: symmetric, diagonal 4, random
    off-diagonal entries of size ~0.1."""
    rng = np.random.default_rng(21)
    r = np.repeat(np.arange(n), per)
    c = rng.integers(0, n, n * per)
    _, idx = np.unique(np.minimum(r, c) * n + np.maximum(r, c), return_index=True)
    ru, cu = r[idx], c[idx]
    off = ru != cu
    ru, cu = ru[off], cu[off]
    v = rng.standard_normal(ru.shape[0]).astype(np.float32) * 0.1
    rr = np.concatenate([ru, cu, np.arange(n)])
    cc = np.concatenate([cu, ru, np.arange(n)])
    vv = np.concatenate([v, v, np.full(n, 4.0, np.float32)])
    return _from_entries(rr, cc, vv, (n, n))


BUILD_CASES = [
    ("uniform20k", lambda: jax_uniform_random(20_000, per_row=5, seed=7, dtype=np.float32), {}),
    ("uniform20k_dense", lambda: jax_uniform_random(20_000, per_row=17, dtype=np.float32), {}),
    ("uniform5k_f64", lambda: jax_uniform_random(5_000, per_row=4, seed=3, dtype=np.float64), {}),
    ("rectangular", _rectangular, {}),
    ("power_law", _power_law, {}),
    ("uniform8k", lambda: jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32),
     dict(window_f=4)),
    ("uniform8k", lambda: jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32),
     dict(window_f=8)),
    ("uniform8k", lambda: jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32),
     dict(window_f=16)),
    ("uniform8k", lambda: jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32),
     dict(window_f=4, leaf_slabs=1, _digits=(2, 2, 2))),
    ("uniform8k", lambda: jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32),
     dict(final_nway=1)),
]


def assert_same_chain(tra, jra):
    assert isinstance(tra, RoutedMatrix)
    assert (tra.shape, tra.nnz, len(tra.passes)) == (jra.shape, jra.nnz, len(jra.passes))
    assert tra.slot_ratio == jra.slot_ratio
    for i, (tp, jp) in enumerate(zip(tra.passes, jra.passes)):
        assert (tp.x_rows, tp.window_f, tp.n_vregs, tp.out_len) == (
            jp.x_rows, jp.window_f, jp.n_vregs, jp.out_len)
        for name in ("vals", "meta", "base"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          err_msg=f"pass {i} {name}")
        assert tp.vals.dtype == tra.dtype and tp.meta.dtype == torch.int32
    tf, jf = tra.final, jra.final
    assert (tf.shape, tf.nnz, tf.n_slabs, tf.x_rows, tf.window_f, tf.nway, tf.slot_ratio) == (
        jf.shape, jf.nnz, jf.n_slabs, jf.x_rows, jf.window_f, jf.nway, jf.slot_ratio)
    for name in ("vals", "meta", "base", "slab"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)),
                                      err_msg=f"final {name}")
    # the last stream is the final layout's x table
    assert tf.shape[1] == (tra.passes[-1].out_len if tra.passes else tra.shape[1])


@pytest.mark.parametrize("name,make,kw", BUILD_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for n, _, kw in BUILD_CASES])
def test_planes_match_jax(chain_code, name, make, kw):
    jcsr = make()
    assert_same_chain(routed_from_csr(port_csr(jcsr), max_slot_ratio=999.0, **kw),
                      jax_rsell.routed_from_csr(jcsr, max_slot_ratio=999.0, **kw))


def test_multi_pass_chain_was_built():
    """The forced three-digit plan gives three routing passes, so the chain
    cases above do run pass after pass."""
    jcsr = jax_uniform_random(8_000, per_row=5, seed=9, dtype=np.float32)
    tra = routed_from_csr(port_csr(jcsr), max_slot_ratio=999.0, window_f=4, leaf_slabs=1,
                          _digits=(2, 2, 2))
    assert len(tra.passes) == 3
    assert tra.passes[1].x_rows * 128 >= tra.passes[0].out_len


def test_over_cap_is_none_or_raises(chain_code):
    jcsr = jax_uniform_random(3_000, per_row=2, seed=1, dtype=np.float32)
    assert jax_rsell.try_routed_from_csr(jcsr, max_slot_ratio=1.0) is None
    assert try_routed_from_csr(port_csr(jcsr), max_slot_ratio=1.0) is None
    with pytest.raises(ValueError, match="routing pads too high"):
        routed_from_csr(port_csr(jcsr), max_slot_ratio=1.0)
    assert smm.try_routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0) is not None


def test_slot_ratio_counts_every_stream():
    tra = routed_from_csr(port_csr(jax_uniform_random(20_000, per_row=5, seed=7,
                                                      dtype=np.float32)), max_slot_ratio=99.0)
    total = sum(p.out_len for p in tra.passes) + tra.final.n_vregs * 1024
    assert abs(tra.slot_ratio - total / tra.nnz) < 1e-9


@pytest.mark.parametrize("args", [(2_000_000, 11_999_990, 42, 16), (8_000, 48_000, 8, 4),
                                  (7_000, 12_000, 1, 16), (100, 100, 3, 1)])
def test_plan_digits_match_jax(args):
    assert _plan_digits(*args) == jax_rsell._plan_digits(*args)


# -- the routing pass (K11's plain version) ------------------------------------------


def _chain_pair(dtype, n=6_000, per_row=4, **kw):
    jcsr = jax_uniform_random(n, per_row=per_row, seed=5, dtype=dtype)
    jra = jax_rsell.routed_from_csr(jcsr, max_slot_ratio=99.0, **kw)
    fields = [dict(vals=np.asarray(p.vals), meta=np.asarray(p.meta), base=np.asarray(p.base),
                   x_rows=p.x_rows, window_f=p.window_f) for p in jra.passes]
    tra = interop.routed_from_numpy(fields, wsell_fields(jra.final), jra.shape, jra.nnz,
                                    jra.slot_ratio, "cpu")
    return jcsr, jra, tra


@pytest.mark.parametrize("force_hbm", [False, True], ids=["resident", "force_hbm"])
@pytest.mark.parametrize("kw", [{}, dict(window_f=4, leaf_slabs=1, _digits=(2, 3))],
                         ids=["default", "two_passes_wf4"])
def test_stream_gather_plain_equals_jax_interpret(kw, force_hbm, dtype):
    _, jra, tra = _chain_pair(dtype, **kw)
    x = np.random.default_rng(11).standard_normal(jra.shape[1]).astype(dtype)
    jt, tt = jnp.asarray(x), torch.from_numpy(x)
    before = dict(S.launches)
    for jp, tp in zip(jra.passes, tra.passes):
        jt = jax_stream_gather(jp.base, jp.meta, jp.vals, jt, x_rows=jp.x_rows,
                               window_f=jp.window_f, interpret=True, force_hbm=force_hbm)
        tt = smm.stream_gather(tp.base, tp.meta, tp.vals, tt, x_rows=tp.x_rows,
                               window_f=tp.window_f)
        assert tt.shape == (tp.out_len,) and tt.dtype == tra.dtype
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert S.launches == before  # the plain version counts no launch


def test_stream_gather_reads_zero_past_the_table():
    """A table shorter than x_rows * 128 reads as if padded with zeros."""
    _, _, tra = _chain_pair(np.float32)
    p = tra.passes[0]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(tra.shape[1])
                         .astype(np.float32))
    padded = torch.zeros(p.x_rows * 128)
    padded[:x.shape[0]] = x
    kw = dict(x_rows=p.x_rows, window_f=p.window_f)
    assert torch.equal(S.stream_gather(p.base, p.meta, p.vals, x, **kw),
                       S.stream_gather(p.base, p.meta, p.vals, padded, **kw))
    # every real slot carries one of x's values, every padding slot 0
    out = S.stream_gather_plain(p.base, p.meta, p.vals, x, **kw)
    assert bool(torch.isin(out[p.vals.reshape(-1) == 1], x).all())
    assert bool((out[p.vals.reshape(-1) == 0] == 0).all())
    assert int((p.vals == 1).sum()) == tra.nnz


def test_stream_gather_wrapper_checks():
    _, _, tra = _chain_pair(np.float32)
    p = tra.passes[0]
    x = torch.ones(tra.shape[1])
    kw = dict(x_rows=p.x_rows, window_f=p.window_f)
    with pytest.raises(TypeError, match="float32 or both float64"):
        S.stream_gather(p.base, p.meta, p.vals, x.double(), **kw)
    with pytest.raises(TypeError, match="int32"):
        S.stream_gather(p.base.long(), p.meta, p.vals, x, **kw)
    with pytest.raises(ValueError, match="does not fit"):
        S.stream_gather(p.base, p.meta, p.vals, torch.ones(p.x_rows * 128 + 1), **kw)
    with pytest.raises(ValueError, match="planes of shapes"):
        S.stream_gather(p.base[:-1], p.meta, p.vals, x, **kw)
    with pytest.raises(ValueError, match="window_f"):
        S.stream_gather(p.base, p.meta, p.vals, x, x_rows=p.x_rows, window_f=17)
    with pytest.raises(ValueError, match="contiguous"):
        S.stream_gather(p.base, p.meta, p.vals, torch.ones(2 * tra.shape[1])[::2], **kw)


# -- the routed product ----------------------------------------------------------------


def assert_close(got, want, dtype):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=REL[dtype] * scale)


@pytest.mark.parametrize("kw", [{}, dict(window_f=4, leaf_slabs=1, _digits=(2, 3))],
                         ids=["default", "two_passes_wf4"])
def test_rmult_matches_jax(kw, dtype):
    jcsr, jra, tra = _chain_pair(dtype, **kw)
    x = np.random.default_rng(1).standard_normal(jra.shape[1]).astype(dtype)
    ref = jax_rmult(jra, jnp.asarray(x))
    before = (dict(S.launches), dict(W.launches))
    y = tra @ torch.from_numpy(x)
    assert y.shape == (jra.shape[0],) and y.dtype == tra.dtype
    assert_close(y.numpy(), ref, dtype)
    assert (S.launches, W.launches) == before
    # and against the CSR product it stands for
    assert_close(y.numpy(), jax_rmult(jcsr, jnp.asarray(x)), dtype)
    assert torch.equal(smm.rmult(tra, torch.from_numpy(x)), y)


def test_rmult_panel_matches_jax(dtype):
    _, jra, tra = _chain_pair(dtype, n=4_000)
    xs = np.random.default_rng(3).standard_normal((4_000, 3)).astype(dtype)
    ys = smm.rmult(tra, torch.from_numpy(xs))
    assert ys.shape == (4_000, 3)
    assert_close(ys.numpy(), jax_rmult(jra, jnp.asarray(xs)), dtype)
    for j in range(3):  # a panel is its columns' chains
        assert torch.equal(ys[:, j], tra @ torch.from_numpy(xs[:, j].copy()))


def test_rmult_rectangular_and_power_law():
    for make in (_rectangular, _power_law):
        jcsr = make()
        tra = routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0)
        x = np.random.default_rng(4).standard_normal(jcsr.shape[1]).astype(np.float32)
        y = tra @ torch.from_numpy(x)
        assert y.shape == (jcsr.shape[0],)
        assert_close(y.numpy(), jax_rmult(jcsr, jnp.asarray(x)), np.float32)


def test_rmult_promotes_and_astype():
    _, _, tra = _chain_pair(np.float32, n=3_000)
    x64 = torch.from_numpy(np.random.default_rng(5).standard_normal(3_000))
    y = tra @ x64
    assert y.dtype == torch.float64
    t64 = tra.astype(torch.float64)
    assert t64.dtype == torch.float64 and all(p.vals.dtype == torch.float64 for p in t64.passes)
    assert torch.equal(y, t64 @ x64)
    np.testing.assert_allclose(y.numpy(), (tra @ x64.float()).double().numpy(), atol=1e-5)


def test_to_dense_small():
    jcsr = jax_uniform_random(300, per_row=3, seed=2, dtype=np.float64)
    tra = routed_from_csr(port_csr(jcsr), max_slot_ratio=999.0)
    np.testing.assert_allclose(tra.to_dense().numpy(), np.asarray(jcsr.to_dense()), atol=1e-14)


def test_interop_carries_the_jax_chain():
    jcsr, jra, tra = _chain_pair(np.float32)
    assert_same_chain(tra, jra)
    assert_same_chain(routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0), jra)


def test_cg_over_routed_matches_jax():
    """CG through the routed operator in both packages (f32, eps 1e-5):
    same status, iterations within 2 (the dots sum in another order), x to
    1e-4 of max|x|."""
    jcsr = _spd()
    jra = jax_rsell.routed_from_csr(jcsr, max_slot_ratio=99.0)
    tra = routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0)
    x_true = np.random.default_rng(21).standard_normal(jcsr.shape[0]).astype(np.float32)
    b = np.asarray(jcsr @ jnp.asarray(x_true))
    jres = jax_cg(jra, jnp.asarray(b), epsilon=1e-5, max_iterations=500)
    tres = smm.cg(tra, torch.tensor(b), epsilon=1e-5, max_iterations=500)
    assert tres.status == int(jres.status) == 0
    assert abs(tres.iterations - int(jres.iterations)) <= 2
    jx = np.asarray(jres.x)
    assert np.abs(tres.x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
    assert np.abs(tres.x.numpy() - x_true).max() < 1e-3


@pytest.mark.parametrize("method", ["bicgstab", "cgs"])
def test_nonsymmetric_solvers_over_routed(method):
    """The front door's case at a small size: the uniform-random system is
    nonsymmetric and strictly diagonally dominant."""
    tcsr = smm.uniform_random_csr(5_000, per_row=5, dtype=torch.float64, device="cpu")
    tra = routed_from_csr(tcsr, max_slot_ratio=99.0)
    x_true = torch.from_numpy(np.random.default_rng(0).standard_normal(5_000))
    b = tcsr @ x_true
    res = smm.solve(tra, b, method=method, epsilon=1e-9)
    assert res.status == 0
    assert float(torch.linalg.norm(b - tcsr @ res.x)) <= 1e-9
    assert float((res.x - x_true).abs().max()) < 1e-8


# -- the folded product ------------------------------------------------------------------


def bits_equal(a, b):
    """Bit for bit, the sign of a zero included."""
    word = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(word), b.view(word))


def assert_fold(tra):
    """The fold's layout is the final pass's with column words of x: the
    values, chunk pointers and row map shared, the ``CONT`` bits kept."""
    s, f = tra.sell, tra.final.sell
    assert s.shape == tra.shape and s.nnz == f.nnz == tra.nnz
    assert s.vals is f.vals and s.chunk_ptr is f.chunk_ptr and s.row_of is f.row_of
    assert s.cols.dtype == torch.int32 and s.cols.shape == f.cols.shape
    assert torch.equal(s.cols < 0, f.cols < 0)
    col = s.cols & (CONT - 1)
    assert col.numel() == 0 or int(col.max()) < tra.shape[1]


def assert_fold_is_chain(tra, x):
    before = (dict(S.launches), dict(W.launches))
    y = tra @ x
    assert bits_equal(y, routed_chain_rmult(tra, x))
    assert (S.launches, W.launches) == before  # plain versions count nothing
    return y


@pytest.mark.parametrize("kw", [{}, dict(window_f=4, leaf_slabs=1, _digits=(2, 3))],
                         ids=["default", "two_passes_wf4"])
def test_fold_is_the_chain(kw, dtype):
    """On the generators of test_rmult_matches_jax: the folded product equals
    the chain bit for bit, for a seeded x, for ones and for a panel."""
    _, jra, tra = _chain_pair(dtype, **kw)
    assert_fold(tra)
    rng = np.random.default_rng(1)
    assert_fold_is_chain(tra, torch.from_numpy(rng.standard_normal(jra.shape[1]).astype(dtype)))
    assert_fold_is_chain(tra, torch.ones(jra.shape[1], dtype=tra.dtype))
    xs = torch.from_numpy(rng.standard_normal((jra.shape[1], 11)).astype(dtype))
    assert_fold_is_chain(tra, xs)  # two panel launches' worth of columns
    ys = tra @ xs
    for j in range(11):
        assert bits_equal(ys[:, j], tra @ xs[:, j].contiguous())


@pytest.mark.parametrize("make", [_rectangular, _power_law], ids=["rectangular", "power_law"])
def test_fold_is_the_chain_rectangular_and_power_law(make, dtype):
    jcsr = make()
    tra = routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0)  # float32 entries
    if dtype == np.float64:
        tra = tra.astype(torch.float64)
    assert_fold(tra)
    rng = np.random.default_rng(4)
    assert_fold_is_chain(tra, torch.from_numpy(rng.standard_normal(jcsr.shape[1]).astype(dtype)))
    assert_fold_is_chain(tra, torch.from_numpy(
        rng.standard_normal((jcsr.shape[1], 3)).astype(dtype)))


def test_product_runs_no_routing_pass(monkeypatch):
    """rmult of a routed matrix reads only the folded layout: no routing
    pass, no K7 over a stream."""
    _, jra, tra = _chain_pair(np.float32, n=3_000)

    def refuse(*a, **k):
        raise AssertionError("a routing pass ran inside a product")

    monkeypatch.setattr(S, "stream_gather", refuse)
    monkeypatch.setattr(W, "wsell_spmv", refuse)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(3_000).astype(np.float32))
    assert tra.rmult(x).shape == (3_000,)
    assert smm.rmult(tra, torch.stack([x, x], 1)).shape == (3_000, 2)


def test_fold_refuses_a_live_term_on_padding():
    """A chain whose last stream holds padding where a live term of the final
    pass reads raises; so does a pass that scales what it moves."""
    tra = routed_from_csr(port_csr(jax_uniform_random(6_000, per_row=4, seed=5,
                                                      dtype=np.float32)), max_slot_ratio=99.0)
    last = tra.passes[-1]
    holes = last.vals.clone()
    holes.view(-1)[holes.view(-1).nonzero()[:5]] = 0  # five real slots made padding
    broken = tra.passes[:-1] + (dataclasses.replace(last, vals=holes),)
    with pytest.raises(ValueError, match="reads a padding slot"):
        RoutedMatrix(passes=broken, final=tra.final, shape=tra.shape, nnz=tra.nnz,
                     slot_ratio=tra.slot_ratio)
    scaled = tra.passes[:-1] + (dataclasses.replace(last, vals=last.vals * 2),)
    with pytest.raises(ValueError, match="other than 1 and 0"):
        fold_chain(scaled, tra.final, tra.shape)


def test_every_constructor_carries_the_same_fold(dtype):
    """routed_from_csr, the interop chain from the JAX package's arrays and
    astype (either way) carry one fold: the same column words."""
    jcsr, jra, tra = _chain_pair(dtype)
    built = routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0)
    assert torch.equal(built.sell.cols, tra.sell.cols)
    assert torch.equal(built.sell.chunk_ptr, tra.sell.chunk_ptr)
    other = torch.float32 if dtype == np.float64 else torch.float64
    cast = tra.astype(other)
    assert cast.sell.cols is tra.sell.cols and cast.sell.dtype == other
    assert cast.sell.vals is cast.final.sell.vals
    assert_fold(cast)
    assert torch.equal(cast.astype(tra.dtype).sell.vals, tra.sell.vals)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(jra.shape[1])).to(other)
    assert_fold_is_chain(cast, x)


# -- the native bindings -----------------------------------------------------------------


def test_sort_perm_is_a_stable_argsort():
    if not native.available():
        pytest.skip("the native library needs g++")
    key = np.random.default_rng(0).integers(0, 1 << 40, 50_000)
    key[::7] = key[3]  # ties
    np.testing.assert_array_equal(native.sort_perm(key), np.argsort(key, kind="stable"))
    np.testing.assert_array_equal(native.sort_perm(key.astype(np.uint64)),
                                  np.argsort(key, kind="stable"))
    assert native.sort_perm(key.astype(np.int32)) is None
    assert native.sort_perm(-key) is None


def test_bindings_return_none_without_the_library(monkeypatch):
    """The W-SELL layout routines' contract: no library, no result; the caller then
    takes the NumPy expressions (the ``numpy`` cases of ``chain_code``)."""
    monkeypatch.setattr(native, "library", lambda: None)
    z = np.zeros(4, np.int64)
    assert native.stream_pack_cf(z, z, z, z, 8) is None
    assert native.sort_perm(z) is None
    assert native.stream_group(8, z, z) is None
    assert native.stream_emit(3, z, z, z, z, z, z, np.zeros((8, 128), np.float32),
                              np.zeros((8, 128), np.int32)) is None
    assert native.stream_level(8, 2, 1, 1, -1, 4, 6, z, z, z, z, z) is None
