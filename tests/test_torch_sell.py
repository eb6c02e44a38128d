"""The slab-sorted SELL-32 layout (formats/sell.py) that K6 and K7 read.

* Layout: derived from ELL planes and from W-SELL planes (nway 1, 2, 4, 8;
  window_f 1 and 8; a rectangular matrix; empty slabs; the last slab's
  chunk-pad vregs; duplicate-column reads; the IC(0) strict factors of
  ``precond/trisolve.py``; a routed chain's final pass, whose x is a stream
  longer than the matrix is wide), it holds every live slot of the planes
  exactly once, each row's products in summation order, rows sorted by
  length inside each slab, padding of value 0 and column 0, and reads no
  more slots per nonzero than the planes.  The layout derived by rule from
  the planes alone (as for planes carried over by ``interop``) equals the one
  the builder derives from its own liveness.
* Products: the layout's plain version (``sell_spmv_plain``, what the
  wrappers run on CPU tensors) equals the planes' plain versions
  (``ell_spmv_plain``, ``wsell_spmv_plain``) for finite x: bit for bit for
  W-SELL, and with ``==`` for ELL, whose planes add the padding's
  ``0 * x[0]`` after a row's sum (only the sign of a zero sum can differ).
  The panel plain version (``sell_spmm_plain``, K8's and ELL panels') equals
  the per-column ``sell_spmv_plain`` and the planes' ``wsell_spmm_plain`` bit
  for bit, for k = 1..9 columns, and the ELL planes' per-column product
  with ``==``.
  Against the JAX package's Pallas kernels in interpret mode: f32 to a
  relative 1e-6 and f64 to 1e-12 of the largest |y| (only the XLA CPU
  backend's rounding differs), as tests/test_torch_wsell.py.

The CUDA kernel (``csrc/sell_spmv.cu``) is held bit for bit against the
plain version by tests/test_torch_cuda_kernels.py on a card.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.csr import csr_from_dense as jax_csr_from_dense
from sparse_matrix_math_tpu.formats.ell import ell_from_csr as jax_ell_from_csr
from sparse_matrix_math_tpu.formats.wsell import wsell_from_csr as jax_wsell_from_csr
from sparse_matrix_math_tpu.ops.pallas_spmv import ell_spmv as jax_ell_spmv
from sparse_matrix_math_tpu.ops.pallas_wsell import wsell_spmm as jax_wsell_spmm
from sparse_matrix_math_tpu.ops.pallas_wsell import wsell_spmv as jax_wsell_spmv
from sparse_matrix_math_tpu.ops.spmv import rmult as jax_rmult
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats import ell_from_csr, wsell_from_csr
from sparse_matrix_math_tpu_torch.formats import sell as S
from sparse_matrix_math_tpu_torch.formats.ell import ELLMatrix
from sparse_matrix_math_tpu_torch.formats.rsell import routed_from_csr
from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
from sparse_matrix_math_tpu_torch.ops import sell_spmv as P
from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
from sparse_matrix_math_tpu_torch.ops.spmv import rmult
from sparse_matrix_math_tpu_torch.ops.stream_gather import stream_gather_plain
from sparse_matrix_math_tpu_torch.precond import IC0Preconditioner
from test_torch_wsell import _dense, assert_close, port_csr, wsell_fields
from torch_layout_code import same_layout_code  # noqa: F401  (an autouse fixture)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.int32 if t.dtype == torch.float32 else np.int64)


def coo(csr):
    """(rows, columns, values) of a port CSR matrix, as numpy."""
    return csr.row_ids.numpy(), csr.indices.numpy(), csr.data.numpy()


def assert_layout(s: S.SellMatrix, rows, cols, vals):
    """``s`` holds the entries (rows, cols, vals) exactly once: each row's
    entries in its chunk's first slots, padding value 0 and column 0, rows
    sorted by entry count inside each slab, chunks as wide as their longest
    row."""
    n_rows = s.shape[0]
    counts = np.bincount(rows, minlength=s.n_slabs * S.SLAB)
    row_of = s.row_of.numpy().astype(np.int64).reshape(s.n_slabs, S.SLAB)
    assert np.array_equal(np.sort(row_of, axis=1), np.tile(np.arange(S.SLAB), (s.n_slabs, 1)))
    sorted_counts = np.take_along_axis(counts.reshape(s.n_slabs, S.SLAB), row_of, axis=1)
    assert np.all(np.diff(sorted_counts, axis=1) <= 0)  # longest first
    ptr = s.chunk_ptr.numpy()
    widths = np.diff(ptr)
    assert np.array_equal(widths, sorted_counts.reshape(-1, S.CHUNK).max(axis=1))
    assert s.n_slots == ptr[-1] * S.CHUNK
    v, w = s.vals.numpy(), s.cols.numpy()
    col = (w & 0x7FFFFFFF).astype(np.int64)
    used = np.zeros(s.n_slots, bool)
    got_r, got_c, got_v = [], [], []
    for slab in range(s.n_slabs):
        for place in range(S.SLAB):
            row = slab * S.SLAB + int(row_of[slab, place])
            chunk = slab * (S.SLAB // S.CHUNK) + place // S.CHUNK
            at = (ptr[chunk] + np.arange(counts[row])) * S.CHUNK + place % S.CHUNK
            assert row < n_rows or at.size == 0
            used[at] = True
            got_r.append(np.full(at.size, row))
            got_c.append(col[at])
            got_v.append(v[at])
    assert np.all(v[~used] == 0) and np.all(w[~used] == 0)
    got = np.lexsort((np.concatenate(got_v), np.concatenate(got_c), np.concatenate(got_r)))
    want = np.lexsort((vals, cols, rows))
    np.testing.assert_array_equal(np.concatenate(got_r)[got], rows[want])
    np.testing.assert_array_equal(np.concatenate(got_c)[got], cols[want])
    np.testing.assert_array_equal(np.concatenate(got_v)[got], vals[want])


def same_layout(a: S.SellMatrix, b: S.SellMatrix) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("vals", "cols", "chunk_ptr", "row_of"))


# -- W-SELL ---------------------------------------------------------------------------

def _jittered(m, d, symmetric=True):
    return jax_gen.laplace_3d_jittered(m, dtype=d, symmetric=symmetric,
                                       shift=0.25 if symmetric else 0.0)


def _cast(jcsr_f32, d):
    return jax_csr_from_dense(np.asarray(jcsr_f32.to_dense()).astype(d))


WSELL_CASES = [
    ("poisson_2d(48)", lambda d: jax_gen.poisson_2d(48, dtype=d), {}),
    ("jittered(14)-nway2", lambda d: _jittered(14, d), dict(nway=2)),
    ("jittered(14)-nway4", lambda d: _jittered(14, d), dict(nway=4)),
    ("jittered(14)-nway8", lambda d: _jittered(14, d), dict(nway=8)),
    ("jittered(14)-wf8", lambda d: _jittered(14, d, symmetric=False), dict(window_f=8)),
    ("jittered(14)-wf8-nway4", lambda d: _jittered(14, d, symmetric=False),
     dict(window_f=8, nway=4)),
    ("jittered(24)-nway4-chunk-pad", lambda d: _jittered(24, d), dict(nway=4)),
    ("random_spd(600)-nway8", lambda d: jax_gen.random_spd_csr(600, density=0.012, seed=5,
                                                               dtype=d),
     dict(max_slot_ratio=64.0, nway=8)),
    ("empty_rows_and_slabs", lambda d: _cast(_dense("empty_rows_and_slabs"), d),
     dict(max_slot_ratio=1e9)),
    ("rectangular", lambda d: _cast(_dense("rectangular"), d), {}),
    ("duplicate_columns", lambda d: _cast(_dense("duplicate_columns"), d), {}),
]
WSELL_IDS = [c[0] for c in WSELL_CASES]


def _x(n, dtype, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("name,make,kw", WSELL_CASES, ids=WSELL_IDS)
def test_wsell_layout_holds_every_live_slot_once(name, make, kw):
    csr = port_csr(make(np.float64))
    ws = wsell_from_csr(csr, **kw)
    assert_layout(ws.sell, *coo(csr))
    assert ws.sell.slots_per_nonzero <= ws.slot_ratio
    assert ws.sell.nnz == ws.nnz and ws.sell.shape == ws.shape
    if kw.get("nway", 1) > 1 and ws.nway > 1:
        assert bool((ws.sell.cols < 0).any())  # grouped terms carry the bit


@pytest.mark.parametrize("name,make,kw", WSELL_CASES, ids=WSELL_IDS)
def test_wsell_plain_equals_planes_bit_for_bit(name, make, kw, dtype):
    ws = wsell_from_csr(port_csr(make(dtype)), **kw)
    x = torch.from_numpy(_x(ws.shape[1], dtype))
    y = P.sell_spmv_plain(ws.sell, x)
    assert y.dtype == ws.dtype and y.shape == (ws.shape[0],)
    np.testing.assert_array_equal(bits(y), bits(W.wsell_spmv_plain(ws, x)))
    before = dict(W.launches)
    assert torch.equal(W.wsell_spmv(ws, x), y)  # the wrapper runs it on the CPU
    assert W.launches == before


@pytest.mark.parametrize("name,make,kw", WSELL_CASES, ids=WSELL_IDS)
def test_wsell_rule_equals_builder_liveness(name, make, kw):
    """Padding told by rule from the planes alone (no stored zeros here)
    gives the layout the builder derives from where it placed each entry."""
    ws = wsell_from_csr(port_csr(make(np.float32)), **kw)
    again = S.sell_from_wsell(ws.vals, ws.meta, ws.base, ws.slab, ws.shape, ws.nnz,
                              max(3, (8 * ws.window_f - 1).bit_length()), ws.nway)
    assert same_layout(again, ws.sell)


@pytest.mark.parametrize("name,make,kw", WSELL_CASES, ids=WSELL_IDS)
def test_wsell_matches_jax_interpret(name, make, kw, dtype):
    """The JAX planes carried over by interop give JAX's kernel's product."""
    jcsr = make(dtype)
    jws = jax_wsell_from_csr(jcsr, **kw)
    tws = interop.wsell_from_numpy(wsell_fields(jws), "cpu")
    assert tws.sell.slots_per_nonzero <= tws.slot_ratio
    x = _x(jws.shape[1], dtype, seed=2)
    ref = jax_wsell_spmv(jws, jnp.asarray(x), interpret=True)
    assert_close(W.wsell_spmv(tws, torch.from_numpy(x)).numpy(), ref, dtype)


def test_last_slab_holds_chunk_pad_vregs():
    """The chunk-pad vregs (all zero, in the last slab) add no slot."""
    csr = port_csr(_jittered(24, np.float64))
    ws = wsell_from_csr(csr, nway=4)
    ptr = ws.slab_ptr.numpy()
    last = ws.vals.numpy().reshape(ws.n_vregs, -1)[ptr[-2]:ptr[-1]]
    assert ws.n_vregs == 512 and (~last.any(axis=1)).sum() >= 100
    assert_layout(ws.sell, *coo(csr))


def test_stored_zero_stays_a_term():
    """A stored zero is a term (the builder's liveness), not padding: its
    column is read, so a non-finite x there reaches its row, as in the
    planes' product; every other row reads only its own entries."""
    n = 300
    r = np.append(np.arange(n), 5)
    c = np.append(np.arange(n), 256)
    v = np.append(np.full(n, 2.0), 0.0)  # a stored zero at (5, 256)
    csr = smm.csr_from_coo(smm.coo_from_arrays(r, c, v, (n, n), device="cpu"))
    assert csr.nnz == n + 1
    ws = wsell_from_csr(csr)
    assert_layout(ws.sell, *coo(csr))
    x = torch.ones(n, dtype=torch.float64)
    x[256] = float("inf")
    y = P.sell_spmv_plain(ws.sell, x)
    assert torch.isnan(y[5]) and torch.isnan(W.wsell_spmv_plain(ws, x)[5])
    want = 2.0 * x
    assert torch.equal(y[:5], want[:5]) and torch.equal(y[6:], want[6:])


# -- the IC(0) strict factors ---------------------------------------------------------


def test_ic0_strict_factor_layout_and_product(dtype):
    jcsr = _jittered(14, dtype)
    kw = dict(method="jacobi", sweeps=4, strict_layout="wsell")
    jpre = jsmm.get_preconditioner(jcsr, "ic0", **kw)
    tpre = IC0Preconditioner.from_matrix(port_csr(jcsr), **kw)
    x = _x(jcsr.shape[0], dtype, seed=3)
    for jt, tt in ((jpre.lower, tpre.lower), (jpre.upper, tpre.upper)):
        ws = tt.wsell
        assert ws is not None
        assert_layout(ws.sell, tt.row_ids.numpy(), tt.indices.numpy(), tt.data.numpy())
        assert ws.sell.slots_per_nonzero < 1.2 < ws.slot_ratio
        xt = torch.from_numpy(x)
        y = P.sell_spmv_plain(ws.sell, xt)
        np.testing.assert_array_equal(bits(y), bits(W.wsell_spmv_plain(ws, xt)))
        assert_close(y.numpy(), jax_wsell_spmv(jt.wsell, jnp.asarray(x), interpret=True), dtype)


# -- a routed chain's final pass ------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, dict(window_f=4, leaf_slabs=1, _digits=(2, 3))],
                         ids=["default", "two_passes_wf4"])
def test_routed_final_pass(kw, dtype):
    """The final W-SELL pass reads the routed stream, longer than the matrix
    is wide; its layout is derived from the builder's liveness."""
    if shutil.which("g++") is None:
        pytest.skip("a routed chain's final layout needs the native colouring (g++)")
    jcsr = jax_gen.uniform_random_csr(6_000, per_row=4, seed=5, dtype=dtype)
    ra = routed_from_csr(port_csr(jcsr), max_slot_ratio=99.0, **kw)
    fin = ra.final
    assert fin.shape[1] > jcsr.shape[1] and fin.sell.shape == fin.shape
    assert fin.sell.slots_per_nonzero <= fin.slot_ratio
    x = _x(jcsr.shape[1], dtype, seed=4)
    t = torch.from_numpy(x)
    for p in ra.passes:
        t = stream_gather_plain(p.base, p.meta, p.vals, t, x_rows=p.x_rows, window_f=p.window_f)
    assert t.shape == (fin.shape[1],)
    y = P.sell_spmv_plain(fin.sell, t)
    np.testing.assert_array_equal(bits(y), bits(W.wsell_spmv_plain(fin, t)))
    assert torch.equal(ra @ torch.from_numpy(x), y)
    assert_close(y.numpy(), jax_rmult(jcsr, jnp.asarray(x)), dtype)


# -- ELL ------------------------------------------------------------------------------

ELL_CASES = [
    ("poisson_2d(20)", lambda d: jax_gen.poisson_2d(20, dtype=d)),
    ("jittered(14)", lambda d: _jittered(14, d)),
    ("jittered(22)", lambda d: _jittered(22, d, symmetric=False)),
    ("rectangular", lambda d: _cast(_dense("rectangular"), d)),
    ("empty_rows_and_slabs", lambda d: _cast(_dense("empty_rows_and_slabs"), d)),
]
ELL_IDS = [c[0] for c in ELL_CASES]


@pytest.mark.parametrize("name,make", ELL_CASES, ids=ELL_IDS)
def test_ell_layout_holds_every_live_slot_once(name, make):
    csr = port_csr(make(np.float64))
    ell = ell_from_csr(csr)
    assert_layout(ell.sell, *coo(csr))
    # the planes' slots, plus at most one part-filled chunk per slab
    assert ell.sell.n_slots <= (ell.rows_padded + ell.sell.n_slabs * S.CHUNK) * ell.slots
    assert not bool((ell.sell.cols < 0).any())  # one product per term


@pytest.mark.parametrize("name,make", ELL_CASES, ids=ELL_IDS)
def test_ell_plain_equals_planes(name, make, dtype):
    ell = ell_from_csr(port_csr(make(dtype)))
    x = torch.from_numpy(_x(ell.shape[1], dtype))
    y = P.sell_spmv_plain(ell.sell, x)
    assert torch.equal(y, E.ell_spmv_plain(ell, x))
    before = dict(E.launches)
    assert torch.equal(E.ell_spmv(ell, x), y)
    assert E.launches == before


@pytest.mark.parametrize("name,make", ELL_CASES, ids=ELL_IDS)
def test_ell_matches_jax_interpret(name, make, dtype):
    """ELL planes carried over by interop (live slots told by the trailing
    rule) give the builder's layout and JAX's product."""
    jcsr = make(dtype)
    jell = jax_ell_from_csr(jcsr)
    carried = interop.ell_from_numpy(np.asarray(jell.vals), np.asarray(jell.cols), jell.shape,
                                     jell.nnz, "cpu")
    assert same_layout(carried.sell, ell_from_csr(port_csr(jcsr)).sell)
    x = _x(jcsr.shape[1], dtype, seed=5)
    ref = jax_ell_spmv(jell, jnp.asarray(x), interpret=True)
    assert_close(E.ell_spmv(carried, torch.from_numpy(x)).numpy(), ref, dtype)


def test_ell_stored_zeros():
    """A stored zero inside a row stays a term; one at the row's end in
    column 0 is taken for padding when the layout is derived by rule: both
    read x[0], so no product changes."""
    vals = torch.tensor([[1.0, 0.0, 2.0], [3.0, 0.0, 0.0], [0.0, 0.0, 0.0], [4.0, 5.0, 6.0],
                         [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    cols = torch.tensor([[0, 3, 1], [2, 0, 0], [0, 0, 0], [1, 2, 3],
                         [0] * 3, [0] * 3, [0] * 3, [0] * 3], dtype=torch.int32)
    by_rule = ELLMatrix(vals=vals, cols=cols, shape=(4, 4), nnz=8)
    row_nnz = torch.tensor([3, 2, 0, 3])
    built = S.sell_from_ell(vals, cols, (4, 4), 8, row_nnz=row_nnz)
    assert by_rule.sell.n_slots == built.n_slots == 3 * S.CHUNK
    rule_cols = by_rule.sell.cols.numpy().reshape(-1, S.CHUNK)
    assert list(rule_cols[:, 0]) == [0, 3, 1]  # row 0 keeps its stored zero (column 3)
    x = torch.tensor([1.5, -2.0, 0.25, 8.0])
    want = E.ell_spmv_plain(ELLMatrix(vals=vals, cols=cols, shape=(4, 4), nnz=8), x)
    for s in (by_rule.sell, built):
        assert torch.equal(P.sell_spmv_plain(s, x), want)
    x[0] = float("inf")  # row 1's stored zero reads it, and so does padding
    assert torch.isnan(P.sell_spmv_plain(built, x)[1])
    assert torch.isnan(E.ell_spmv_plain(by_rule, x)[1])


def test_astype_carries_the_layout():
    ell = ell_from_csr(port_csr(_jittered(10, np.float64)))
    ws = wsell_from_csr(port_csr(_jittered(10, np.float64)), nway=4)
    for a in (ell, ws):
        b = a.astype(torch.float32)
        assert b.sell.dtype == torch.float32
        assert torch.equal(b.sell.cols, a.sell.cols)
        assert torch.equal(b.sell.vals, a.sell.vals.float())


# -- panels: Y = A X (K8, ELL panels) ------------------------------------------------


def _ic0_lower(dtype):
    pre = IC0Preconditioner.from_matrix(port_csr(_jittered(14, dtype)), method="jacobi",
                                        sweeps=4, strict_layout="wsell")
    return pre.lower.wsell


PANEL_CASES = [
    ("wsell-nway1", lambda d: wsell_from_csr(port_csr(jax_gen.poisson_2d(48, dtype=d)))),
    ("wsell-nway2", lambda d: wsell_from_csr(port_csr(_jittered(14, d)), nway=2)),
    ("wsell-nway4-wf8", lambda d: wsell_from_csr(port_csr(_jittered(14, d, symmetric=False)),
                                                 nway=4, window_f=8)),
    ("ic0-strict-L", _ic0_lower),
    ("ell", lambda d: ell_from_csr(port_csr(_jittered(14, d)))),
]


@pytest.mark.parametrize("k", range(1, 10))
@pytest.mark.parametrize("name,make", PANEL_CASES, ids=[c[0] for c in PANEL_CASES])
def test_panel_plain_equals_columns_and_planes(name, make, k, dtype):
    a = make(dtype)
    assert a is not None
    xs = torch.from_numpy(np.random.default_rng(k).standard_normal((a.shape[1], k)).astype(dtype))
    ys = P.sell_spmm_plain(a.sell, xs)
    assert ys.shape == (a.shape[0], k) and ys.dtype == a.dtype
    for j in range(k):
        np.testing.assert_array_equal(bits(ys[:, j].contiguous()),
                                      bits(P.sell_spmv_plain(a.sell, xs[:, j].contiguous())))
    if isinstance(a, ELLMatrix):
        for j in range(k):
            assert torch.equal(ys[:, j], E.ell_spmv_plain(a, xs[:, j].contiguous()))
        wrapped = E.ell_spmm(a, xs)
    else:
        np.testing.assert_array_equal(bits(ys), bits(W.wsell_spmm_plain(a, xs)))
        wrapped = W.wsell_spmm(a, xs)
    assert torch.equal(wrapped, ys)  # the wrappers run it on CPU tensors


@pytest.mark.parametrize("k", [2, 4, 8])
def test_panel_matches_jax_interpret(k, dtype):
    jcsr = _jittered(12, dtype)
    jws = jax_wsell_from_csr(jcsr, nway=4)
    tws = interop.wsell_from_numpy(wsell_fields(jws), "cpu")
    xs = np.random.default_rng(3).standard_normal((jws.shape[1], k)).astype(dtype)
    ref = jax_wsell_spmm(jws, jnp.asarray(xs), interpret=True)
    assert_close(P.sell_spmm_plain(tws.sell, torch.from_numpy(xs)).numpy(), ref, dtype)


def test_ell_panel_rmult_equals_columns(dtype):
    """A 2-D rmult of an ELL matrix is one panel product (the panel kernel
    on a card, its plain version here), equal to its per-column products."""
    ell = ell_from_csr(port_csr(_jittered(14, dtype)))
    xs = torch.from_numpy(np.random.default_rng(4).standard_normal((ell.shape[1], 5)).astype(dtype))
    before = dict(E.launches)
    ys = rmult(ell, xs)
    assert E.launches == before
    for j in range(5):
        np.testing.assert_array_equal(bits(ys[:, j].contiguous()),
                                      bits(rmult(ell, xs[:, j].contiguous())))
    with pytest.raises(ValueError):
        E.ell_spmm(ell, xs[:, 0].contiguous())
