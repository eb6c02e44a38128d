"""The port's double-word arithmetic and operators held against the JAX package.

* Primitives: ``two_sum`` and ``two_prod`` are error-free (s + e equals
  a + b, p + e equals a * b, exactly), and ``df_add`` / ``df_sub`` /
  ``df_mul`` / ``df_div`` / ``df_scale_add`` / ``df_dot`` / ``df_norm2``
  agree with the JAX package's on the same inputs and with host float64.
  The JAX tests enable x64, so on the CPU the JAX package computes its
  error-free transforms through one float64 operation (its ``_via_f64``);
  the results agree to the double-word precision, relative 1e-12 (the JAX
  package's own bound, tests/test_df64.py), and ``two_prod`` exactly.
* K9/K10: the plain versions of ``dia_spmv_padded_df`` and
  ``dia_spmv_streamed_df``, on operators carried over by ``interop``,
  against the Pallas kernels in interpret mode and against the host float64
  product, recombined hi + lo, to relative 1e-12 (tests/test_pallas_spmv.py).
* ``DfEllMatrix``, ``df_operator_from_host_csr``, ``load_matrix_df``.

On the CPU the wrappers run the plain versions; the CUDA kernel is checked
by tests/test_torch_cuda_kernels.py on a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

from sparse_matrix_math_tpu.io.dispatch import load_matrix_df as jax_load_matrix_df
from sparse_matrix_math_tpu.ops import df32 as JD
from sparse_matrix_math_tpu.ops.pallas_spmv import dia_spmv_padded_df as jax_k9
from sparse_matrix_math_tpu.ops.pallas_spmv import dia_spmv_streamed_df as jax_k10
from sparse_matrix_math_tpu.ops.pallas_spmv import pad_dia_df as jax_pad_dia_df
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop, load_matrix_df
from sparse_matrix_math_tpu_torch.io import MatrixLoadStatus, MatrixMarketError
from sparse_matrix_math_tpu_torch.ops import df32 as D
from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as K

REL = 1e-12


def jax_pair(x64):
    return JD.df_from_host(x64)


def port_pair(x64):
    return D.df_from_host(x64, device="cpu")


def host(x):
    """A pair of either package, recombined in float64."""
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def port_host(x):
    return D.df_to_host(x)


def values48(pair):
    """The float64 values a port pair holds (the 48-bit split of its input)."""
    return port_host(pair)


# -- primitives ------------------------------------------------------------------


def test_split_matches_jax_bit_for_bit():
    v = np.random.default_rng(0).standard_normal(1000) * 1e3
    jh, jl = jax_pair(v)
    th, tl = port_pair(v)
    assert th.dtype == tl.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert np.max(np.abs(port_host((th, tl)) - v) / np.abs(v)) <= 2.0 ** -48


def _f32_cases():
    """Pairs of f32 vectors: random, cancelling (a ~ -b), far-apart
    exponents, signed zeros and exact sums."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(512).astype(np.float32)
    cases = {
        "random": (a, rng.standard_normal(512).astype(np.float32) * 3),
        "cancelling": (a, (-a * (1 + 2.0 ** -20)).astype(np.float32)),
        "far_apart": (a * np.float32(1e12), rng.standard_normal(512).astype(np.float32) * 1e-12),
        "zeros_and_exact": (np.array([0.0, -0.0, 1.0, 0.5, -3.0], np.float32),
                            np.array([-0.0, 0.0, 1.0, 0.25, 3.0], np.float32)),
    }
    return cases


@pytest.mark.parametrize("case", list(_f32_cases()))
def test_two_sum_is_exact(case):
    a, b = _f32_cases()[case]
    s, e = D.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    s, e = s.numpy().astype(np.float64), e.numpy().astype(np.float64)
    for i in range(a.shape[0]):  # s + e == a + b exactly
        assert math.fsum([s[i], e[i], -float(a[i]), -float(b[i])]) == 0.0
    np.testing.assert_array_equal(s, (a + b).astype(np.float64))  # s is the rounded sum
    if case in ("random", "cancelling", "zeros_and_exact"):
        # exponents within 29 of each other: JAX's one float64 add is exact too
        js, je = JD.two_sum(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(e, np.asarray(je, np.float64))
        np.testing.assert_array_equal(s, np.asarray(js, np.float64))


@pytest.mark.parametrize("case", list(_f32_cases()))
def test_two_prod_is_exact_and_matches_jax(case):
    a, b = _f32_cases()[case]
    p, e = D.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    p, e = p.numpy().astype(np.float64), e.numpy().astype(np.float64)
    # f32 * f32 is exact in float64, and so is p + e
    np.testing.assert_array_equal(p + e, a.astype(np.float64) * b.astype(np.float64))
    jp, je = JD.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p, np.asarray(jp, np.float64))
    np.testing.assert_array_equal(e, np.asarray(je, np.float64))


OPS = [("add", D.df_add, JD.df_add, np.add), ("sub", D.df_sub, JD.df_sub, np.subtract),
       ("mul", D.df_mul, JD.df_mul, np.multiply), ("div", D.df_div, JD.df_div, np.divide)]


@pytest.mark.parametrize("scale", [1.0, 1e-6], ids=["unit", "small"])
@pytest.mark.parametrize("name,op,jop,oracle", OPS, ids=[o[0] for o in OPS])
def test_elementwise_ops_match_jax_and_f64(name, op, jop, oracle, scale):
    rng = np.random.default_rng(2)
    a64 = rng.standard_normal(4096) * scale
    b64 = rng.standard_normal(4096) * 3.0
    got = port_host(op(port_pair(a64), port_pair(b64)))
    want_jax = host(jop(jax_pair(a64), jax_pair(b64)))
    a48, b48 = values48(port_pair(a64)), values48(port_pair(b64))
    want = oracle(a48, b48)
    # error relative to the op's natural scale: |a| + |b| for add/sub (a
    # cancellation of the inputs is no arithmetic error), |result| else
    s = np.abs(a48) + np.abs(b48) if name in ("add", "sub") else np.abs(want)
    s = np.maximum(s, 1e-300)
    assert np.max(np.abs(got - want) / s) < REL
    assert np.max(np.abs(got - want_jax) / s) < REL


def test_cancellation_in_add_and_scale_add():
    """Sums whose hi words cancel exactly: the lo words carry the result."""
    rng = np.random.default_rng(3)
    big = rng.standard_normal(2048) * 3e4
    small = rng.standard_normal(2048) * 1e-3
    got = port_host(D.df_add(port_pair(big + small), port_pair(-big)))
    want = values48(port_pair(big + small)) + values48(port_pair(-big))
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(big))
    alpha = rng.standard_normal() * 2.0
    y, x = rng.standard_normal(2048), rng.standard_normal(2048)
    ta = tuple(w.reshape(()) for w in port_pair(np.array([alpha])))
    ja = tuple(w.reshape(()) for w in jax_pair(np.array([alpha])))
    got = port_host(D.df_scale_add(port_pair(y), ta, port_pair(x)))
    want_jax = host(JD.df_scale_add(jax_pair(y), ja, jax_pair(x)))
    want = values48(port_pair(y)) + float(port_host(ta)) * values48(port_pair(x))
    scale = np.abs(y) + np.abs(alpha * x)
    assert np.max(np.abs(got - want) / scale) < REL
    assert np.max(np.abs(got - want_jax) / scale) < REL


def test_add_f_and_mul_f_match_jax():
    rng = np.random.default_rng(4)
    a64, f = rng.standard_normal(1024), rng.standard_normal(1024).astype(np.float32)
    for op, jop in ((D.df_add_f, JD.df_add_f), (D.df_mul_f, JD.df_mul_f)):
        got = port_host(op(port_pair(a64), torch.from_numpy(f)))
        want = host(jop(jax_pair(a64), jnp.asarray(f)))
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)


@pytest.mark.parametrize("n", [1, 1000, 65536], ids=["n1", "n1000", "n65536"])
def test_dot_matches_jax_and_f64(n):
    x64 = np.random.default_rng(5).standard_normal(n)
    y64 = np.random.default_rng(6).standard_normal(n)
    got = float(port_host(D.df_dot(port_pair(x64), port_pair(y64))))
    want = float(np.dot(values48(port_pair(x64)), values48(port_pair(y64))))
    jax_got = float(host(JD.df_dot(jax_pair(x64), jax_pair(y64))))
    scale = float(np.dot(np.abs(x64), np.abs(y64)))
    assert abs(got - want) / scale < REL
    assert abs(got - jax_got) / scale < REL


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_dots_in_one_tree_equal_separate_dots(n):
    rng = np.random.default_rng(12)
    x, y, z = (port_pair(rng.standard_normal(n)) for _ in range(3))
    for got, want in zip(D.df_dots(x, (y, z, x)), (D.df_dot(x, y), D.df_dot(x, z),
                                                   D.df_norm2(x))):
        assert got[0].shape == () and torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])


def test_dot_cancellation_beats_f32():
    """Exact double-word inputs whose hi words cancel pairwise
    (tests/test_df64.py:100-122): x . 1 is the sum of the lo words."""
    n = 4096
    rng = np.random.default_rng(11)
    hi = np.empty(2 * n, np.float32)
    hi[0::2], hi[1::2] = np.float32(3e4), np.float32(-3e4)
    lo = (1.0 + 0.1 * rng.standard_normal(2 * n)).astype(np.float32)
    x64 = hi.astype(np.float64) + lo.astype(np.float64)
    want = float(np.sum(x64))
    ones = port_pair(np.ones(2 * n))
    got = float(port_host(D.df_dot((torch.from_numpy(hi), torch.from_numpy(lo)), ones)))
    assert abs(got - want) / abs(want) < 1e-10
    f32 = float(np.sum(x64.astype(np.float32), dtype=np.float32))
    assert abs(f32 - want) > 1e3 * abs(got - want)
    jax_got = float(host(JD.df_dot((jnp.asarray(hi), jnp.asarray(lo)), jax_pair(np.ones(2 * n)))))
    assert abs(got - jax_got) / abs(want) < 1e-10


def test_norm2_nonnegative_and_accurate():
    x64 = np.random.default_rng(7).standard_normal(10000) * 1e-3
    got = float(port_host(D.df_norm2(port_pair(x64))))
    want = float(np.dot(values48(port_pair(x64)), values48(port_pair(x64))))
    assert got >= 0.0 and abs(got - want) / want < REL
    assert abs(got - float(host(JD.df_norm2(jax_pair(x64))))) / want < REL


# -- K9 / K10 ----------------------------------------------------------------------


def _df_system(name, args, perturb=True):
    """A JAX double-word DIA operator with non-trivial lo planes
    (tests/test_pallas_spmv.py:148-158), its port twin, and host CSR."""
    a = getattr(jax_gen, name)(*args, dtype=np.float64)
    data = np.asarray(a.data, np.float64)
    if perturb:
        data = data * (1.0 + 1e-9 * np.arange(a.nnz))
    indices, indptr = np.asarray(a.indices, np.int64), np.asarray(a.indptr, np.int64)
    jd = JD.DfDiaMatrix.from_host_csr(data, indices, indptr, a.shape)
    td = interop.df_dia_from_numpy(np.asarray(jd.diags_hi), np.asarray(jd.diags_lo), jd.offsets,
                                   jd.shape, jd.nnz, "cpu")
    return jd, td, (data, indices, indptr)


K9_SYSTEMS = [("poisson_2d", (7,)), ("poisson_2d", (48,)), ("poisson_3d_27pt", (6,)),
              ("convection_diffusion_2d", (20,))]


@pytest.mark.parametrize("jax_kernel,port_kernel", [(jax_k9, K.dia_spmv_padded_df),
                                                    (jax_k10, K.dia_spmv_streamed_df)],
                         ids=["K9", "K10"])
@pytest.mark.parametrize("name,args", K9_SYSTEMS, ids=[f"{n}{a}" for n, a in K9_SYSTEMS])
def test_plain_kernel_matches_jax_interpret(name, args, jax_kernel, port_kernel):
    jd, td, (data, indices, indptr) = _df_system(name, args)
    n = jd.shape[0]
    x64 = np.random.default_rng(3).standard_normal(n)
    jp = jax_pad_dia_df(jd)
    jx = jax_pair(x64)
    jyh, jyl = jax_kernel(jp, jp.to_padded(jx[0]), jp.to_padded(jx[1]), interpret=True)
    want_jax = host((jp.from_padded(jyh), jp.from_padded(jyl)))
    tp = K.pad_dia_df(td)
    tx = port_pair(x64)
    before = dict(K.launches)
    yh, yl = port_kernel(tp, tp.to_padded(tx[0]), tp.to_padded(tx[1]))
    assert K.launches == before  # the plain version launches nothing
    assert yh.dtype == yl.dtype == torch.float32 and yh.shape == (tp.n_total,)
    for y in (yh, yl):  # guard rows write exact zeros
        assert torch.all(y[:tp.lead] == 0) and torch.all(y[tp.lead + n:] == 0)
    got = port_host((tp.from_padded(yh), tp.from_padded(yl)))
    x48 = values48(tx)
    want = np.add.reduceat(data * x48[indices], indptr[:-1])
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want_jax)) / scale < REL
    assert np.max(np.abs(got - want)) / scale < REL


def test_rmult_df_is_the_padded_product():
    jd, td, _ = _df_system("convection_diffusion_2d", (9,))
    x = port_pair(np.random.default_rng(4).standard_normal(td.shape[0]))
    tp = K.pad_dia_df(td)
    yh, yl = K.dia_spmv_padded_df_plain(tp.hi.diags_p, tp.lo.diags_p, tp.offsets, tp.lead,
                                        td.shape[0], tp.to_padded(x[0]), tp.to_padded(x[1]))
    got = td.rmult_df(x)
    assert torch.equal(got[0], tp.from_padded(yh)) and torch.equal(got[1], tp.from_padded(yl))
    np.testing.assert_allclose(port_host(got), host(jd.rmult_df(jax_pair(x64=port_host(x)))),
                               rtol=0, atol=REL * np.max(np.abs(port_host(got))))


def test_padded_layout_matches_f32_layout():
    """The hi and lo planes share PaddedDIA's guards: at least one leading
    block, a lead that covers -min(offsets)."""
    _, td, _ = _df_system("poisson_2d", (48,))
    tp = K.pad_dia_df(td)
    assert tp.lead >= max(-min(td.offsets), 128) and tp.lead % 128 == 0
    assert tp.hi.n_total == tp.lo.n_total and tp.hi.lead == tp.lo.lead
    assert tp.n_total >= tp.lead + td.shape[0] + max(td.offsets)


def test_wrapper_checks_its_inputs():
    _, td, _ = _df_system("poisson_2d", (7,))
    tp = K.pad_dia_df(td)
    xh = torch.zeros(tp.n_total)
    with pytest.raises(TypeError):
        K.dia_spmv_padded_df(tp, xh.double(), xh.double())
    with pytest.raises(ValueError):
        K.dia_spmv_padded_df(tp, xh[:-1], xh[:-1])


# -- ELL, operator choice, loader ------------------------------------------------------


ELL_SYSTEMS = [("laplace_3d_jittered", (8,), dict(symmetric=True, shift=0.25)),
               ("uniform_random_csr", (300,), {}), ("poisson_2d", (24,), {})]


@pytest.mark.parametrize("name,args,kw", ELL_SYSTEMS, ids=[s[0] for s in ELL_SYSTEMS])
def test_ell_rmult_df_matches_jax(name, args, kw):
    a = getattr(jax_gen, name)(*args, dtype=np.float64, **kw)
    data = np.asarray(a.data, np.float64) * (1.0 + 1e-9 * np.arange(a.nnz))
    indices, indptr = np.asarray(a.indices, np.int64), np.asarray(a.indptr, np.int64)
    je = JD.DfEllMatrix.from_host_csr(data, indices, indptr, a.shape)
    te = D.DfEllMatrix.from_host_csr(data, indices, indptr, a.shape, device="cpu")
    for mine, theirs in ((te.vals_hi, je.vals_hi), (te.vals_lo, je.vals_lo), (te.cols, je.cols)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
    carried = interop.df_ell_from_numpy(np.asarray(je.vals_hi), np.asarray(je.vals_lo),
                                        np.asarray(je.cols), je.shape, je.nnz, "cpu")
    x64 = np.random.default_rng(8).standard_normal(a.shape[1])
    got = port_host(te.rmult_df(port_pair(x64)))
    assert np.array_equal(got, port_host(carried.rmult_df(port_pair(x64))))
    want = np.add.reduceat(data * values48(port_pair(x64))[indices], indptr[:-1])
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - host(je.rmult_df(jax_pair(x64))))) / scale < REL
    assert np.max(np.abs(got - want)) / scale < REL


def test_ell_empty_rows_are_exact():
    data, indices = np.array([2.0, 5.0]), np.array([0, 2])
    indptr = np.array([0, 1, 1, 2, 2])
    te = D.DfEllMatrix.from_host_csr(data, indices, indptr, (4, 4), device="cpu")
    got = port_host(te.rmult_df(port_pair(np.array([1.0, 10.0, 100.0, 1000.0]))))
    np.testing.assert_array_equal(got, [2.0, 0.0, 500.0, 0.0])


OPERATOR_CASES = [("poisson_2d", (16,), {}), ("convection_diffusion_2d", (12,), {}),
                  ("laplace_3d_jittered", (6,), dict(symmetric=True)),
                  ("uniform_random_csr", (256,), {})]


@pytest.mark.parametrize("name,args,kw", OPERATOR_CASES, ids=[c[0] for c in OPERATOR_CASES])
def test_operator_choice_matches_jax(name, args, kw):
    a = getattr(jax_gen, name)(*args, dtype=np.float64, **kw)
    host_csr = (np.asarray(a.data), np.asarray(a.indices), np.asarray(a.indptr), a.shape)
    mine = D.df_operator_from_host_csr(*host_csr, device="cpu")
    theirs = JD.df_operator_from_host_csr(*host_csr)
    assert type(mine).__name__ == type(theirs).__name__
    if isinstance(mine, D.DfDiaMatrix):
        assert mine.offsets == theirs.offsets
        np.testing.assert_array_equal(mine.diags_hi.numpy(), np.asarray(theirs.diags_hi))
        np.testing.assert_array_equal(mine.diags_lo.numpy(), np.asarray(theirs.diags_lo))


def _write_mtx(path, coo, symmetric=False):
    r, c, v, n = coo
    lines = ["%%MatrixMarket matrix coordinate real " + ("symmetric" if symmetric else "general"),
             "% written by the test", f"{n} {n} {len(v)}"]
    lines += [f"{i + 1} {j + 1} {float(x)!r}" for i, j, x in zip(r, c, v)]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["stencil", "scattered"])
def test_load_matrix_df_matches_jax(tmp_path, kind):
    rng = np.random.default_rng(9)
    if kind == "stencil":  # a symmetric tridiagonal with values not exact in f32
        n = 40
        r = np.concatenate([np.arange(n), np.arange(1, n)])
        c = np.concatenate([np.arange(n), np.arange(n - 1)])
        v = np.concatenate([4.0 + rng.random(n) / 3, -1.0 - rng.random(n - 1) / 7])
        symmetric, general = True, False
    else:  # 300 rows, 5 scattered entries each: ELL
        n = 300
        r = np.repeat(np.arange(n), 5)
        c = rng.integers(0, n, r.shape[0])
        v = rng.standard_normal(r.shape[0]) / 3
        symmetric, general = False, True
    path = tmp_path / f"{kind}.mtx"
    _write_mtx(path, (r, c, v, n), symmetric)
    mine = load_matrix_df(path, allow_general=general, device="cpu")
    theirs = jax_load_matrix_df(str(path), allow_general=general)
    assert type(mine).__name__ == type(theirs).__name__
    assert (mine.shape, mine.nnz) == (theirs.shape, theirs.nnz)
    planes = (("diags_hi", "diags_lo") if isinstance(mine, D.DfDiaMatrix)
              else ("vals_hi", "vals_lo", "cols"))
    for name in planes:
        np.testing.assert_array_equal(getattr(mine, name).numpy(),
                                      np.asarray(getattr(theirs, name)), err_msg=name)
    # hi + lo reproduce the parsed float64 values to the split's 48 bits
    x = np.random.default_rng(10).standard_normal(n)
    dense = np.zeros((n, n))
    np.add.at(dense, (r, c), v)
    if symmetric:
        off = r != c
        np.add.at(dense, (c[off], r[off]), v[off])
    np.testing.assert_allclose(port_host(mine.rmult_df(port_pair(x))), dense @ x, rtol=0,
                               atol=1e-13 * np.max(np.abs(dense @ x)))


def test_load_matrix_df_unknown_extension(tmp_path):
    with pytest.raises(MatrixMarketError) as err:
        load_matrix_df(tmp_path / "m.txt", device="cpu")
    assert err.value.status == MatrixLoadStatus.FAILED_TO_OPEN_FILE_UNKNOWN_FORMAT
