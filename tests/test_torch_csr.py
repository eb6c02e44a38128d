"""The port's CSR element and matrix operations held against the JAX
package: the cases of tests/test_csr.py, each put to both packages with the
same matrix (``csr_from_dense`` / ``csr_from_triplet`` in each).  Every
operation here is exact (no sum of more than two values), so results are
compared for equality.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.interop import csr_from_numpy

TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}

# an empty row (row 2), as the reference iterator tests have
DENSE = np.array([[4.0, 0.0, 1.0, 0.0],
                  [0.0, 3.0, 0.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0],
                  [1.0, 0.0, 0.0, 5.0]])


@pytest.fixture
def sample():
    return jsmm.csr_from_dense(DENSE), smm.csr_from_dense(DENSE, device="cpu")


def _same(t, j):
    """The same CSR arrays, shape and values."""
    assert t.shape == j.shape and t.nnz == j.nnz
    for f in ("indptr", "indices", "row_ids", "data"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))


def test_from_dense_matches(sample, dtype):
    j, t = jsmm.csr_from_dense(DENSE, dtype=dtype), smm.csr_from_dense(DENSE, dtype,
                                                                        device="cpu")
    _same(t, j)
    assert t.dtype == TORCH_DTYPE[dtype]
    assert (t.dense_row_count, t.dense_col_count) == (j.dense_row_count, j.dense_col_count)
    # a tensor keeps its device; tol drops small entries in both
    _same(smm.csr_from_dense(torch.from_numpy(DENSE), tol=1.5),
          jsmm.csr_from_dense(DENSE, tol=1.5))
    with pytest.raises(TypeError, match="device"):
        smm.csr_from_dense(DENSE)


def test_from_empty_triplet():
    j = jsmm.csr_from_triplet(jsmm.TripletMatrix(3, 3))
    t = smm.csr_from_triplet(smm.TripletMatrix(3, 3), device="cpu")
    _same(t, j)
    assert t.nnz == 0 and not torch.any(t.to_dense() != 0)


def test_construction_from_triplet(dtype):
    tt, jt = smm.TripletMatrix(3, 3), jsmm.TripletMatrix(3, 3)
    for m in (tt, jt):
        m.add_entry(0, 0, 2.0)
        m.add_entry(0, 2, 1.0)
        m.add_entry(2, 1, -3.0)
        m.add_entry(2, 1, 1.0)  # the duplicate accumulates before the CSR build
    t, j = smm.csr_from_triplet(tt, dtype=dtype, device="cpu"), jsmm.csr_from_triplet(jt, dtype)
    _same(t, j)
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    # COOArrays keep their device, with an optional cast
    coo = smm.coo_from_arrays([0, 1], [1, 0], [2.0, 3.0], shape=(2, 2), device="cpu")
    assert smm.csr_from_triplet(coo, torch.float32).dtype == torch.float32


def test_columns_sorted_within_rows(sample):
    """The reference invariant: positions ascending per row (h:1246-1251)."""
    _, t = sample
    for r in range(t.shape[0]):
        cols = t.indices[int(t.indptr[r]):int(t.indptr[r + 1])]
        assert torch.all(torch.diff(cols) > 0)


def test_get_value_and_index(sample):
    """Every stored (row, col) resolves to JAX's data index; absent columns
    and the empty row give -1 and the value 0."""
    j, t = sample
    for r in range(4):
        for c in range(4):
            assert t.get_value_index(r, c) == int(j.get_value_index(r, c))
            v = t.get_value(r, c)
            assert isinstance(v, torch.Tensor) and v.dtype == t.dtype
            assert float(v) == float(j.get_value(r, c)) == DENSE[r, c]


@pytest.mark.parametrize("op,args", [("update_entry", (0, 2, 9.0)), ("update_entry", (0, 1, 9.0)),
                                     ("add_entry", (1, 3, 1.5)), ("add_entry", (2, 2, 1.0))],
                         ids=["update-stored", "update-absent", "add-stored", "add-empty-row"])
def test_entry_updates(sample, op, args):
    """A stored position changes; an absent one leaves a copy unchanged (a
    CSR cannot change its pattern, h:1572-1604); the source is untouched."""
    j, t = sample
    _same(getattr(t, op)(*args), getattr(j, op)(*args))
    _same(t, j)


def test_zero_values_and_with_data(sample):
    j, t = sample
    z = t.zero_values()
    _same(z, j.zero_values())
    assert z.has_same_nonzero_pattern(t)
    new = torch.arange(t.nnz, dtype=t.dtype)
    _same(t.with_data(new), j.with_data(jnp.asarray(new.numpy())))
    with pytest.raises(ValueError):
        t.with_data(new[:-1])


def test_iteration_skips_empty_rows(sample):
    j, t = sample
    assert list(t) == list(j)
    assert [(r, c) for r, c, _ in t] == [(0, 0), (0, 2), (1, 1), (1, 3), (3, 0), (3, 3)]


def test_row_iteration(sample):
    j, t = sample
    for r in range(4):
        assert list(t.iter_row(r)) == list(j.iter_row(r))
        assert t.row_nnz(r) == j.row_nnz(r)
    assert list(t.iter_row(1)) == [(1, 1, 3.0), (1, 3, 2.0)]
    assert list(t.iter_row(2)) == [] and t.row_nnz(2) == 0


def test_scalar_multiplication(sample):
    j, t = sample
    _same(t * 2.0, j * 2.0)
    _same(0.5 * t, 0.5 * j)
    _same(t.scale(-3.0), j.scale(-3.0))


def test_add_subtract_same_pattern(sample):
    j, t = sample
    _same(t.add(t), j.add(j))
    _same(t.add(t).subtract(t), j.add(j).subtract(j))


def test_add_pattern_mismatch_raises(sample):
    j, t = sample
    for m, other in ((j, jsmm.csr_from_dense(np.eye(4))),
                     (t, smm.csr_from_dense(np.eye(4), device="cpu"))):
        with pytest.raises(ValueError, match="pattern"):
            m.add(other)
        with pytest.raises(ValueError, match="pattern"):
            m.subtract(other)


def test_has_same_nonzero_pattern(sample):
    j, t = sample
    assert t.has_same_nonzero_pattern(t * 3.0) and j.has_same_nonzero_pattern(j * 3.0)
    eye = smm.csr_from_dense(np.eye(4), device="cpu")
    assert not t.has_same_nonzero_pattern(eye)
    assert not jsmm.csr_from_dense(DENSE).has_same_nonzero_pattern(jsmm.csr_from_dense(np.eye(4)))


def test_transpose_and_coo(sample):
    j, t = sample
    _same(t.transpose(), j.transpose())
    np.testing.assert_array_equal(t.transpose().to_dense().numpy(), DENSE.T)
    tc, jc = t.to_coo(), j.to_coo()
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    rect = np.arange(6.0).reshape(2, 3)
    _same(smm.csr_from_dense(rect, device="cpu").transpose(), jsmm.csr_from_dense(rect).transpose())


def test_densify_and_astype(sample):
    j, t = sample
    np.testing.assert_array_equal(t.to_dense().numpy(), np.asarray(j.to_dense()))
    _same(t.astype(np.float32), j.astype(np.float32))
    assert t.astype(torch.float32).dtype == torch.float32


def test_matmul_and_get_preconditioner(sample):
    j, t = sample
    x = np.arange(4.0)
    np.testing.assert_array_equal((t @ torch.from_numpy(x)).numpy(), DENSE @ x)
    full = DENSE + np.diag([0.0, 0.0, 6.0, 0.0])  # Jacobi needs every diagonal entry
    tp = smm.csr_from_dense(full, device="cpu").get_preconditioner("jacobi")
    jp = jsmm.csr_from_dense(full).get_preconditioner("jacobi")
    assert type(tp).__name__ == type(jp).__name__
    r = np.random.default_rng(0).standard_normal(4)
    np.testing.assert_array_equal(tp.apply(torch.from_numpy(r)).numpy(),
                                  np.asarray(jp.apply(jnp.asarray(r))))


def _sequential_row_sums(vals, row_nnz):
    """Each row's run of ``vals`` (``(nnz,)`` or ``(nnz, k)``) added one entry
    at a time from 0, in the entries' order, in their dtype."""
    out = np.zeros((row_nnz.size,) + vals.shape[1:], vals.dtype)
    for i, (lo, m) in enumerate(zip(np.cumsum(row_nnz) - row_nnz, row_nnz)):
        acc = np.zeros(vals.shape[1:], vals.dtype)
        for v in vals[lo:lo + m]:
            acc = (acc + v).astype(vals.dtype)
        out[i] = acc
    return out


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("cols", [None, 3])
def test_row_sum_is_sequential(dt, cols):
    """ops/spmv.py:row_sum, the CSR, HYB-remainder, strict-triangular and
    distributed shard products' sum by row, adds each row in the entries'
    order, bit for bit a sequential NumPy sum, with empty rows (0) and for a
    2-D panel; so does the CSR product over it."""
    from sparse_matrix_math_tpu_torch.ops.spmv import row_sum

    rng = np.random.default_rng(11)
    row_nnz = rng.integers(0, 9, 150)
    row_nnz[::13] = 0
    row_nnz[-1] = 0
    nnz = int(row_nnz.sum())
    shape = (nnz,) if cols is None else (nnz, cols)
    vals = (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-6, 7, shape)).astype(dt)
    ptr = np.concatenate([[0], np.cumsum(row_nnz)])
    got = row_sum(torch.from_numpy(vals), torch.from_numpy(ptr)).numpy()
    want = _sequential_row_sums(vals, row_nnz)
    assert got.shape == want.shape and np.array_equal(got, want)

    # the CSR product: the products of each row, summed in column order
    indices = np.concatenate([np.sort(rng.choice(40, m, replace=False)) for m in row_nnz])
    a = csr_from_numpy(ptr, indices, vals if cols is None else vals[:, 0],
                                   (150, 40), "cpu")
    x = rng.standard_normal((40,) if cols is None else (40, cols)).astype(dt)
    prods = (a.data.numpy()[:, None] if cols else a.data.numpy()) * x[indices]
    y = (a @ torch.from_numpy(x)).numpy()
    assert np.array_equal(y, _sequential_row_sums(prods.astype(dt), row_nnz))


def test_csr_from_numpy_checks_indptr():
    """The product sums by ``indptr`` unchecked, so the one constructor that
    takes a caller's arrays checks them."""
    with pytest.raises(ValueError):
        csr_from_numpy([0, 2, 1], [0, 1], [1.0, 2.0], (2, 2), "cpu")
    with pytest.raises(ValueError):
        csr_from_numpy([0, 1, 3], [0, 1], [1.0, 2.0], (2, 2), "cpu")
