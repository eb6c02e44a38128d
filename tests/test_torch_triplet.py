"""The port's triplet assembly (``TripletMatrix``, ``COOArrays``) held against
the JAX package: the cases of tests/test_triplet.py, each put to both
packages with the same entries.  Assembly is exact on both sides (Python
floats, the same NumPy sort and sum), so values are compared for equality.
"""

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm

TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}


def _both(rows, cols, entries=()):
    """The same TripletMatrix in both packages after the same add_entry calls."""
    j, t = jsmm.TripletMatrix(rows, cols), smm.TripletMatrix(rows, cols)
    for r, c, v in entries:
        j.add_entry(r, c, v)
        t.add_entry(r, c, v)
    return j, t


def _same_dense(t, j, dtype=None):
    tdense = t.to_dense(dtype, device="cpu")
    assert isinstance(tdense, torch.Tensor) and tdense.shape == j.shape
    np.testing.assert_array_equal(tdense.numpy(), j.to_dense(dtype))


def test_empty_construction():
    j, t = _both(4, 5)
    assert t.shape == j.shape == (4, 5)
    assert t.nnz == j.nnz == 0
    assert list(t) == list(j) == []
    assert (t.dense_row_count, t.dense_col_count) == (4, 5)
    _same_dense(t, j)


def test_add_entry_accumulates_duplicates():
    """addEntry sums duplicates (reference h:607-618)."""
    j, t = _both(3, 3, [(1, 2, 1.5), (1, 2, 2.5), (0, 0, -1.0), (1, 2, 0.1)])
    assert t.nnz == j.nnz == 2
    assert t.get_value(1, 2) == j.get_value(1, 2)
    assert t.get_value(0, 0) == j.get_value(0, 0) == -1.0


def test_get_value_missing_is_zero():
    j, t = _both(2, 2, [(1, 1, 3.0)])
    assert t.get_value(0, 1) == j.get_value(0, 1) == 0.0


def test_update_entry_only_existing():
    """updateEntry only touches present entries (h:621-632)."""
    j, t = _both(2, 2)
    assert t.update_entry(0, 0, 5.0) is j.update_entry(0, 0, 5.0) is False
    for m in (j, t):
        m.add_entry(0, 0, 1.0)
    assert t.update_entry(0, 0, 5.0) is j.update_entry(0, 0, 5.0) is True
    assert t.get_value(0, 0) == j.get_value(0, 0) == 5.0


def test_iteration_row_major_order():
    j, t = _both(3, 3, [(2, 0, 1.0), (0, 1, 2.0), (0, 0, 3.0), (1, 2, 4.0)])
    assert list(t) == list(j)
    assert [(r, c) for r, c, _ in t] == [(0, 0), (0, 1), (1, 2), (2, 0)]


@pytest.mark.parametrize("row,col", [(2, 0), (0, -1), (0, 2)])
def test_out_of_bounds_raises(row, col):
    j, t = _both(2, 2)
    for m in (j, t):
        with pytest.raises(IndexError):
            m.add_entry(row, col, 1.0)


def test_scale_and_reinit():
    j, t = _both(2, 2, [(0, 0, 2.0), (1, 1, 3.0)])
    j *= 2.0
    t *= 2.0
    assert list(t) == list(j) == [(0, 0, 4.0), (1, 1, 6.0)]
    for m in (j, t):
        m.init(3, 4)
    assert t.shape == j.shape == (3, 4) and t.nnz == j.nnz == 0
    for m in (j, t):
        m.deinit()
    assert t.shape == j.shape == (0, 0)


def test_to_dense(dtype):
    j, t = _both(2, 3, [(0, 1, 7.0), (1, 2, -2.0), (0, 0, 0.1)])
    _same_dense(t, j, dtype)
    assert t.to_dense(TORCH_DTYPE[dtype], device="cpu").dtype == TORCH_DTYPE[dtype]


def test_exports_match(dtype):
    """to_host_coo, to_coo and csr_from_triplet: the same sorted arrays and
    values in both packages; the port's tensors on the device it is given."""
    rng = np.random.default_rng(4)
    entries = [(int(r), int(c), float(v)) for r, c, v in
               zip(rng.integers(0, 6, 40), rng.integers(0, 5, 40), rng.standard_normal(40))]
    j, t = _both(6, 5, entries)
    for a, b in zip(t.to_host_coo(dtype)[:3], j.to_host_coo(dtype)[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype.kind == b.dtype.kind
    tcoo, jcoo = t.to_coo(dtype, device="cpu"), j.to_coo(dtype=dtype)
    assert tcoo.shape == jcoo.shape and tcoo.vals.dtype == TORCH_DTYPE[dtype]
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tcoo, f).numpy(), np.asarray(getattr(jcoo, f)))
    tcsr, jcsr = smm.csr_from_triplet(t, dtype, device="cpu"), jsmm.csr_from_triplet(j, dtype)
    for f in ("indptr", "indices", "row_ids", "data"):
        np.testing.assert_array_equal(getattr(tcsr, f).numpy(), np.asarray(getattr(jcsr, f)))
    with pytest.raises(TypeError, match="device"):
        smm.csr_from_triplet(t)


def test_coo_from_arrays_sums_duplicates_and_sorts():
    args = dict(rows=[2, 0, 2, 0], cols=[1, 2, 1, 2], vals=[1.0, 3.0, 4.0, -1.0], shape=(3, 3))
    tcoo, jcoo = smm.coo_from_arrays(**args, device="cpu"), jsmm.coo_from_arrays(**args)
    assert tcoo.nnz == jcoo.nnz == 2
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(tcoo, f).numpy(), np.asarray(getattr(jcoo, f)))
    np.testing.assert_array_equal(tcoo.vals.numpy(), [2.0, 5.0])


def test_coo_out_of_range_raises():
    with pytest.raises(ValueError):
        jsmm.coo_from_arrays([0], [5], [1.0], shape=(2, 2))
    with pytest.raises(ValueError):
        smm.coo_from_arrays([0], [5], [1.0], shape=(2, 2), device="cpu")


def test_coo_scale_and_dense():
    tcoo = smm.coo_from_arrays([0, 1], [1, 0], [2.0, 3.0], shape=(2, 2), device="cpu")
    jcoo = jsmm.coo_from_arrays([0, 1], [1, 0], [2.0, 3.0], shape=(2, 2))
    np.testing.assert_array_equal(tcoo.scale(2.0).to_dense().numpy(),
                                  np.asarray(jcoo.scale(2.0).to_dense()))
    np.testing.assert_array_equal(tcoo.to_dense().numpy(), [[0, 2], [3, 0]])
