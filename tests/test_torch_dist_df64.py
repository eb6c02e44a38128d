"""The port's distributed double-word f64 (sparse_matrix_math_tpu_torch/parallel/dist_df64.py)
on gloo CPU worlds of 1, 2 and 4 ranks, held against the JAX package's on
meshes of as many of the conftest's virtual devices and against host f64:
twin of tests/test_dist_df64.py, at its sizes (``_df_dia_host`` at 24, 48,
32 and 8).

The rank-side cases are in tests/torch_dist_ranks.py.  Bounds: the
double-word product within relative 1e-12 of the host f64 product (JAX's
own bound); the refinement solves JAX's status, a true residual under
1e-9, the same rounds within 1 and inner iterations within max(3, 5%) of
JAX's (the bands of tests/test_torch_df64_solvers.py).
"""

import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)
from jax.sharding import PartitionSpec as P

from sparse_matrix_math_tpu import SolverStatus, cg_ir_df64
from sparse_matrix_math_tpu.parallel import (
    dist_bicgstab_ir_df64,
    dist_cg_ir_df64,
    dist_df_dia_spmv,
    distribute_df_dia,
    make_mesh,
    put_sharded,
)
from test_dist_df64 import _csr_mv, _df_dia_host
from torch_dist_check import WORLDS, band, ok, raised, run_port
from torch_dist_ranks import CASES

NAMES = [n for n in CASES if n.startswith("df_")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, NAMES)


def _jax_spmv(dfa, x64, k):
    mesh = make_mesh(k)
    dist = distribute_df_dia(dfa, mesh)
    n = dfa.shape[0]
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    pad = np.zeros(dist.padded_rows - n, np.float32)
    x_sh = tuple(put_sharded(np.concatenate([w, pad]), mesh, P(dist.axis)) for w in (hi, lo))
    yh, yl = dist_df_dia_spmv(dist, x_sh, mesh)
    return np.asarray(yh, np.float64)[:n] + np.asarray(yl, np.float64)[:n]


@pytest.mark.parametrize("k", WORLDS)
def test_df_spmv_matches_host_f64(port, k):
    dfa, data, indices, indptr = _df_dia_host(24)
    x64 = np.random.default_rng(0).standard_normal(dfa.shape[0])
    got = ok(port, k, "df_spmv")
    y = got["hi"].astype(np.float64) + got["lo"].astype(np.float64)
    hi = x64.astype(np.float32)
    x48 = hi.astype(np.float64) + (x64 - hi.astype(np.float64)).astype(np.float32)
    want = _csr_mv(data, indices, indptr, x48)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(y - want)) / scale < 1e-12
    assert np.max(np.abs(y - _jax_spmv(dfa, x64, k))) / scale < 1e-12
    assert got["block_rows"] == distribute_df_dia(dfa, make_mesh(k)).block_rows


def _check_refinement(got, jres, band_its):
    assert got["status"] == int(jres.status), (got["status"], jres)
    assert abs(got["outer_rounds"] - int(jres.outer_rounds)) <= 1
    its = int(jres.iterations)
    assert abs(got["iterations"] - its) <= band_its(its), (got["iterations"], its)


@pytest.mark.parametrize("k", WORLDS)
def test_dist_cg_ir_df64_poisson_1e10(port, k):
    dfa, data, indices, indptr = _df_dia_host(48)
    n = dfa.shape[0]
    x_true = np.random.default_rng(1).standard_normal(n)
    b = _csr_mv(data, indices, indptr, x_true)
    jres = dist_cg_ir_df64(distribute_df_dia(dfa, make_mesh(k)), b, epsilon=1e-10)
    got = ok(port, k, "df_cg_ir")
    _check_refinement(got, jres, lambda its: band(its, 0.05, 3))
    assert got["status"] == SolverStatus.SUCCESS
    x = got["x"]
    assert np.linalg.norm(b - _csr_mv(data, indices, indptr, x)) < 1e-9
    assert np.linalg.norm(x - x_true) / np.linalg.norm(x_true) < 1e-10
    # the outcome of the single-device refinement, in both packages
    single = got["single"]
    assert single["status"] == SolverStatus.SUCCESS
    assert np.linalg.norm(x - single["x"]) / np.linalg.norm(single["x"]) < 1e-8
    js = cg_ir_df64(dfa, b, epsilon=1e-10)
    assert np.linalg.norm(x - js.x_f64()) / np.linalg.norm(js.x_f64()) < 1e-8


@pytest.mark.parametrize("k", WORLDS)
def test_dist_bicgstab_ir_df64_nonsym(port, k):
    dfa, data, indices, indptr = _df_dia_host(32, drift=1e-2)
    x_true = np.random.default_rng(2).standard_normal(dfa.shape[0])
    b = _csr_mv(data, indices, indptr, x_true)
    jres = dist_bicgstab_ir_df64(distribute_df_dia(dfa, make_mesh(k)), b, epsilon=1e-9)
    got = ok(port, k, "df_bicgstab_ir")
    _check_refinement(got, jres, lambda its: band(its, 0.05, 3))
    assert got["status"] == SolverStatus.SUCCESS
    assert np.linalg.norm(b - _csr_mv(data, indices, indptr, got["x"])) < 1e-9


@pytest.mark.parametrize("k", WORLDS)
def test_dist_ir_df64_status_paths(port, k):
    got = ok(port, k, "df_status_paths")
    assert got["capped"] == SolverStatus.MAX_ITERATIONS_REACHED
    # x0 at the exact solution: no work
    assert got["resumed"] == (SolverStatus.SUCCESS, 0, 0)
    err = raised(port, k, "df_tiny_epsilon")
    assert err is not None and err[0] == "ValueError", err
    dfa, *_ = _df_dia_host(8)
    with pytest.raises(ValueError):
        dist_cg_ir_df64(distribute_df_dia(dfa, make_mesh(k)), np.ones(dfa.shape[0]),
                        epsilon=1e-20)


@pytest.mark.parametrize("k", WORLDS)
def test_distribute_df_dia_rejects_wide_band(port, k):
    """|offset| 40 against blocks of 64 / 32 / 16 rows: JAX refuses at 2 and
    4 devices, and the port raises the same ValueError there."""
    from sparse_matrix_math_tpu.ops.df32 import DfDiaMatrix

    n = 64
    data = np.ones(2 * n - 40, np.float64)
    rows = np.concatenate([np.arange(n), np.arange(n - 40)])
    cols = np.concatenate([np.arange(n), np.arange(40, n)])
    order = np.lexsort((cols, rows))
    indptr = np.cumsum(np.concatenate([[0], np.bincount(rows, minlength=n)]))
    dfa = DfDiaMatrix.from_host_csr(data[order], cols[order], indptr, (n, n))
    try:
        distribute_df_dia(dfa, make_mesh(k))
        jax_err = None
    except ValueError as e:
        jax_err = type(e).__name__
    err = raised(port, k, "df_wide_band")
    assert (err[0] if err else None) == jax_err
    assert (jax_err is None) == (k == 1)
