"""The port's distributed routed chain (sparse_matrix_math_tpu_torch/parallel/dist_rsell.py)
on gloo CPU worlds of 1, 2 and 4 ranks, held against the JAX package's on
meshes of as many of the conftest's virtual devices: twin of
tests/test_dist_rsell.py, at its size (n = 6144, 4 entries per row, so the
last of 4 ranks holds no rows).

The rank-side cases are in tests/torch_dist_ranks.py, the tolerances in
tests/torch_dist_check.py.  On the CPU the shard product is the plain
versions of K11 and K7.  Iteration bands (float32, eps 1e-4): BiCGStab and
GMRES within max(2, 10%) of JAX's count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

from sparse_matrix_math_tpu.ops.spmv import rmult
from sparse_matrix_math_tpu.parallel import (
    collect,
    dist_routed_solve,
    dist_routed_spmv,
    distribute_routed,
    distribute_vector,
    make_mesh,
)
from sparse_matrix_math_tpu.utils.generate import uniform_random_csr
from torch_dist_check import (
    WORLDS,
    band,
    check_product,
    check_success,
    ok,
    raised,
    run_port,
    scipy_csr,
)
from torch_dist_ranks import RSELL_N, CASES

NAMES = [n for n in CASES if n.startswith("rsell_")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, NAMES)


@pytest.fixture(scope="module")
def system():
    a = uniform_random_csr(RSELL_N, per_row=4, seed=7, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal(RSELL_N).astype(np.float32)
    return a, x


@pytest.mark.parametrize("k", WORLDS)
def test_spmv_matches_jax_and_csr(port, system, k):
    a, x = system
    mesh = make_mesh(k)
    da = distribute_routed(a, mesh, max_slot_ratio=99.0)
    want = collect(dist_routed_spmv(da, distribute_vector(x, da, mesh), mesh), da)
    got = ok(port, k, "rsell_spmv")
    assert got["n_shards"] == k and got["padded_rows"] == da.padded_rows
    assert got["n_passes"] == len(da.passes) and got["final_nway"] == da.final_nway
    assert got["slot_ratio"] == pytest.approx(da.slot_ratio, rel=1e-12)
    y = got["y_padded"][:RSELL_N]
    a_sp = scipy_csr(a)
    check_product(y, want, a_sp, x, np.float32)
    check_product(y, a_sp @ x.astype(np.float64), a_sp, x, np.float32)
    check_product(y, np.asarray(rmult(a, jnp.asarray(x))), a_sp, x, np.float32)
    # the padding rows past n come back exactly 0
    np.testing.assert_array_equal(got["y_padded"][RSELL_N:], 0.0)


def test_empty_shard_at_four_ranks(port):
    """n = 6144 over 4 ranks: blocks of 2048 rows, so rank 3 holds none; it
    builds an empty chain and its rows of the product are zeros."""
    got = ok(port, 4, "rsell_spmv")
    assert got["padded_rows"] == 4 * 2048
    assert got["shard_nnz"][3] == 0 and all(m > 0 for m in got["shard_nnz"][:3])
    np.testing.assert_array_equal(got["y_padded"][3 * 2048:], 0.0)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_solve_matches_jax(port, system, solver, k):
    a, _ = system
    mesh = make_mesh(k)
    b = np.asarray(rmult(a, jnp.ones(RSELL_N, jnp.float32)))
    da = distribute_routed(a, mesh, max_slot_ratio=99.0)
    jres = dist_routed_solve(da, b, epsilon=1e-4, solver=solver, mesh=mesh)
    case = f"rsell_solve_{solver}"
    got = ok(port, k, case)
    its = int(jres.iterations)
    b_its = band(its, 0.10, 2)
    assert got["status"] == int(jres.status) == 0
    assert abs(got["iterations"] - its) <= b_its, (got["iterations"], its, b_its)
    assert abs(got["iterations"] - ok(port, 1, case)["iterations"]) <= b_its
    # the true residual within eps, and x = 1 as JAX's test holds it (the
    # x bound of torch_dist_check.check_x needs sigma_min of this random
    # matrix, a 25 s eigensolve, and checks only the payload's length)
    check_success(got["x"], scipy_csr(a), b, 1e-4)
    np.testing.assert_allclose(got["x"], 1.0, atol=1e-3)
    np.testing.assert_allclose(collect(jres.x, da), 1.0, atol=1e-3)


@pytest.mark.parametrize("k", WORLDS)
def test_refusals_match_jax(port, system, k):
    """A rectangular matrix, a chain past the slot-ratio cap (every rank
    raises: the cap is on the global slot total) and an unknown solver raise
    the JAX package's ValueError."""
    from sparse_matrix_math_tpu.formats.csr import csr_from_dense

    mesh = make_mesh(k)
    with pytest.raises(ValueError):
        distribute_routed(csr_from_dense(np.ones((8, 4))), mesh)
    with pytest.raises(ValueError):
        distribute_routed(system[0], mesh, max_slot_ratio=1.0)
    with pytest.raises(ValueError):
        dist_routed_solve(distribute_routed(system[0], mesh, max_slot_ratio=99.0),
                          system[1], solver="chebyshev", mesh=mesh)
    for case in ("rsell_rectangular", "rsell_slot_cap", "rsell_unknown_solver"):
        assert raised(port, k, case)[0] == "ValueError", (case, raised(port, k, case))
