"""Property-based tests (hypothesis) of the port: the twin of
tests/test_property.py.

Random sparse matrices and SPD systems made from a drawn seed with NumPy:
the port's formats round-trip and multiply as the dense matrix does; each of
the port's solvers (``cg``, ``pcg``, ``bicg_symmetric``, ``cgs``,
``bicgstab``, ``gmres``, ``cg_pipelined``, ``chebyshev`` with the exact
spectrum bounds) recovers the solution and returns the JAX package's status
on the same system; preconditioned solves keep the solution; a W-SELL layout
multiplies as its CSR does.  System sizes are drawn from a short list, so
the JAX package compiles each solver for a few shapes only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)
from hypothesis import given, settings
from hypothesis import strategies as st

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.ops.spmv import rmult

SOLVERS = ["cg", "pcg", "bicg_symmetric", "cgs", "bicgstab", "gmres", "cg_pipelined",
           "chebyshev"]


@st.composite
def sparse_dense_pair(draw, max_n=24):
    n = draw(st.integers(2, max_n))
    m = draw(st.integers(2, max_n))
    seed = draw(st.integers(0, 2**31 - 1))
    density = draw(st.floats(0.05, 0.6))
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, m))
    dense[rng.random((n, m)) > density] = 0.0
    return dense


@settings(max_examples=25, deadline=None)
@given(sparse_dense_pair())
def test_formats_roundtrip_and_spmv(dense):
    a = smm.csr_from_dense(dense, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(dense.shape[1]))
    y_ref = dense @ x.numpy()
    np.testing.assert_allclose(a.to_dense().numpy(), dense, atol=1e-12)
    np.testing.assert_allclose(rmult(a, x).numpy(), y_ref, atol=1e-10)
    e = smm.ell_from_csr(a)
    np.testing.assert_allclose(rmult(e, x).numpy(), y_ref, atol=1e-10)
    np.testing.assert_allclose(e.to_dense().numpy(), dense, atol=1e-12)
    np.testing.assert_allclose(rmult(smm.hyb_from_csr(a), x).numpy(), y_ref, atol=1e-10)
    try:
        d = smm.dia_from_csr(a)
    except ValueError:
        d = None  # too many diagonals
    if d is not None:
        np.testing.assert_allclose(rmult(d, x).numpy(), y_ref, atol=1e-10)
        np.testing.assert_allclose(d.to_dense().numpy(), dense, atol=1e-12)


@st.composite
def spd_system(draw, sizes=(6, 14)):
    n = draw(st.sampled_from(sizes))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    m[rng.random((n, n)) > 0.4] = 0.0
    dense = m @ m.T + n * np.eye(n)  # SPD, reasonably conditioned
    return dense, rng.standard_normal(n)


def _solve(pkg, name, a, b, dense, **kw):
    if name == "pcg":
        return pkg.cg(a, b, preconditioner=pkg.IdentityPreconditioner(), **kw)
    if name == "chebyshev":
        w = np.linalg.eigvalsh(dense)
        kw["eig_bounds"] = (float(w[0]), float(w[-1]))
    return getattr(pkg, name)(a, b, **kw)


@settings(max_examples=8, deadline=None)
@given(spd_system())
def test_solvers_recover_solution(sys_pair):
    dense, x_true = sys_pair
    n = dense.shape[0]
    # JAX gets the dense matrix: one compile per solver and size, where a CSR
    # of another nnz would compile again for every example
    ja, ta = jnp.asarray(dense), smm.csr_from_dense(dense, device="cpu")
    b = dense @ x_true
    kw = dict(epsilon=1e-10, max_iterations=10 * n)
    for name in SOLVERS:
        tres = _solve(smm, name, ta, torch.from_numpy(b), dense, **kw)
        jres = _solve(jsmm, name, ja, jnp.asarray(b), dense, **kw)
        assert tres.status == int(jres.status) == 0, name
        np.testing.assert_allclose(tres.x.numpy(), x_true, atol=1e-6, err_msg=name)


@settings(max_examples=10, deadline=None)
@given(spd_system(sizes=(5, 14)))
def test_preconditioners_preserve_solution(sys_pair):
    dense, x_true = sys_pair
    a = smm.csr_from_dense(dense, device="cpu")
    b = torch.from_numpy(dense @ x_true)
    for kind, solver in (("jacobi", smm.cg), ("sgs", smm.bicgstab), ("ic0", smm.cg),
                         ("ilu0", smm.bicgstab), ("ilu0", smm.gmres)):
        res = solver(a, b, epsilon=1e-10, max_iterations=10 * dense.shape[0],
                     preconditioner=smm.get_preconditioner(a, kind))
        assert res.status == 0, kind
        np.testing.assert_allclose(res.x.numpy(), x_true, atol=1e-6, err_msg=kind)


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=2, max_value=12), st.integers(min_value=0, max_value=2**31 - 1),
       st.floats(min_value=0.005, max_value=0.2))
def test_wsell_matches_csr_spmv(n_scale, seed, density):
    """A W-SELL layout multiplies as its CSR does, for random patterns of any
    density it accepts (a refusal is the documented answer for tile-sparse
    patterns)."""
    n = 40 * n_scale  # 80 .. 480: crosses slab and window boundaries
    rng = np.random.default_rng(seed)
    nnz_target = max(int(n * n * density), n)
    dense = np.zeros((n, n))
    dense[rng.integers(0, n, nnz_target), rng.integers(0, n, nnz_target)] = (
        rng.standard_normal(nnz_target))
    csr = smm.csr_from_dense(dense, device="cpu")
    try:
        ws = smm.wsell_from_csr(csr, max_slot_ratio=64.0)
    except ValueError:
        return  # pattern refused
    x = torch.from_numpy(rng.standard_normal(n))
    np.testing.assert_allclose(rmult(ws, x).numpy(), rmult(csr, x).numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("name", SOLVERS)
def test_solvers_zero_rhs(name):
    """b = 0: the JAX package's status, iteration count and NaN pattern of x
    (bicg_symmetric divides 0 by 0 in both)."""
    dense = np.diag(np.arange(1.0, 7.0))
    ja, ta = jsmm.csr_from_dense(dense), smm.csr_from_dense(dense, device="cpu")
    jres = _solve(jsmm, name, ja, jnp.zeros(6), dense, epsilon=1e-10)
    tres = _solve(smm, name, ta, torch.zeros(6, dtype=torch.float64), dense, epsilon=1e-10)
    assert tres.status == int(jres.status)
    assert tres.iterations == int(jres.iterations)
    assert np.array_equal(np.isnan(tres.x.numpy()), np.isnan(np.asarray(jres.x)))
