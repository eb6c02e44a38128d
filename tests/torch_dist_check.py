"""Comparisons shared by the port's distributed tests (tests/test_torch_parallel.py,
tests/test_torch_dist_stencil.py): the port's rank-side payloads
(tests/torch_dist_ranks.py) against the JAX package's functions on a mesh of
as many of the conftest's virtual CPU devices, and against the port at one
rank.

Tolerances:

* products: max |y_port - y_jax| within 1e-12 (f64) or 64 * 2**-24 (f32)
  times max_i sum_j |a_ij x_j|, the size of the terms being summed;
* solves: the same status; iteration counts within the band each test
  names; a SUCCESS's true residual r = b - A x (float64, on the host) at
  most the solve's epsilon plus 4 roundings of |A||x| + |b|.  These are
  what hold the port to JAX.  ``check_x`` adds x within ||A^-1||_2
  (||r_port|| + ||r_jax||), which is an identity, not a parity check: for
  any two vectors x - x' = A^-1 (r' - r), so it holds whatever x is, and
  only checks that the payload's x is a vector of the system's length.
  A tighter bound on x - x' does not hold for every solve here: at equal
  iteration counts some stencil solves' iterates move by several times
  its * cond(A) * eps * ||x|| between two summation orders.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import torch_dist_ranks as ranks
from sparse_matrix_math_tpu_torch import native
from torch_layout_code import jax_native_loaded

WORLDS = (1, 2, 4)


def run_port(tmp_path_factory, names):
    """Every case of ``names`` at each world size: {k: [rank payloads]}."""
    numpy_layouts = native.available() != jax_native_loaded()
    return {k: ranks.run_world(k, names, str(tmp_path_factory.mktemp(f"world{k}")),
                               numpy_layouts)
            for k in WORLDS}


def _same(u, v) -> bool:
    if isinstance(u, dict):
        return u.keys() == v.keys() and all(_same(u[k], v[k]) for k in u)
    if isinstance(u, (tuple, list)):
        return len(u) == len(v) and all(_same(a, b) for a, b in zip(u, v))
    if isinstance(u, np.ndarray):
        return np.array_equal(u, v, equal_nan=True)
    return u == v


def payload(port, k, name):
    """The case's payload at world size ``k``, after checking that every
    rank that took part returned the same one (the ranks agreed on every
    branch and hold the same gathered vectors)."""
    outs = [r[name] for r in port[k]]
    outs = [o for o in outs if not (o[0] == "ok" and o[1] is None)] or [("ok", None)]
    for o in outs[1:]:
        assert _same(o[:3], outs[0][:3]), (name, k, o[:3], outs[0][:3])
    return outs[0]


def ok(port, k, name):
    out = payload(port, k, name)
    assert out[0] == "ok", out[3]
    return out[1]


def raised(port, k, name):
    """The (type name, message) a case raised on every rank, or None."""
    out = payload(port, k, name)
    return None if out[0] == "ok" else out[1:3]


def scipy_csr(jcsr):
    return sp.csr_matrix((np.asarray(jcsr.data, np.float64), np.asarray(jcsr.indices),
                          np.asarray(jcsr.indptr)), shape=jcsr.shape)


def product_tol(a_sp, x, dtype) -> float:
    scale = float((abs(a_sp) @ np.abs(np.asarray(x, np.float64))).max())
    return (1e-12 if np.dtype(dtype) == np.float64 else 64 * 2.0 ** -24) * scale


def check_product(y, y_ref, a_sp, x, dtype):
    err = float(np.abs(np.asarray(y, np.float64) - np.asarray(y_ref, np.float64)).max())
    tol = product_tol(a_sp, x, dtype)
    assert err <= tol, (err, tol)


@functools.lru_cache(maxsize=None)
def _inv_norm2(data, indices, indptr, n) -> float:
    a = sp.csr_matrix((np.frombuffer(data), np.frombuffer(indices, np.int64),
                       np.frombuffer(indptr, np.int64)), shape=(n, n))
    if n <= 2048:
        return 1.0 / float(np.linalg.svd(a.toarray(), compute_uv=False)[-1])
    lam = spla.eigsh((a.T @ a).tocsc(), k=1, sigma=0, which="LM", return_eigenvectors=False)
    return 1.0 / float(np.sqrt(lam[0]))


def inv_norm2(a_sp) -> float:
    """||A^-1||_2 = 1 / sigma_min(A)."""
    a = a_sp.tocsr()
    return _inv_norm2(a.data.astype(np.float64).tobytes(),
                      a.indices.astype(np.int64).tobytes(),
                      a.indptr.astype(np.int64).tobytes(), a.shape[0])


def residual(a_sp, b, x) -> float:
    return float(np.linalg.norm(np.asarray(b, np.float64)
                                - a_sp @ np.asarray(x, np.float64)))


def check_success(x, a_sp, b, eps: float):
    """A SUCCESS's x: its true residual, in float64 on the host, at most
    ``eps`` plus 4 roundings of x's dtype on |A||x| + |b|."""
    x = np.asarray(x)
    slack = 4 * np.finfo(x.dtype).eps * float(
        np.linalg.norm(abs(a_sp) @ np.abs(x.astype(np.float64)) + np.abs(b)))
    r = residual(a_sp, b, x)
    assert r <= eps + slack, (r, eps, slack)


def check_solve(got, jres, jx, a_sp, b, band: int, eps: float):
    """The port's solve payload against the JAX result ``jres`` (its
    collected x ``jx``): status, iterations within ``band``, a SUCCESS's
    true residual within ``eps``, x within the residuals' bound."""
    assert got["status"] == int(jres.status), (got["status"], int(jres.status))
    its = int(jres.iterations)
    assert abs(got["iterations"] - its) <= band, (got["iterations"], its, band)
    if got["status"] == 0:
        check_success(got["x"], a_sp, b, eps)
    check_x(got["x"], jx, a_sp, b)


def check_x(x, x_ref, a_sp, b):
    """The residuals' identity bound (see the module's docstring)."""
    bound = inv_norm2(a_sp) * (residual(a_sp, b, x) + residual(a_sp, b, x_ref))
    err = float(np.linalg.norm(np.asarray(x, np.float64) - np.asarray(x_ref, np.float64)))
    assert err <= bound, (err, bound)


def check_self(port, k, name, a_sp, b, band: int):
    """The port at ``k`` ranks against the port at one rank (the residual
    checks done against JAX)."""
    got, one = ok(port, k, name), ok(port, 1, name)
    assert got["status"] == one["status"]
    assert abs(got["iterations"] - one["iterations"]) <= band
    check_x(got["x"], one["x"], a_sp, b)


def band(its: int, frac: float, floor: int) -> int:
    """max(floor, frac of the iterations)."""
    return max(floor, int(np.ceil(frac * its)))
