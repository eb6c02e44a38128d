"""The port's differentiable ``cg_solve`` (solvers/implicit.py) held against
the JAX package's ``custom_vjp``.

Forward: x equal to JAX's within 1e-10.  Backward (one adjoint CG solve):
the gradient of b and of the matrix's values (``a.data`` for CSR,
``a.diags`` for DIA, where JAX returns a ``CSRMatrix``/``DIAMatrix``
cotangent) within 1e-8 of ``jax.vjp``'s in f64, and
``torch.autograd.gradcheck`` on a 16-row system.  Any other format solves
forward and raises the JAX package's ``TypeError`` in the backward pass.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.solvers.implicit import cg_solve as jax_cg_solve
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from test_torch_wsell import port_csr


def pair(fmt, n=6, ny=None):
    jcsr = jax_gen.poisson_2d(n, ny, dtype=np.float64)
    if fmt == "csr":
        return jcsr, port_csr(jcsr)
    jdia = jsmm.dia_from_csr(jcsr)
    return jdia, interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                        jdia.nnz, "cpu")


def values_of(m):
    return m.data if hasattr(m, "indptr") else m.diags


def with_values(m, v):
    return dataclasses.replace(m, **{"data" if hasattr(m, "indptr") else "diags": v})


@pytest.mark.parametrize("fmt", ["csr", "dia"])
@pytest.mark.parametrize("n,ny", [(6, None), (7, 5)])
def test_cg_solve_grads_match_jax_vjp(fmt, n, ny):
    ja, ta = pair(fmt, n, ny)
    rows = ja.shape[0]
    rng = np.random.default_rng(0)
    b, g = rng.standard_normal(rows), rng.standard_normal(rows)
    jx, vjp = jax.vjp(lambda a_, b_: jax_cg_solve(a_, b_, 1e-12), ja, jnp.asarray(b))
    ja_bar, jb_bar = vjp(jnp.asarray(g))

    vals = values_of(ta).clone().requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    tx = smm.cg_solve(with_values(ta, vals), tb, 1e-12)
    np.testing.assert_allclose(tx.detach().numpy(), np.asarray(jx), rtol=0, atol=1e-10)
    tx.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jb_bar), rtol=0, atol=1e-8)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(values_of(ja_bar)), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("fmt", ["csr", "dia"])
def test_cg_solve_gradcheck(fmt):
    _, ta = pair(fmt, 4)  # 16 rows
    vals = values_of(ta).clone().requires_grad_(True)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(16)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda v, b_: smm.cg_solve(with_values(ta, v), b_, 1e-13),
                                    (vals, b), eps=1e-6, atol=1e-5)


def test_cg_solve_other_formats_raise_in_backward():
    """An ELL matrix solves forward; its backward raises the JAX package's
    TypeError (as JAX's does)."""
    jcsr, tcsr = pair("csr")
    b = np.random.default_rng(2).standard_normal(36)
    jell = jsmm.ell_from_csr(jcsr)
    with pytest.raises(TypeError, match="CSR/DIA"):
        jax.grad(lambda b_: jnp.sum(jax_cg_solve(jell, b_, 1e-12)))(jnp.asarray(b))
    tb = torch.from_numpy(b).requires_grad_(True)
    x = smm.cg_solve(smm.ell_from_csr(tcsr), tb, 1e-12)
    np.testing.assert_allclose(x.detach().numpy(),
                               np.asarray(jax_cg_solve(jcsr, jnp.asarray(b), 1e-12)),
                               rtol=0, atol=1e-10)
    with pytest.raises(TypeError, match="CSR/DIA"):
        x.sum().backward()
