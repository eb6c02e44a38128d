"""The port's DIA SpMV (sparse_matrix_math_tpu_torch/ops/dia_spmv.py) held
against the JAX package's Pallas kernels (interpret mode) and XLA path.

On the CPU the wrappers run the kernels' plain versions; the CUDA kernels
themselves are checked by tests/test_torch_cuda_kernels.py, which skips
without a card.  Tolerances: f64 1e-12 and f32 1e-5 absolute on O(1)..O(26) entries —
the port sums in the JAX kernel's order, so only the XLA CPU backend's
rounding (FMA contraction) can differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.ops import pallas_spmv as jax_pallas
from sparse_matrix_math_tpu.ops.spmv import dia_rmult_xla
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.dia import DIAMatrix
from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
from sparse_matrix_math_tpu_torch.ops.spmv import rmult

CASES = [
    ("laplace_1d", (301,)),
    ("poisson_2d", (7,)),
    ("poisson_2d", (37,)),
    ("poisson_3d", (6,)),
    ("poisson_3d_27pt", (5,)),
    ("convection_diffusion_2d", (9,)),
]
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _case(name, args, dtype, seed=0):
    """The JAX DIA matrix, its port twin (through interop) and one x."""
    jdia = jax_dia_from_csr(getattr(jax_gen, name)(*args, dtype=dtype))
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    x = np.random.default_rng(seed).standard_normal(jdia.shape[1]).astype(dtype)
    return jdia, tdia, x


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}{a}" for n, a in CASES])
def test_plain_matches_jax_dia_spmv(name, args, dtype):
    jdia, tdia, x = _case(name, args, dtype)
    ref = np.asarray(jax_pallas.dia_spmv(jdia, jnp.asarray(x), interpret=True))
    out = K.dia_spmv(tdia, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL[dtype])
    xla = np.asarray(dia_rmult_xla(jdia, jnp.asarray(x)))
    np.testing.assert_allclose(out.numpy(), xla, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}{a}" for n, a in CASES])
def test_padded_plain_matches_jax_padded(name, args, dtype):
    jdia, tdia, x = _case(name, args, dtype, seed=1)
    jp = jax_pallas.pad_dia(jdia, rows_blk=8)
    ref = jp.from_padded(jax_pallas.dia_spmv_padded(jp, jp.to_padded(jnp.asarray(x)),
                                                    interpret=True))
    p = K.pad_dia(tdia)
    yp = K.dia_spmv_padded(p, p.to_padded(torch.from_numpy(x)))
    np.testing.assert_allclose(p.from_padded(yp).numpy(), np.asarray(ref), rtol=0,
                               atol=TOL[dtype])
    # guard rows exactly zero: solver dots and later sweeps rely on it
    n = tdia.shape[0]
    assert yp.shape == (p.n_total,)
    assert torch.all(yp[:p.lead] == 0) and torch.all(yp[p.lead + n:] == 0)
    # the streamed name is the same padded product
    assert torch.equal(K.dia_spmv_streamed(p, p.to_padded(torch.from_numpy(x))), yp)


@pytest.mark.parametrize("offsets", [(0,), (2, 5), (-300, 0, 1), (-128, 128), (-129, 0, 129)])
def test_layout_guards_cover_every_read(offsets):
    """Leading guard >= -min(offsets) and never empty, trailing guard >=
    max(offsets): every read of an active row is in bounds."""
    n = 260
    diags = torch.ones((len(offsets), n), dtype=torch.float64)
    p = K.pad_dia(DIAMatrix(diags=diags, offsets=offsets, shape=(n, n), nnz=0))
    assert p.lead >= max(-min(offsets), 128) and p.lead % 128 == 0
    assert p.lead + n + max(max(offsets), 0) <= p.n_total
    assert p.n_total % 128 == 0


def test_rectangular_one_shot_matches_dense():
    rng = np.random.default_rng(3)
    shape, offsets = (40, 57), (-3, 0, 2, 20)
    diags = rng.standard_normal((len(offsets), shape[0]))
    dense = np.zeros(shape)
    for d, off in enumerate(offsets):
        for i in range(shape[0]):
            if 0 <= i + off < shape[1]:
                dense[i, i + off] = diags[d, i]
    a = interop.dia_from_numpy(diags, offsets, shape, 0, "cpu")
    x = rng.standard_normal(shape[1])
    np.testing.assert_allclose(K.dia_spmv(a, torch.from_numpy(x)).numpy(), dense @ x,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.to_dense().numpy(), dense, rtol=0, atol=0)


def test_rmult_promotes_and_handles_columns():
    jdia, tdia, x = _case("poisson_2d", (7,), np.float32)
    y64 = rmult(tdia, torch.from_numpy(x.astype(np.float64)))
    assert y64.dtype == torch.float64
    xs = np.stack([x, 2 * x], axis=1)
    ys = rmult(tdia, torch.from_numpy(xs))
    np.testing.assert_allclose(ys.numpy(), np.asarray(dia_rmult_xla(jdia, jnp.asarray(xs))),
                               rtol=0, atol=1e-5)


def test_wrappers_reject_bad_inputs():
    _, tdia, x = _case("poisson_2d", (7,), np.float64)
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError):
        K.dia_spmv(tdia, xt.to(torch.float32))  # dtype mismatch
    with pytest.raises(TypeError):
        K.dia_spmv(tdia.astype(torch.float16), xt.to(torch.float16))
    with pytest.raises(ValueError):
        K.dia_spmv(tdia, xt[:-1])  # shape
    with pytest.raises(ValueError):
        K.dia_spmv(tdia, torch.zeros(2 * xt.shape[0], dtype=torch.float64)[::2])
    p = K.pad_dia(tdia)
    with pytest.raises(ValueError):
        K.dia_spmv_padded(p, xt)  # an unpadded vector
    with pytest.raises(ValueError):
        K.pad_dia(DIAMatrix(diags=torch.zeros((0, 4)), offsets=(), shape=(4, 4), nnz=0))


def test_cpu_launches_nothing():
    _, tdia, x = _case("poisson_2d", (7,), np.float64)
    before = dict(K.launches)
    K.dia_spmv(tdia, torch.from_numpy(x))
    p = K.pad_dia(tdia)
    K.dia_spmv_padded(p, p.to_padded(torch.from_numpy(x)))
    assert K.launches == before
