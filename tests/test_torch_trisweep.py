"""The port's fused triangular-sweep applies (ops/trisweep.py, PaddedSGS and
PaddedTriPair) held against the JAX package's fused Pallas kernels
(``sgs_apply_fused`` / ``tri_pair_apply_fused``) in interpret mode.

On the CPU the wrappers run the kernels' plain versions; the CUDA kernels
themselves are checked by tests/test_torch_cuda_kernels.py, which skips
without a card.  Factor values cross from the JAX objects through interop,
so an apply is held against JAX independently of the factorization.
Tolerances are the JAX tests' own: 1e-12 in f64 and 2e-5 in f32 (rtol and
atol), because the JAX kernel's shifted-window arithmetic may round
differently from the plain sweep order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
from sparse_matrix_math_tpu.formats.dia import DIAMatrix as JaxDIAMatrix
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.ops.pallas_trisweep import sgs_apply_fused as jax_sgs_fused
from sparse_matrix_math_tpu.ops.pallas_trisweep import (
    tri_pair_apply_fused as jax_tri_pair_fused,
)
from sparse_matrix_math_tpu.precond import PaddedSGS as JaxPaddedSGS
from sparse_matrix_math_tpu.precond import PaddedTriPair as JaxPaddedTriPair
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.dia import DIAMatrix
from sparse_matrix_math_tpu_torch.ops import dia_spmv as D
from sparse_matrix_math_tpu_torch.ops import trisweep as T
from sparse_matrix_math_tpu_torch.precond import FactorizationError, PaddedSGS, PaddedTriPair

TOL = {np.float32: 2e-5, np.float64: 1e-12}
SWEEPS = [1, 2, 4]
_ARRAYS = ("data", "indices", "row_ids", "diag", "dense")


def tri_fields(tri):
    """A JAX TriangularMatrix's fields as NumPy arrays and Python scalars."""
    out = {}
    for f in dataclasses.fields(tri):
        if f.name == "wsell":
            continue
        v = getattr(tri, f.name)
        out[f.name] = None if v is None else np.asarray(v) if f.name in _ARRAYS else v
    return out


def _poisson(nx, dtype):
    jcsr = jax_gen.poisson_2d(nx, dtype=dtype)
    jdia = jax_dia_from_csr(jcsr)
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    return jcsr, jdia, tdia


def _rhs(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _port_apply(pre, r):
    """The port's padded apply of ``r``: the logical result and the padded one."""
    rp = torch.zeros(pre.n_total, dtype=torch.from_numpy(r).dtype)
    rp[pre.lead:pre.lead + r.shape[0]] = torch.from_numpy(r)
    zp = pre.apply_padded(rp)
    return zp[pre.lead:pre.lead + r.shape[0]].numpy(), zp


def _assert_guards_zero(pre, zp):
    n = pre.shape[0]
    assert torch.all(zp[:pre.lead] == 0) and torch.all(zp[pre.lead + n:] == 0)


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("sweeps", SWEEPS)
def test_padded_sgs_matches_jax_fused(dtype, sweeps):
    _, jdia, tdia = _poisson(40, dtype)
    r = _rhs(tdia.shape[0], dtype)
    jp = JaxPaddedSGS.from_dia(jdia, sweeps=sweeps)
    ref = jp.p_lower
    want = np.asarray(ref.from_padded(jax_sgs_fused(jp, ref.to_padded(jnp.asarray(r)),
                                                    interpret=True)))
    tp = PaddedSGS.from_dia(tdia, sweeps=sweeps)
    got, zp = _port_apply(tp, r)
    _assert_close(got, want, dtype)
    _assert_guards_zero(tp, zp)
    # the 1-D apply pads, applies and unpads
    np.testing.assert_array_equal(tp.apply(torch.from_numpy(r)).numpy(), got)


@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_padded_tri_pair_matches_jax_fused(dtype, kind, sweeps):
    jcsr, jdia, tdia = _poisson(40, dtype)
    r = _rhs(tdia.shape[0], dtype, seed=1)
    jpre = jsmm.get_preconditioner(jcsr, kind, method="jacobi", sweeps=sweeps)
    jpair = JaxPaddedTriPair.from_factors(jpre.lower, jpre.upper, jdia)
    ref = jpair.p_lower
    want = np.asarray(ref.from_padded(jax_tri_pair_fused(jpair, ref.to_padded(jnp.asarray(r)),
                                                         interpret=True)))
    if kind == "ic0":
        tpre = interop.ic0_from_numpy(tri_fields(jpre.lower), tri_fields(jpre.upper), "cpu")
    else:
        tpre = interop.ilu0_from_numpy(tri_fields(jpre.lower), tri_fields(jpre.upper),
                                       jpre.shift, "cpu")
    pair = PaddedTriPair.from_factors(tpre.lower, tpre.upper, tdia)
    assert pair.sweeps == sweeps
    got, zp = _port_apply(pair, r)
    _assert_close(got, want, dtype)
    _assert_guards_zero(pair, zp)
    # the padded apply is the generic two-solve apply in another layout
    _assert_close(got, tpre.apply(torch.from_numpy(r)).numpy(), dtype)


@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0)], ids=["upper_only", "lower_only"])
def test_one_sided_matrix_matches_jax(offsets):
    """A DIA matrix with a strict part on one side only: its padded layout
    still has a leading guard block (the JAX package's regression at
    tests/test_precond.py:354-383), and the empty side is a diagonal scale."""
    n = 3000
    rng = np.random.default_rng(0)
    main = rng.uniform(2.0, 3.0, n)
    off = rng.uniform(-1.0, -0.5, n)
    diags = np.stack([main, off] if offsets[0] == 0 else [off, main]).astype(np.float32)
    jdia = JaxDIAMatrix(diags=jnp.asarray(diags), offsets=offsets, shape=(n, n), nnz=2 * n - 1)
    tdia = interop.dia_from_numpy(diags, offsets, (n, n), 2 * n - 1, "cpu")
    r = rng.standard_normal(n).astype(np.float32)
    jp = JaxPaddedSGS.from_dia(jdia, sweeps=4)
    ref = jp.p_upper if offsets[0] == 0 else jp.p_lower
    want = np.asarray(ref.from_padded(jax_sgs_fused(jp, ref.to_padded(jnp.asarray(r)),
                                                    interpret=True)))
    tp = PaddedSGS.from_dia(tdia, sweeps=4)
    assert tp.lead >= 128
    got, zp = _port_apply(tp, r)
    _assert_close(got, want, np.float32)
    _assert_guards_zero(tp, zp)


def test_pure_diagonal_is_a_scale():
    n = 300
    d = np.random.default_rng(2).uniform(1.0, 2.0, n)
    tdia = interop.dia_from_numpy(d[None], (0,), (n, n), n, "cpu")
    tp = PaddedSGS.from_dia(tdia, sweeps=3)
    assert tp.p_lower is None and tp.p_upper is None
    r = _rhs(n, np.float64)
    got, zp = _port_apply(tp, r)
    np.testing.assert_allclose(got, r / d, rtol=1e-15, atol=0)
    _assert_guards_zero(tp, zp)


def test_factors_share_the_matrix_layout():
    """pad_dia with geometry_offsets gives a strict factor the full matrix's
    lblk, nblk and n_total; an offset outside the geometry raises."""
    n, offsets = 1000, (-300, -1, 0, 1, 300)
    diags = np.random.default_rng(3).uniform(0.5, 1.0, (len(offsets), n))
    diags[2] += 4.0
    tdia = interop.dia_from_numpy(diags, offsets, (n, n), 0, "cpu")
    full = D.pad_dia(tdia)
    for keep in ([0, 1], [3, 4]):  # strict lower, strict upper
        sub = DIAMatrix(diags=tdia.diags[keep], offsets=tuple(offsets[i] for i in keep),
                        shape=tdia.shape, nnz=0)
        p = D.pad_dia(sub, geometry_offsets=offsets)
        assert (p.lblk, p.nblk, p.n_total) == (full.lblk, full.nblk, full.n_total)
        own = D.pad_dia(sub)
        # alone, each part guards only its own side
        assert (own.lblk, own.n_total) != (full.lblk, full.n_total)
    with pytest.raises(ValueError):
        D.pad_dia(tdia, geometry_offsets=(-1, 0, 1))
    tp = PaddedSGS.from_dia(tdia, sweeps=2)
    assert (tp.lead, tp.n_total) == (full.lead, full.n_total)
    assert (tp.p_lower.n_total, tp.p_upper.n_total) == (full.n_total, full.n_total)


def test_cpu_apply_runs_plain_and_counts_nothing():
    _, _, tdia = _poisson(12, np.float32)
    tp = PaddedSGS.from_dia(tdia, sweeps=2)
    rp = tp.p_lower.to_padded(torch.ones(tdia.shape[0]))
    before = dict(T.launches)
    z = T.sgs_apply_fused(tp, rp)
    assert T.launches == before
    assert torch.equal(z, T.sgs_apply_plain(tp, rp))


def test_wrappers_check_their_inputs():
    _, _, tdia = _poisson(8, np.float64)
    tp = PaddedSGS.from_dia(tdia, sweeps=2)
    rp = torch.zeros(tp.n_total, dtype=torch.float64)
    with pytest.raises(TypeError):
        T.sgs_apply_fused(tp, rp.float())
    with pytest.raises(ValueError):
        T.sgs_apply_fused(tp, rp[:-1])
    with pytest.raises(ValueError):
        T.sgs_apply_fused(dataclasses.replace(tp, sweeps=0), rp)


def test_from_dia_validates():
    _, jdia, tdia = _poisson(8, np.float64)
    for make in (lambda: PaddedSGS.from_dia(tdia, sweeps=0),
                 lambda: JaxPaddedSGS.from_dia(jdia, sweeps=0)):
        with pytest.raises(ValueError):
            make()
    no_main = DIAMatrix(diags=tdia.diags[[0, 1]], offsets=tdia.offsets[:2], shape=tdia.shape,
                        nnz=tdia.nnz)
    with pytest.raises(FactorizationError):
        PaddedSGS.from_dia(no_main)
    tiny = DIAMatrix(diags=tdia.diags * 1e-7, offsets=tdia.offsets, shape=tdia.shape,
                     nnz=tdia.nnz)
    with pytest.raises(FactorizationError):
        PaddedSGS.from_dia(tiny)
