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
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.formats.dia import DIAMatrix as JaxDIAMatrix
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.ops.pallas_trisweep import sgs_apply_fused as jax_sgs_fused
from sparse_matrix_math_tpu.ops.pallas_trisweep import (
    tri_pair_apply_fused as jax_tri_pair_fused,
)
from sparse_matrix_math_tpu.precond import PaddedSGS as JaxPaddedSGS
from sparse_matrix_math_tpu.precond import PaddedTriPair as JaxPaddedTriPair
from sparse_matrix_math_tpu.utils import generate as jax_gen
from solvebench.operators import stencil
from sparse_matrix_math_tpu_torch import interop
from sparse_matrix_math_tpu_torch.formats.dia import DIAMatrix
from sparse_matrix_math_tpu_torch.ops import dia_spmv as D
from sparse_matrix_math_tpu_torch.ops import trisweep as T
from sparse_matrix_math_tpu_torch.parallel import dist_padded as DP
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


def _system(name, args, dtype):
    """A JAX generator's system: its CSR and DIA forms and the port's DIA."""
    jcsr = getattr(jax_gen, name)(*args, dtype=dtype)
    jdia = jax_dia_from_csr(jcsr)
    tdia = interop.dia_from_numpy(np.asarray(jdia.diags), jdia.offsets, jdia.shape,
                                  jdia.nnz, "cpu")
    return jcsr, jdia, tdia


def _poisson(nx, dtype):
    return _system("poisson_2d", (nx,), dtype)


def _rhs(n, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(dtype)


def _padded(pre, r):
    """``r`` lifted into the padded layout of ``pre``."""
    rp = torch.zeros(pre.n_total, dtype=torch.from_numpy(r).dtype)
    rp[pre.lead:pre.lead + r.shape[0]] = torch.from_numpy(r)
    return rp


def _port_apply(pre, r):
    """The port's padded apply of ``r``: the logical result and the padded one."""
    zp = pre.apply_padded(_padded(pre, r))
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
    rp = _padded(tp, np.ones(tdia.shape[0], np.float32))
    before = dict(T.launches), dict(T.variant_launches)
    z = T.sgs_apply_fused(tp, rp)
    assert (T.launches, T.variant_launches) == before
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


# -- the window kernels' decomposition (csrc/trisweep.cu window_kernel) ---------
# sgs_apply_windowed_plain / tri_pair_apply_windowed_plain replay the kernel's
# tiles, chunks, cones and rings on the CPU.  Small tiles and chunks give many
# windows, clipped first and last tiles and a tile edge at ``lead`` (128).

WINDOW_SYSTEMS = [("poisson_2d", (40,)), ("poisson_3d_27pt", (6,)),
                  ("convection_diffusion_2d", (24,))]
WINDOW_SWEEPS = [1, 2, 4, 5]
# (tile, chunk): tiles of 64-256 rows; 64 is shorter than every halo at sweeps >= 4
TILINGS = [(64, 32), (128, 64), (256, 64)]


def _hold_windowed(pre, rp, windowed, plain, want, dtype):
    """Every tiling bit for bit the plain version, guard rows 0, and the
    logical rows against the JAX kernel's ``want``."""
    ref = plain(pre, rp)
    for tile, chunk in TILINGS:
        got = windowed(pre, rp, tile, chunk)
        assert torch.equal(got, ref), (tile, chunk)
        _assert_guards_zero(pre, got)
    _assert_close(got[pre.lead:pre.lead + pre.shape[0]].numpy(), want, dtype)


@pytest.mark.parametrize("sweeps", WINDOW_SWEEPS)
@pytest.mark.parametrize("name,args", WINDOW_SYSTEMS, ids=[f"{n}{a}" for n, a in WINDOW_SYSTEMS])
def test_windowed_sgs_matches_plain_and_jax(dtype, name, args, sweeps):
    _, jdia, tdia = _system(name, args, dtype)
    r = _rhs(tdia.shape[0], dtype, seed=3)
    jp = JaxPaddedSGS.from_dia(jdia, sweeps=sweeps)
    ref = jp.p_lower
    want = np.asarray(ref.from_padded(jax_sgs_fused(jp, ref.to_padded(jnp.asarray(r)),
                                                    interpret=True)))
    tp = PaddedSGS.from_dia(tdia, sweeps=sweeps)
    _hold_windowed(tp, _padded(tp, r), T.sgs_apply_windowed_plain, T.sgs_apply_plain, want,
                   dtype)


PAIR_WINDOW_CASES = [("ic0", "poisson_2d", (40,)), ("ilu0", "poisson_2d", (40,)),
                     ("ic0", "poisson_3d_27pt", (6,)),
                     ("ilu0", "convection_diffusion_2d", (24,))]


@pytest.mark.parametrize("sweeps", WINDOW_SWEEPS)
@pytest.mark.parametrize("kind,name,args", PAIR_WINDOW_CASES,
                         ids=[f"{k}-{n}{a}" for k, n, a in PAIR_WINDOW_CASES])
def test_windowed_tri_pair_matches_plain_and_jax(dtype, kind, name, args, sweeps):
    jcsr, jdia, tdia = _system(name, args, dtype)
    r = _rhs(tdia.shape[0], dtype, seed=4)
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
    _hold_windowed(pair, _padded(pair, r), T.tri_pair_apply_windowed_plain,
                   T.tri_pair_apply_plain, want, dtype)


@pytest.mark.parametrize("sweeps", [1, 4])
@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0), (0,)],
                         ids=["upper_only", "lower_only", "diagonal"])
def test_windowed_one_sided_and_diagonal(offsets, sweeps):
    """An empty strict part is a scale in one level; the other side still
    walks its windows (the matrices of test_one_sided_matrix_matches_jax)."""
    n = 3000
    rng = np.random.default_rng(0)
    main = rng.uniform(2.0, 3.0, n)
    off = rng.uniform(-1.0, -0.5, n)
    rows = {0: main, 1: off, -1: off}
    diags = np.stack([rows[o] for o in offsets]).astype(np.float32)
    jdia = JaxDIAMatrix(diags=jnp.asarray(diags), offsets=offsets, shape=(n, n),
                        nnz=len(offsets) * n)
    tdia = interop.dia_from_numpy(diags, offsets, (n, n), len(offsets) * n, "cpu")
    r = rng.standard_normal(n).astype(np.float32)
    jp = JaxPaddedSGS.from_dia(jdia, sweeps=sweeps)
    ref = jp.p_lower or jp.p_upper
    if ref is None:
        want = r / main.astype(np.float32)
    else:
        want = np.asarray(ref.from_padded(jax_sgs_fused(jp, ref.to_padded(jnp.asarray(r)),
                                                        interpret=True)))
    tp = PaddedSGS.from_dia(tdia, sweeps=sweeps)
    _hold_windowed(tp, _padded(tp, r), T.sgs_apply_windowed_plain, T.sgs_apply_plain, want,
                   np.float32)


def test_window_shorter_than_the_halo_is_widened():
    """A tile shorter than the halo: the kernel's window still reaches the
    whole halo, (sweeps - 1) * reach rows, across the tiles below (above, in
    the backward direction), so the result is exact (on the card the rule
    takes the window kernels while the halo is under two tiles).  A tile
    that is not a whole number of chunks is refused, as the C entry
    refuses it."""
    _, _, tdia = _poisson(40, np.float64)
    tp = PaddedSGS.from_dia(tdia, sweeps=5)
    rp = _padded(tp, _rhs(tdia.shape[0], np.float64))
    halo = (tp.sweeps - 1) * 40
    assert halo > 64
    assert torch.equal(T.sgs_apply_windowed_plain(tp, rp, 64, 32), T.sgs_apply_plain(tp, rp))
    for tile, chunk in ((100, 32), (16, 32), (0, 32)):
        with pytest.raises(ValueError):
            T.sgs_apply_windowed_plain(tp, rp, tile, chunk)


def test_a_ring_one_chunk_short_reads_unwritten_rows(monkeypatch):
    """The rings start as NaN, so a ring too short for reach + chunk (a row
    overwritten before the next level has read it) shows in the result: the
    check that the replay would catch a kernel with a short ring."""
    _, _, tdia = _poisson(40, np.float64)
    tp = PaddedSGS.from_dia(tdia, sweeps=4)
    rp = _padded(tp, _rhs(tdia.shape[0], np.float64))
    ref = T.sgs_apply_plain(tp, rp)
    assert T.ring_rows(40, 32) == 96
    right = T.ring_rows
    monkeypatch.setattr(T, "ring_rows", lambda reach, chunk=T.CHUNK: right(reach, chunk) - chunk)
    assert not torch.equal(T.sgs_apply_windowed_plain(tp, rp, 128, 32), ref)


# -- the ring kernel's decomposition (csrc/trisweep.cu ring_kernel) -------------
# sgs_apply_ring_plain / tri_pair_apply_ring_plain replay the kernel's chunk
# tickets, rings, slot reuse and guard reads on the CPU.  Chunks of 32 and 64
# rows make the 3-D reach (144 rows at poisson_3d(12), 111 at
# poisson_3d_27pt(10)) span several chunks; rings sized for 0 and 3 CTAs in
# flight.

RING_SYSTEMS = [("poisson_3d", (12,)), ("poisson_3d_27pt", (10,))]
RING_PLANS = [(0, 32, 32), (3, 64, 32)]  # (grid, chunk_l, chunk_u)


def _hold_ring(pre, rp, replay, plain, want, dtype):
    """Every plan bit for bit the plain version, guard rows 0, and the
    logical rows against the JAX kernel's ``want``."""
    ref = plain(pre, rp)
    for grid, chunk_l, chunk_u in RING_PLANS:
        plan = T.ring_plan(pre, grid, chunk_l, chunk_u)
        assert plan.ring_rows % max(chunk_l, chunk_u) == 0
        got = replay(pre, rp, plan)
        assert torch.equal(got, ref), (grid, chunk_l, chunk_u)
        _assert_guards_zero(pre, got)
    _assert_close(got[pre.lead:pre.lead + pre.shape[0]].numpy(), want, dtype)


@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("kind", ["sgs", "ic0", "ilu0"])
@pytest.mark.parametrize("name,args", RING_SYSTEMS, ids=[f"{n}{a}" for n, a in RING_SYSTEMS])
def test_ring_replay_matches_plain_and_jax(dtype, name, args, kind, sweeps):
    jcsr, jdia, tdia = _system(name, args, dtype)
    r = _rhs(tdia.shape[0], dtype, seed=6)
    if kind == "sgs":
        jp = JaxPaddedSGS.from_dia(jdia, sweeps=sweeps)
        want = np.asarray(jp.p_lower.from_padded(
            jax_sgs_fused(jp, jp.p_lower.to_padded(jnp.asarray(r)), interpret=True)))
        pre = PaddedSGS.from_dia(tdia, sweeps=sweeps)
        fns = (T.sgs_apply_ring_plain, T.sgs_apply_plain)
    else:
        jpre = jsmm.get_preconditioner(jcsr, kind, method="jacobi", sweeps=sweeps)
        jpair = JaxPaddedTriPair.from_factors(jpre.lower, jpre.upper, jdia)
        want = np.asarray(jpair.p_lower.from_padded(
            jax_tri_pair_fused(jpair, jpair.p_lower.to_padded(jnp.asarray(r)), interpret=True)))
        if kind == "ic0":
            tpre = interop.ic0_from_numpy(tri_fields(jpre.lower), tri_fields(jpre.upper), "cpu")
        else:
            tpre = interop.ilu0_from_numpy(tri_fields(jpre.lower), tri_fields(jpre.upper),
                                           jpre.shift, "cpu")
        pre = PaddedTriPair.from_factors(tpre.lower, tpre.upper, tdia)
        fns = (T.tri_pair_apply_ring_plain, T.tri_pair_apply_plain)
    _hold_ring(pre, _padded(pre, r), *fns, want, dtype)


@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0), (0,)],
                         ids=["upper_only", "lower_only", "diagonal"])
def test_ring_replay_one_sided_and_diagonal(offsets):
    """An empty strict part is a scale in one level, with no ring; the other
    side still walks its chunks."""
    n = 3000
    rng = np.random.default_rng(0)
    rows = {0: rng.uniform(2.0, 3.0, n), 1: rng.uniform(-1.0, -0.5, n),
            -1: rng.uniform(-1.0, -0.5, n)}
    diags = np.stack([rows[o] for o in offsets]).astype(np.float32)
    tdia = interop.dia_from_numpy(diags, offsets, (n, n), len(offsets) * n, "cpu")
    tp = PaddedSGS.from_dia(tdia, sweeps=4)
    rp = _padded(tp, rng.standard_normal(n).astype(np.float32))
    plan = T.ring_plan(tp, 2, 32, 32)
    assert plan.ring_levels == (0 if offsets == (0,) else 3)
    assert torch.equal(T.sgs_apply_ring_plain(tp, rp, plan), T.sgs_apply_plain(tp, rp))


def test_a_ring_one_chunk_short_reads_nan(monkeypatch):
    """The rings start as NaN and a slot holding another chunk reads NaN, so
    a ring one chunk too short for the reach and a chunk (the least the C
    entry takes) shows in the result: the check that the replay would catch
    a kernel whose ring is too short or whose slot is reused too soon."""
    _, _, tdia = _system("poisson_3d", (12,), np.float64)
    tp = PaddedSGS.from_dia(tdia, sweeps=4)
    rp = _padded(tp, _rhs(tdia.shape[0], np.float64))
    ref = T.sgs_apply_plain(tp, rp)
    assert T.ring_chunks(144, 0, 32) == 6
    assert torch.equal(T.sgs_apply_ring_plain(tp, rp, T.ring_plan(tp, 0, 32, 32)), ref)
    right = T.ring_chunks
    monkeypatch.setattr(T, "ring_chunks",
                        lambda reach, grid, chunk=T.CHUNK: right(reach, grid, chunk) - 1)
    got = T.sgs_apply_ring_plain(tp, rp, T.ring_plan(tp, 0, 32, 32))
    rows = slice(tp.lead, tp.lead + tp.shape[0])
    assert bool(torch.isnan(got[rows]).any())


def test_wrong_sign_offsets_keep_the_per_sweep_kernels():
    """Strict offsets on the wrong side for their direction (U's in the
    forward one): neither ordered walk takes them, so the rule names the
    per-sweep kernels, and the window tile is 0."""
    offsets = _stencil_offsets(243, 3, 7)
    n_total = (-(-max(offsets) // 128) * 2 + -(-243 ** 3 // 128)) * 128
    for sgs in (True, False):
        right = _Layout(offsets, n_total, 4, sgs)
        wrong = _Layout(offsets, n_total, 4, sgs)
        wrong.p_lower, wrong.p_upper = right.p_upper, right.p_lower
        assert T.variant_of(right, 132, 4) == "ring"
        assert T.variant_of(wrong, 132, 4) == "per-sweep"
        assert T.window_tile(wrong, 132, 4) == 0


class _Factor:
    def __init__(self, offsets):
        self.offsets = tuple(offsets)


def _scalar_factor(offsets, n_total):
    """A ScalarFactor's fields the rule reads; its values are never read."""
    offsets = tuple(offsets)
    return T.ScalarFactor(offsets=offsets, coefs=(-1.0,) * len(offsets),
                          const_diag=(26.0, 1.0 / 26.0), nx=0, ny=0,
                          row0=0, n_global=1, shape=(1, 1), lead=0, n_total=n_total,
                          dtype=torch.float64, device=torch.device("cpu"))


class _Layout:
    """The fields window_tile reads, for a full-size layout without its data
    (``scalar``: an SGS of a constant-coefficient stencil)."""

    def __init__(self, offsets, n_total, sweeps, sgs=True, scalar=False):
        factor = (lambda o: _scalar_factor(o, n_total)) if scalar else _Factor
        self.p_lower = factor(o for o in offsets if o < 0)
        self.p_upper = factor(o for o in offsets if o > 0)
        self.n_total, self.sweeps = n_total, sweeps
        if sgs:
            self.diag_p = None


def _stencil_offsets(m, dims, points):
    if dims == 2:
        return (-m, -1, 1, m)
    if points == 7:
        return (-m * m, -m, -1, 1, m, m * m)
    return tuple(dz * m * m + dy * m + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1) if (dz, dy, dx) != (0, 0, 0))


@pytest.mark.parametrize("m,dims,points,sweeps,itemsize,window", [
    (1414, 2, 5, 4, 4, True), (1414, 2, 5, 4, 8, True),     # the bench system
    (300, 2, 5, 4, 4, True),                                # many tiles of one chunk
    (243, 3, 7, 4, 4, False), (243, 3, 7, 2, 8, False),     # rings over 227 KB
    (128, 3, 27, 4, 4, False),                              # halo 3 tiles deep
    (40, 3, 7, 4, 4, True), (40, 3, 7, 4, 8, False),        # 4.7 tiles: 23 / 46 KB a CTA
    (243, 3, 7, 1, 8, True), (128, 3, 27, 1, 8, True),      # no sweep: one level
    (40, 3, 7, 2, 4, True), (40, 3, 7, 2, 8, True),         # halo 1.6 tiles
    (100, 3, 7, 2, 4, True), (100, 3, 7, 4, 4, False),      # halo 1.2 / 3.7 tiles
    (64, 3, 7, 2, 4, False),                                # halo two tiles
    (24, 3, 27, 4, 4, True), (24, 3, 27, 2, 8, False),      # f64: staging too big
])
def test_window_rule_at_full_size(m, dims, points, sweeps, itemsize, window):
    """The variant rule at the card's 132 SMs on the phase-A shapes and the
    card tests' shapes, from their offsets and padded lengths alone."""
    offsets = _stencil_offsets(m, dims, points)
    reach = max(offsets)
    n = m ** dims
    n_total = (-(-reach // 128) * 2 + -(-n // 128)) * 128
    tile = T.window_tile(_Layout(offsets, n_total, sweeps), 132, itemsize)
    assert (tile > 0) == window
    if window:  # whole chunks, at most one tile per SM, the halo under two tiles
        assert tile % T.CHUNK == 0 and -(-n_total // tile) <= 132  # or a small window
        halo = (sweeps - 1) * reach
        assert halo < 2 * tile or (tile == T.CHUNK and (tile + halo) * itemsize <= 32768)


@pytest.mark.parametrize("m,dims,points,sweeps,itemsize,variant", [
    (1414, 2, 5, 4, 4, "window"),                                       # the bench system
    (243, 3, 7, 4, 4, "ring"), (243, 3, 7, 4, 8, "ring"), (243, 3, 7, 2, 8, "ring"),
    (128, 3, 27, 4, 4, "ring"),                                         # 13 diagonals resident
    (128, 3, 27, 4, 8, "per-sweep"),                                    # read at every level
    (80, 3, 27, 4, 4, "ring"), (80, 3, 27, 2, 4, "window"),             # 513 chunks
    (100, 3, 7, 4, 8, "ring"), (100, 3, 7, 4, 4, "ring"),               # 499 / 250 chunks
    (96, 3, 7, 4, 4, "ring"),                                           # 221 chunks
    (88, 3, 7, 4, 4, "per-sweep"), (88, 3, 7, 4, 8, "ring"),            # 171 / 341
    (72, 3, 7, 4, 4, "per-sweep"), (72, 3, 7, 4, 8, "per-sweep"),       # 94 / 188
    (64, 3, 7, 4, 4, "per-sweep"), (64, 3, 7, 2, 4, "per-sweep"),       # 66 chunks
    (64, 3, 7, 4, 8, "per-sweep"),                                      # 132 chunks
    (40, 3, 7, 4, 8, "per-sweep"), (40, 3, 7, 2, 4, "window"),
    (40, 3, 7, 4, 4, "window"),                                         # a 23 KB window
    (24, 3, 27, 2, 8, "per-sweep"),
])
def test_variant_rule_at_full_size(m, dims, points, sweeps, itemsize, variant):
    """The three-way rule at the card's 132 SMs: the window kernels, the
    ring kernel from 1.5 chunks an SM (198) where its diagonals stay in
    shared memory, else the per-sweep kernels."""
    offsets = _stencil_offsets(m, dims, points)
    reach = max(offsets)
    n_total = (-(-reach // 128) * 2 + -(-m ** dims // 128)) * 128
    layout = _Layout(offsets, n_total, sweeps)
    assert T.variant_of(layout, 132, itemsize) == variant
    assert (T.window_tile(layout, 132, itemsize) > 0) == (variant == "window")


def test_ring_chunk_and_residency():
    """The ring kernel's chunks and its general instantiation's shared
    memory, as csrc/trisweep.cu sizes them."""
    assert [T.ring_chunk(nd, 4, 4) for nd in (1, 3, 4, 5, 13)] == [4096] * 3 + [1024] * 2
    assert [T.ring_chunk(nd, 4, 8) for nd in (3, 13)] == [2048, 1024]
    assert T.ring_chunk(3, 1, 4) == 1024  # a scale: the general instantiation
    assert T._ring_resident(13, 4) and not T._ring_resident(13, 8)
    assert T._ring_resident(24, 4) and not T._ring_resident(25, 4)


@pytest.mark.parametrize("m,dims,points,sweeps,itemsize,variant", [
    (256, 3, 27, 4, 8, "scalar"),                        # HPCG: per-sweep before
    (243, 3, 7, 4, 4, "scalar"), (100, 3, 7, 4, 8, "scalar"),  # the ring kernel before
    (64, 3, 27, 2, 8, "scalar"), (64, 3, 7, 4, 4, "scalar"),
    (1414, 2, 5, 4, 4, "window"), (40, 3, 7, 4, 4, "window"),  # the window kernels keep theirs
    (243, 3, 7, 1, 8, "window"),                         # no sweep: one level
])
def test_scalar_rule_at_full_size(m, dims, points, sweeps, itemsize, variant):
    """An SGS of a constant-coefficient stencil takes the scalar variant
    wherever the window kernels do not take it; its factors on the wrong
    side keep the per-sweep kernels."""
    offsets = _stencil_offsets(m, dims, points)
    n_total = (-(-max(offsets) // 128) * 2 + -(-m ** dims // 128)) * 128
    layout = _Layout(offsets, n_total, sweeps, scalar=True)
    assert T.variant_of(layout, 132, itemsize) == variant
    layout.p_lower, layout.p_upper = layout.p_upper, layout.p_lower
    assert T.variant_of(layout, 132, itemsize) == "per-sweep"


# -- constant-coefficient stencils: detection and the scalar variant's replay -----
# constant_stencil finds the grid in the offsets and checks the stored values
# row by row; sgs_apply_scalar_plain replays csrc/trisweep.cu's scalar_sweep
# (each diagonal one value and a face mask, the init step inside the first
# sweep), bit for bit sgs_apply_plain on the stored diagonals.

SCALAR_GRIDS = [((12, 10, 7), 27), ((12, 10, 7), 7), ((9, 9, 9), 27), ((9, 9, 9), 7),
                ((40, 23), 5), ((40, 23), 9)]


def _grid_dia(grid, points, dtype=torch.float64):
    """The benchmark's constant-coefficient stencil on ``grid`` as DIA."""
    cfg = {"grid": list(grid), "stencil": {"points": points, "diagonal": 26.0,
                                           "neighbour": -1.0}}
    return smm.dia_from_csr(stencil.csr(cfg, torch.device("cpu"), dtype, smm.CSRMatrix))


def _stored(dia, pre):
    """``pre`` with its strict parts as the stored, padded diagonals."""
    def part(sign):
        keep = [k for k, o in enumerate(dia.offsets) if o * sign > 0]
        sub = DIAMatrix(diags=dia.diags[keep], offsets=tuple(dia.offsets[k] for k in keep),
                        shape=dia.shape, nnz=dia.nnz)
        return D.pad_dia(sub, geometry_offsets=dia.offsets)

    return dataclasses.replace(pre, p_lower=part(-1), p_upper=part(1))


def _bits(t):
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("sweeps", SWEEPS)
@pytest.mark.parametrize("grid,points", SCALAR_GRIDS,
                         ids=[f"{'x'.join(map(str, g))}-{p}pt" for g, p in SCALAR_GRIDS])
def test_scalar_replay_matches_the_stored_diagonals(dtype, grid, points, sweeps):
    """Detection engages on 27- and 7-point grids, cubic and not (and 2-D
    ones), from the offsets and values alone; the factors laid out from their
    scalars are the stored diagonals bit for bit, and the scalar variant's
    replay is the plain apply on the stored diagonals, bit for bit."""
    tdtype = torch.from_numpy(np.zeros(1, dtype)).dtype
    dia = _grid_dia(grid, points, tdtype)
    pre = PaddedSGS.from_dia(dia, sweeps=sweeps)
    assert T._is_scalar(pre) and isinstance(pre.p_upper, T.ScalarFactor)
    assert (pre.p_lower.nx, pre.p_lower.ny) == (grid[0], grid[1] if len(grid) == 3 else 0)
    for part in (pre.p_lower, pre.p_upper):
        assert part.const_diag == (26.0, float(torch.tensor(1.0, dtype=tdtype) / 26.0))
    stored = _stored(dia, pre)
    for got, want in ((pre.p_lower, stored.p_lower), (pre.p_upper, stored.p_upper)):
        assert got.offsets == want.offsets
        assert torch.equal(_bits(got.diags_p), _bits(want.diags_p))
    rp = _padded(pre, _rhs(dia.shape[0], dtype, seed=2))
    want = T.sgs_apply_plain(stored, rp)
    assert torch.equal(_bits(T.sgs_apply_scalar_plain(pre, rp)), _bits(want))
    assert torch.equal(_bits(pre.apply_padded(rp)), _bits(want))
    cast = pre.astype(torch.float32 if tdtype == torch.float64 else torch.float64)
    assert torch.equal(_bits(T.sgs_apply_scalar_plain(cast, rp.to(cast.dtype))),
                       _bits(T.sgs_apply_plain(stored.astype(cast.dtype), rp.to(cast.dtype))))


def _perturb(kind, dia):
    """``dia`` with other values: a variable-coefficient stencil, one entry
    one ulp off, a nonzero or a -0.0 across a face, the main diagonal varied."""
    diags = dia.diags.clone()
    n = dia.shape[0]
    strict = dia.offsets.index(-1)
    if kind == "variable":
        diags[strict] *= 1.0 + 0.01 * torch.rand(n, generator=torch.Generator().manual_seed(0),
                                                 dtype=diags.dtype)
    elif kind == "one_entry":  # row (5, 4, 3): every neighbour inside
        diags[strict, 413] = torch.nextafter(diags[strict, 413], diags.new_tensor(0.0))
    elif kind == "across_a_face":
        diags[strict, 0] = -1.0  # row 0 has no x neighbour below
    elif kind == "negative_zero":
        diags[strict, 0] = -0.0
    elif kind == "main_diagonal":
        diags[dia.offsets.index(0), n // 3] = 27.0
    return DIAMatrix(diags=diags, offsets=dia.offsets, shape=dia.shape, nnz=dia.nnz)


@pytest.mark.parametrize("kind", ["variable", "one_entry", "across_a_face", "negative_zero",
                                  "main_diagonal"])
def test_detection_refuses_other_values(kind):
    """Any stored value that is not the stencil's keeps the stored diagonals
    and today's variants, and the apply as it was."""
    dia = _perturb(kind, _grid_dia((12, 10, 7), 27))
    pre = PaddedSGS.from_dia(dia, sweeps=4)
    assert not T._is_scalar(pre)
    assert isinstance(pre.p_lower, D.PaddedDIA) and isinstance(pre.p_upper, D.PaddedDIA)
    assert T.variant_of(pre, 132, 8) != "scalar"
    rp = _padded(pre, _rhs(dia.shape[0], np.float64, seed=3))
    assert torch.equal(pre.apply_padded(rp), T.sgs_apply_plain(_stored(dia, pre), rp))
    with pytest.raises(ValueError):
        T.sgs_apply_scalar_plain(pre, rp)


@pytest.mark.parametrize("kind", ["ic0", "ilu0"])
def test_detection_refuses_a_factor_pair(kind):
    """IC(0) and ILU(0) factors of the stencil vary along their diagonals: the
    check refuses their lower factor with its diagonal, and a pair never
    takes the scalar variant."""
    grid = (12, 10, 7)
    cfg = {"grid": list(grid), "stencil": {"points": 27, "diagonal": 26.0, "neighbour": -1.0}}
    csr = stencil.csr(cfg, torch.device("cpu"), torch.float64, smm.CSRMatrix)
    fac = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=4, strict_layout="csr")
    pair = PaddedTriPair.from_factors(fac.lower, fac.upper, smm.dia_from_csr(csr))
    lower = pair.p_lower
    diags = torch.cat([lower.diags_p, (1.0 / pair.inv_diag_l_p)[None]])
    n = pair.shape[0]
    assert T.constant_stencil(diags, lower.offsets + (0,), pair.inv_diag_l_p, pair.lead, n, 0,
                              n, lead=pair.lead, n_total=pair.n_total) is None
    assert not T._is_scalar(pair) and T.variant_of(pair, 132, 8) != "scalar"


def test_wrong_sign_factors_leave_the_scalar_variant():
    """Detected factors swapped to the wrong side for their direction take
    the per-sweep kernels, on their laid-out diagonals, bit for bit as the
    stored ones; the grid's offsets fit no other grid."""
    dia = _grid_dia((12, 10, 7), 27)
    pre = PaddedSGS.from_dia(dia, sweeps=4)
    swapped = dataclasses.replace(pre, p_lower=pre.p_upper, p_upper=pre.p_lower)
    assert T.variant_of(pre, 132, 8) == "scalar"
    assert T.variant_of(swapped, 132, 8) == "per-sweep"
    stored = _stored(dia, pre)
    stored = dataclasses.replace(stored, p_lower=stored.p_upper, p_upper=stored.p_lower)
    rp = _padded(pre, _rhs(dia.shape[0], np.float64, seed=4))
    assert torch.equal(T.sgs_apply_fused(swapped, rp), T.sgs_apply_plain(stored, rp))


@pytest.mark.parametrize("offsets,grid", [
    ((-1, 0, 1), None),                    # 1-D: no rows
    ((-12, -1, 0, 1, 12), (12, 0)),
    ((-120, -12, -1, 0, 1, 12, 120), (12, 10)),
    (tuple(dz * 120 + dy * 12 + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1)), (12, 10)),
    (tuple(dz * 120 + dy * 12 + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1)
           for dx in (-1, 0, 1) if abs(dx) + abs(dy) + abs(dz) < 3), (12, 10)),  # 19 points
    ((-3, -2, -1, 0, 1, 2, 3), None),      # a run of x steps longer than -1..1
    ((-14, -13, 0, 13, 14), None),         # a run of two: no centre
    ((-130, -12, -1, 0, 1, 12, 130), None),  # 130 is no whole number of rows of 12
])
def test_grid_from_the_offsets(offsets, grid):
    """The grid comes from the offsets alone: rows of nx points, planes of ny
    rows (0: a 2-D grid), or None where no grid of rows fits."""
    assert T._grid_of(offsets) == grid


@pytest.mark.parametrize("grid,points,window", [
    ((12, 10, 32), 27, (128, 3456)), ((12, 10, 32), 7, (256, 3200)),
    ((12, 10, 32), 27, (0, 3584)),
])
def test_a_window_is_detected_at_its_row_phase(grid, points, window):
    """A shard's window (``window_sgs``): rows of the whole system from a
    global row that is no whole number of planes; detection engages at that
    phase, the laid-out factors are the stored rows, and the replay is the
    plain apply on them."""
    dia = _grid_dia(grid, points)
    pdia = D.pad_dia(dia)
    row0, rows = window
    lead = pdia.lead + row0
    pre = DP.window_sgs(pdia.diags_p, dia.offsets, lead, rows, 4, row0, dia.shape[0], dia.nnz)
    assert T._is_scalar(pre) and pre.p_lower.row0 == row0 and pre.lead == lead
    main = dia.offsets.index(0)
    for p, part in ((pre.p_lower, slice(0, main)), (pre.p_upper, slice(main + 1, None))):
        assert torch.equal(_bits(p.diags_p[:, lead:lead + rows]),
                           _bits(pdia.diags_p[part, lead:lead + rows]))
    rp = torch.zeros(pdia.n_total, dtype=torch.float64)
    rp[lead:lead + rows] = torch.from_numpy(_rhs(rows, np.float64, seed=5))
    assert torch.equal(_bits(T.sgs_apply_scalar_plain(pre, rp)),
                       _bits(T.sgs_apply_plain(pre, rp)))
