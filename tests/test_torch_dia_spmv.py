"""The port's DIA SpMV (sparse_matrix_math_tpu_torch/ops/dia_spmv.py) held
against the JAX package's Pallas kernels (interpret mode) and XLA path.

On the CPU the wrappers run the kernels' plain versions; the CUDA kernels
themselves are checked by tests/test_torch_cuda_kernels.py, which skips
without a card.  Tolerances: f64 1e-12 and f32 1e-5 absolute on O(1)..O(26) entries —
the port sums in the JAX kernel's order, so only the XLA CPU backend's
rounding (FMA contraction) can differ.
"""

import dataclasses

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


# -- the staged kernel's decomposition (csrc/dia_spmv.cu dia_staged_kernel) ---

# 5, 7 and 27 diagonals, none of n a multiple of the tiles below; the last
# case's offsets (a gap of 50) make one cluster spanning 600 rows, more
# than the tiles
REPLAY_CASES = [("poisson_2d", (37,)), ("poisson_3d", (11,)), ("poisson_3d_27pt", (11,)),
                ("span", (tuple(range(-300, 301, 50)), 1100))]
REPLAY_DTYPES = {"bf16": (torch.bfloat16, torch.float32), "f16": (torch.float16, torch.float32),
                 "f32": (torch.float32, torch.float32), "f64": (torch.float64, torch.float64)}


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _replay_layout(name, args, diag_dtype, x_dtype):
    rng = np.random.default_rng(11)
    if name == "span":
        offsets, n = args
        diags = rng.standard_normal((len(offsets), n))
        a = interop.dia_from_numpy(diags, offsets, (n, n), 0, "cpu")
    else:
        jdia = jax_dia_from_csr(getattr(jax_gen, name)(*args, dtype=np.float64))
        a = interop.dia_from_numpy(np.asarray(jdia.diags) * (1 + 0.3 * rng.standard_normal(
            jdia.diags.shape)), jdia.offsets, jdia.shape, jdia.nnz, "cpu")
    p = K.pad_dia(DIAMatrix(diags=a.diags.to(x_dtype).to(diag_dtype), offsets=a.offsets,
                            shape=a.shape, nnz=a.nnz))
    xp = p.to_padded(torch.from_numpy(rng.standard_normal(a.shape[1])).to(x_dtype))
    return p, xp


@pytest.mark.parametrize("dt", list(REPLAY_DTYPES))
@pytest.mark.parametrize("name,args", REPLAY_CASES, ids=[n for n, _ in REPLAY_CASES])
def test_staged_replay_matches_plain(name, args, dt):
    """The staged kernel's decomposition at small tiles (several per system,
    the first and last straddling the guard blocks): bit for bit the plain
    version."""
    diag_dtype, x_dtype = REPLAY_DTYPES[dt]
    p, xp = _replay_layout(name, args, diag_dtype, x_dtype)
    want = K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp)
    assert p.n_total % 256 and p.n_total > 2 * 256
    for tile in (128, 256, 512):
        clusters = K.x_clusters(p.offsets, tile, xp.element_size())
        if name == "span":
            assert len(clusters) == 1 and clusters[0][1] >= tile + 600 > 2 * tile
        got = K.dia_spmv_padded_staged_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp,
                                             K.StagedPlan(tile, clusters))
        assert torch.equal(_bits(got), _bits(want)), tile


def test_replay_refuses_a_segment_that_misses_a_read():
    p, xp = _replay_layout("poisson_2d", (37,), torch.float32, torch.float32)
    (lo, length, first), rest = K.x_clusters(p.offsets, 256, 4)[0], \
        K.x_clusters(p.offsets, 256, 4)[1:]
    plan = K.StagedPlan(256, ((lo + 4, length - 4, first),) + rest)
    with pytest.raises(ValueError, match="outside"):
        K.dia_spmv_padded_staged_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp, plan)


def _offsets_27pt(m):
    return tuple(dz * m * m + dy * m + dx for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1))


def test_x_clusters_at_full_size():
    """Clusters and segments (16-byte rounded) at the table's shapes."""
    assert K.x_clusters((-1414, -1, 0, 1, 1414), 1024, 4) == (
        (-1416, 1028, 0), (-4, 1032, 1), (1412, 1028, 4))
    assert K.x_clusters((-59049, -243, -1, 0, 1, 243, 59049), 1024, 8) == (
        (-59050, 1026, 0), (-244, 1512, 1), (59048, 1026, 6))
    clusters = K.x_clusters(_offsets_27pt(128), 512, 4)
    assert [c[2] for c in clusters] == [0, 9, 18]
    assert clusters[1] == (-132, 776, 9)


def _full_size(offsets, n):
    return offsets, K._dia_layout_params(offsets, (n, n))[3]


# the systems of PERF.md's table as pad_dia lays them out (offsets only)
FULL_SIZE = {
    "2d(1414)": _full_size((-1414, -1, 0, 1, 1414), 1414 ** 2),
    "3d(243)": _full_size((-243 ** 2, -243, -1, 0, 1, 243, 243 ** 2), 243 ** 3),
    "27pt(128)": _full_size(_offsets_27pt(128), 128 ** 3),
    "2d(1000)": _full_size((-1000, -1, 0, 1, 1000), 1000 ** 2),
    "3d(100)": _full_size((-100 ** 2, -100, -1, 0, 1, 100, 100 ** 2), 100 ** 3),
    "27pt(80)": _full_size(_offsets_27pt(80), 80 ** 3),
    "2d(400)": _full_size((-400, -1, 0, 1, 400), 400 ** 2),
    "2d(200)": _full_size((-200, -1, 0, 1, 200), 200 ** 2),
    "64 scattered": _full_size(tuple(range(-32_000, 32_000, 1_000)), 10_000_000),
}
# the tile the rule picks on a 132-SM card, or None for the row kernel
RULE = {
    "2d(1414)": {"f32": 1024, "bf16": 1024, "f16": 1024, "f64": None},
    "3d(243)": {"f32": 1024, "bf16": 1024, "f16": 1024, "f64": None},
    "27pt(128)": {"f32": 512, "bf16": 1024, "f16": 1024, "f64": None},
    # 7.4 and 7.5 tiles of 1024 rows per SM
    "2d(1000)": {"f32": 1024, "bf16": 1024, "f16": 1024, "f64": None},
    "3d(100)": {"f32": 1024, "bf16": 1024, "f16": 1024, "f64": None},
    # bf16's tile (1024) gives 3.9 tiles per SM: no smaller tile is taken
    "27pt(80)": {"f32": 512, "bf16": None, "f16": None, "f64": None},
    "2d(400)": {"f32": None, "bf16": None, "f16": None, "f64": None},
    "2d(200)": {"f32": None, "bf16": None, "f16": None, "f64": None},
    "64 scattered": {"f32": None, "bf16": None, "f16": None, "f64": None},
}


@pytest.mark.parametrize("system", list(FULL_SIZE))
def test_rule_at_full_size(system):
    """The rule's choice at full-size shapes, and a staged plan's shared
    memory within the block's 227 KB."""
    offsets, n_total = FULL_SIZE[system]
    for dt, want in RULE[system].items():
        diag_dtype, x_dtype = REPLAY_DTYPES[dt]
        plan = K.staged_plan(offsets, n_total, diag_dtype, x_dtype, 132)
        assert (None if plan is None else plan.tile) == want, dt
        if plan is not None:
            assert plan.clusters == K.x_clusters(offsets, plan.tile, 4)
            assert plan.smem_bytes(len(offsets), diag_dtype.itemsize, 4) <= K._SMEM_BYTES
            assert n_total >= 7 * plan.tile * 132


def test_rule_layout_sizes_and_variant_names(monkeypatch):
    assert [FULL_SIZE[s][1] for s in ("2d(1414)", "3d(243)", "27pt(128)")] == [
        2_002_560, 14_467_200, 2_130_432]
    offsets, n_total = FULL_SIZE["27pt(128)"]
    p = K.PaddedDIA(diags_p=torch.zeros((27, 1), dtype=torch.bfloat16), offsets=offsets,
                    shape=(128 ** 3, 128 ** 3), nnz=0, n_total=n_total, lblk=0, nblk=0)
    monkeypatch.setattr(K, "_num_sms", lambda index: 132)
    assert K.variant(p, "cuda:0") == "staged (tile 1024)"
    assert K.variant(dataclasses.replace(p, diags_p=p.diags_p.double()), "cuda:0") == "rows"


def test_launch_args_at_full_size(monkeypatch):
    """The staged entry's arguments for the rule's plan: one stage's bytes,
    and a grid of as many CTAs as the card holds, at most one per tile."""
    offsets, n_total = FULL_SIZE["27pt(128)"]
    p = K.PaddedDIA(diags_p=torch.zeros((27, 1), dtype=torch.bfloat16), offsets=offsets,
                    shape=(128 ** 3, 128 ** 3), nnz=0, n_total=n_total, lblk=0, nblk=0)
    asked = []

    def blocks_per_sm(kind, tile, smem, index):
        asked.append((kind, tile, smem, index))
        return 1

    monkeypatch.setattr(K, "_num_sms", lambda index: 132)
    monkeypatch.setattr(K, "_blocks_per_sm", blocks_per_sm)
    plan = K.staged_plan(offsets, n_total, torch.bfloat16, torch.float32, 132)
    # 27 bf16 diagonals of 1024 rows, three float32 segments of 1288
    assert [c[1] for c in plan.clusters] == [1288] * 3
    assert K._launch_args(p, plan, 0) == (1024, plan.segs_ptr, 70784, 132)
    assert asked == [(2, 1024, 1024 + 2 * 70784, 0)]
    few = dataclasses.replace(p, n_total=100 * 1024)
    assert K._launch_args(few, plan, 0)[3] == 100
    assert K._launch_args(p, None, 0) == (0, None, 0, 0)
