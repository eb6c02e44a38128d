"""The port's CUDA kernels on a card (skipped without one).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Kernel and plain version round every product and sum alike in the same
order, so they are compared for equality (both words of the double-word
kernel too).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as D
from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
from sparse_matrix_math_tpu_torch.ops import sell_spmv as S
from sparse_matrix_math_tpu_torch.ops import stream_gather as R
from sparse_matrix_math_tpu_torch.ops import trisweep as T
from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
from sparse_matrix_math_tpu_torch.precond import PaddedSGS, PaddedTriPair
from sparse_matrix_math_tpu_torch.solvers.ir_df64 import hi_operator

pytestmark = pytest.mark.cuda

CASES = [
    ("laplace_1d", (301,)),
    ("poisson_2d", (37,)),
    ("poisson_3d", (6,)),
    ("poisson_3d_27pt", (5,)),
    ("convection_diffusion_2d", (9,)),
]
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda", 0)


def bits_equal(a, b):
    """Bit for bit, the sign of a zero included."""
    word = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(word), b.view(word))


def _dia(name, args, dtype, device):
    return smm.dia_from_csr(getattr(smm, name)(*args, dtype=dtype, device=device))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}{a}" for n, a in CASES])
def test_kernels_match_plain(cuda_device, name, args, dtype):
    a = _dia(name, args, dtype, cuda_device)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(a.shape[1]),
                        device=cuda_device).to(dtype)
    before = dict(K.launches)
    y = K.dia_spmv(a, x)
    p = K.pad_dia(a)
    xp = p.to_padded(x)
    yp = K.dia_spmv_padded(p, xp)
    torch.cuda.synchronize()
    assert torch.equal(y, K.dia_spmv_plain(a.diags, a.offsets, a.shape, x))
    assert torch.equal(yp, K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead,
                                                   a.shape[0], xp))
    assert torch.all(yp[:p.lead] == 0) and torch.all(yp[p.lead + a.shape[0]:] == 0)
    assert K.launches["dia_spmv"] == before["dia_spmv"] + 1
    assert K.launches["dia_spmv_padded"] == before["dia_spmv_padded"] + 1


def test_rectangular_one_shot(cuda_device):
    rng = np.random.default_rng(3)
    shape, offsets = (40, 57), (-3, 0, 2, 20)
    diags = rng.standard_normal((len(offsets), shape[0]))
    a = smm.DIAMatrix(diags=torch.as_tensor(diags, device=cuda_device), offsets=offsets,
                      shape=shape, nnz=0)
    x = torch.as_tensor(rng.standard_normal(shape[1]), device=cuda_device)
    assert torch.equal(K.dia_spmv(a, x), K.dia_spmv_plain(a.diags, offsets, shape, x))


def test_wrappers_raise_on_cuda(cuda_device):
    a = _dia("poisson_2d", (7,), torch.float64, cuda_device)
    x = torch.ones(a.shape[1], dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError):
        K.dia_spmv(a, x.float())
    with pytest.raises(ValueError):
        K.dia_spmv(a, x.cpu())


# 5, 7 and 27 diagonals; n = 1369, 216, 343, 2601: none a multiple of the
# kernel's 256-row block
NARROW_CASES = [("poisson_2d", (37,)), ("poisson_3d", (6,)), ("poisson_3d_27pt", (7,)),
                ("convection_diffusion_2d", (51,))]


@pytest.mark.parametrize("diag_dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("name,args", NARROW_CASES, ids=[f"{n}{a}" for n, a in NARROW_CASES])
def test_narrow_diagonal_kernel_matches_plain(cuda_device, name, args, diag_dtype):
    """K2's bf16/f16-diagonal instantiation (the mixed solve's inner
    product) against its plain version, bit for bit, guard rows exactly 0,
    on diagonals rounded from values with full float32 mantissas."""
    a = _dia(name, args, torch.float32, cuda_device)
    rng = np.random.default_rng(5)
    scale = torch.as_tensor(1.0 + 0.3 * rng.standard_normal(a.diags.shape),
                            device=cuda_device).float()
    p = K.pad_dia(smm.DIAMatrix(diags=(a.diags * scale).to(diag_dtype), offsets=a.offsets,
                                shape=a.shape, nnz=a.nnz))
    xp = p.to_padded(torch.as_tensor(rng.standard_normal(a.shape[1]), device=cuda_device).float())
    key = "dia_spmv_padded_bf16" if diag_dtype == torch.bfloat16 else "dia_spmv_padded_f16"
    before = dict(K.launches)
    yp = K.dia_spmv_padded(p, xp)
    torch.cuda.synchronize()
    assert yp.dtype == torch.float32
    assert bits_equal(yp, K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, a.shape[0], xp))
    assert torch.all(yp[:p.lead] == 0) and torch.all(yp[p.lead + a.shape[0]:] == 0)
    assert K.launches[key] == before[key] + 1
    assert K.launches["dia_spmv_padded"] == before["dia_spmv_padded"]


def test_narrow_diagonal_wrapper_raises_on_cuda(cuda_device):
    """Only the instantiated pairs launch: other diagonal dtypes, and bf16
    diagonals with a float64 x, raise TypeError before any launch."""
    a = _dia("poisson_2d", (7,), torch.float32, cuda_device)
    p = K.pad_dia(a)
    xp = torch.ones(p.n_total, dtype=torch.float32, device=cuda_device)
    before = dict(K.launches)
    for diags in (p.diags_p.to(torch.int32), p.diags_p.to(torch.float8_e4m3fn)):
        with pytest.raises(TypeError, match="float32"):
            K.dia_spmv_padded(dataclasses.replace(p, diags_p=diags), xp)
    with pytest.raises(TypeError, match="float32"):
        K.dia_spmv_padded(dataclasses.replace(p, diags_p=p.diags_p.to(torch.bfloat16)),
                          xp.double())
    assert K.launches == before


# The staged padded kernel (csrc/dia_spmv.cu dia_staged_kernel): systems of
# several tiles, none a multiple of a tile, the first and last tiles
# straddling the guard blocks; 5, 7, 27 and 5 diagonals.
STAGED_CASES = [("poisson_2d", (60,)), ("poisson_3d", (14,)), ("poisson_3d_27pt", (13,)),
                ("convection_diffusion_2d", (50,))]
# diagonals' and x's dtypes
STAGED_DTYPES = {"f32": (torch.float32, torch.float32), "f64": (torch.float64, torch.float64),
                 "bf16": (torch.bfloat16, torch.float32), "f16": (torch.float16, torch.float32)}
_COUNTER = {torch.bfloat16: "dia_spmv_padded_bf16", torch.float16: "dia_spmv_padded_f16"}


def _layout(name, args, diag_dtype, x_dtype, device, seed=9):
    """A padded layout with diagonals rounded from values with full mantissas,
    and an x in its layout."""
    a = _dia(name, args, x_dtype, device)
    rng = np.random.default_rng(seed)
    scale = torch.as_tensor(1.0 + 0.3 * rng.standard_normal(a.diags.shape), device=device)
    p = K.pad_dia(smm.DIAMatrix(diags=(a.diags * scale.to(x_dtype)).to(diag_dtype),
                                offsets=a.offsets, shape=a.shape, nnz=a.nnz))
    xp = p.to_padded(torch.as_tensor(rng.standard_normal(a.shape[1]), device=device)
                     .to(x_dtype))
    return p, xp


@pytest.mark.parametrize("dt", list(STAGED_DTYPES))
@pytest.mark.parametrize("name,args", STAGED_CASES, ids=[f"{n}{a}" for n, a in STAGED_CASES])
def test_staged_kernel_matches_plain(cuda_device, name, args, dt):
    """Every tile that fits: bit for bit the plain version, guard rows
    exactly 0, one launch counted under the dtype's key."""
    diag_dtype, x_dtype = STAGED_DTYPES[dt]
    p, xp = _layout(name, args, diag_dtype, x_dtype, cuda_device)
    want = K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp)
    key = _COUNTER.get(diag_dtype, "dia_spmv_padded")
    ran = 0
    for tile in K.STAGED_TILES:
        plan = K.StagedPlan(tile, K.x_clusters(p.offsets, tile, xp.element_size()))
        if plan.smem_bytes(len(p.offsets), p.diags_p.element_size(),
                           xp.element_size()) > K._SMEM_BYTES:
            continue
        before = K.launches[key]
        y = K.launch_padded(p, xp, plan)
        torch.cuda.synchronize()
        assert bits_equal(y, want), plan
        assert torch.all(y[:p.lead] == 0) and torch.all(y[p.lead + p.shape[0]:] == 0)
        assert K.launches[key] == before + 1
        ran += 1
    # float64 at 27 diagonals: two stages of either tile outgrow 227 KB
    assert ran >= 1 or (dt == "f64" and len(p.offsets) == 27)


def test_staged_rule_on_the_card(cuda_device):
    """The wrapper takes the staged kernel where the rule picks it, and the
    row kernel where ``xp`` does not start on 16 bytes; both bit for bit."""
    p, xp = _layout("poisson_3d", (100,), torch.float32, torch.float32, cuda_device)
    assert K.variant(p, cuda_device).startswith("staged")
    want = K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp)
    assert bits_equal(K.dia_spmv_padded(p, xp), want)
    shifted = torch.zeros(p.n_total + 1, dtype=xp.dtype, device=cuda_device)[1:]
    shifted.copy_(xp)
    assert bits_equal(K.dia_spmv_padded(p, shifted), want)


def test_rule_keeps_the_row_kernel(cuda_device):
    """Shapes the rule sends to the row kernel: a small layout, and 64
    scattered diagonals whose segments outgrow the shared memory."""
    p, xp = _layout("poisson_2d", (37,), torch.float32, torch.float32, cuda_device)
    assert K.variant(p, cuda_device) == "rows"
    assert bits_equal(K.dia_spmv_padded(p, xp),
                      K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, p.shape[0], xp))
    n, offsets = 80_000, tuple(range(-32_000, 32_000, 1_000))
    rng = np.random.default_rng(4)
    a = smm.DIAMatrix(diags=torch.as_tensor(rng.standard_normal((64, n)), device=cuda_device)
                      .float(), offsets=offsets, shape=(n, n), nnz=0)
    p = K.pad_dia(a)
    xp = p.to_padded(torch.as_tensor(rng.standard_normal(n), device=cuda_device).float())
    assert K.variant(p, cuda_device) == "rows"
    assert bits_equal(K.dia_spmv_padded(p, xp),
                      K.dia_spmv_padded_plain(p.diags_p, offsets, p.lead, n, xp))


def test_staged_entry_refuses_bad_plans(cuda_device):
    """A segment that misses a read, a tile the kernel is not built for,
    shared memory over 227 KB, or a stage too small for the plan: CUDA
    error, nothing counted."""
    p, xp = _layout("poisson_3d_27pt", (13,), torch.float32, torch.float32, cuda_device)
    good = K.StagedPlan(512, K.x_clusters(p.offsets, 512, 4))
    (lo, length, first), rest = good.clusters[0], good.clusters[1:]
    before = dict(K.launches)
    for plan in (K.StagedPlan(512, ((lo, length - 2, first),) + rest),
                 K.StagedPlan(256, K.x_clusters(p.offsets, 256, 4)),
                 K.StagedPlan(1024, K.x_clusters(p.offsets, 1024, 4))):
        with pytest.raises(RuntimeError, match="CUDA error"):
            K.launch_padded(p, xp, plan)
    tile, segs, stage, grid = K._launch_args(p, good, xp.device.index)
    with pytest.raises(RuntimeError, match="CUDA error"):
        K._launch(p, xp, p._k2, (tile, segs, stage - 128, grid))
    assert K.launches == before


def test_mixed_cg_matches_cpu(cuda_device):
    """mixed_cg on the card (K2 f32 for the true residuals, the bf16
    instantiation in the inner solve) against the same solve on the CPU
    (plain versions): the same status and iteration count."""
    res, launched = {}, {}
    b = np.random.default_rng(2).standard_normal(24 * 24)
    for dev in ("cpu", cuda_device):
        a = _dia("poisson_2d", (24,), torch.float32, dev)
        before = dict(K.launches)
        res[str(dev)] = smm.mixed_cg(a, torch.as_tensor(b, device=dev).float(), epsilon=1e-4)
        launched[str(dev)] = {k: K.launches[k] - before[k] for k in K.launches}
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert gpu.iterations == cpu.iterations
    assert all(v == 0 for v in launched["cpu"].values())
    n = launched[str(cuda_device)]
    assert n["dia_spmv_padded_bf16"] >= gpu.iterations and n["dia_spmv_padded"] >= 3


def _padded_rhs(pre, dtype, device, seed=0):
    r = np.random.default_rng(seed).standard_normal(pre.shape[0])
    rp = torch.zeros(pre.n_total, dtype=dtype, device=device)
    rp[pre.lead:pre.lead + pre.shape[0]] = torch.as_tensor(r, device=device).to(dtype)
    return rp


def _check_apply(pre, fused, plain, name, dtype, device):
    rp = _padded_rhs(pre, dtype, device)
    before = T.launches[name]
    z = fused(pre, rp)
    torch.cuda.synchronize()
    assert T.launches[name] == before + 1
    assert torch.equal(z, plain(pre, rp))
    n = pre.shape[0]
    assert torch.all(z[:pre.lead] == 0) and torch.all(z[pre.lead + n:] == 0)


SWEEP_CASES = [("poisson_2d", (37,)), ("poisson_3d_27pt", (5,)),
               ("convection_diffusion_2d", (9,))]


@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,args", SWEEP_CASES, ids=[f"{n}{a}" for n, a in SWEEP_CASES])
def test_sgs_apply_matches_plain(cuda_device, name, args, dtype, sweeps):
    pre = PaddedSGS.from_dia(_dia(name, args, dtype, cuda_device), sweeps=sweeps)
    _check_apply(pre, T.sgs_apply_fused, T.sgs_apply_plain, "sgs_apply", dtype, cuda_device)


# IC(0) on the symmetric systems, ILU(0) on all
PAIR_CASES = [("ic0",) + c for c in SWEEP_CASES[:2]] + [("ilu0",) + c for c in SWEEP_CASES]


@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind,name,args", PAIR_CASES,
                         ids=[f"{k}-{n}{a}" for k, n, a in PAIR_CASES])
def test_tri_pair_apply_matches_plain(cuda_device, kind, name, args, dtype, sweeps):
    csr = getattr(smm, name)(*args, dtype=dtype, device=cuda_device)
    fac = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=sweeps)
    pre = PaddedTriPair.from_factors(fac.lower, fac.upper, smm.dia_from_csr(csr))
    _check_apply(pre, T.tri_pair_apply_fused, T.tri_pair_apply_plain, "tri_pair_apply",
                 dtype, cuda_device)


@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0), (0,)])
def test_one_sided_and_diagonal_applies(cuda_device, offsets):
    """An empty strict part on one side, or on both: a diagonal scale there."""
    n = 3000
    diags = np.random.default_rng(1).uniform(-1.0, -0.5, (len(offsets), n))
    diags[offsets.index(0)] += 3.5
    a = smm.DIAMatrix(diags=torch.as_tensor(diags, device=cuda_device), offsets=offsets,
                      shape=(n, n), nnz=0)
    pre = PaddedSGS.from_dia(a, sweeps=4)
    _check_apply(pre, T.sgs_apply_fused, T.sgs_apply_plain, "sgs_apply", torch.float64,
                 cuda_device)


# Shapes of many window tiles (poisson_2d(300): 89 tiles of one chunk, the
# halo 900 rows at sweeps 4) and one whose tile of 1024 rows is shorter
# than its halo (poisson_3d(40), reach 1600): the window kernels at sweeps 2
# (a halo of 1.6 tiles), the large-reach variant at sweeps 4 (4.7 tiles).
MULTI_TILE = [("sgs", "poisson_2d", (300,)), ("sgs", "convection_diffusion_2d", (300,)),
              ("ic0", "poisson_2d", (300,)), ("ilu0", "poisson_2d", (300,)),
              ("sgs", "poisson_3d", (40,))]


@pytest.mark.parametrize("sweeps", [1, 2, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("kind,name,args", MULTI_TILE,
                         ids=[f"{k}-{n}{a}" for k, n, a in MULTI_TILE])
def test_multi_tile_applies_match_plain(cuda_device, kind, name, args, dtype, sweeps):
    csr = getattr(smm, name)(*args, dtype=dtype, device=cuda_device)
    dia = smm.dia_from_csr(csr)
    if kind == "sgs":
        pre = PaddedSGS.from_dia(dia, sweeps=sweeps)
        fns = (T.sgs_apply_fused, T.sgs_apply_plain, "sgs_apply")
    else:
        fac = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=sweeps,
                                     strict_layout="csr")
        pre = PaddedTriPair.from_factors(fac.lower, fac.upper, dia)
        fns = (T.tri_pair_apply_fused, T.tri_pair_apply_plain, "tri_pair_apply")
    large = name == "poisson_3d" and sweeps == 4
    assert T.variant(pre, cuda_device) == ("per-sweep" if large else "window")
    _check_apply(pre, *fns[:2], fns[2], dtype, cuda_device)


def test_windowed_replay_matches_the_kernel(cuda_device):
    """The PyTorch replay of the window kernels at the kernel's own tile and
    chunk, on the card, equal to the kernel's result."""
    pre = PaddedSGS.from_dia(_dia("poisson_2d", (300,), torch.float32, cuda_device), sweeps=4)
    rp = _padded_rhs(pre, torch.float32, cuda_device)
    tile = T.window_tile(pre, torch.cuda.get_device_properties(0).multi_processor_count, 4)
    assert tile > 0
    assert torch.equal(T.sgs_apply_windowed_plain(pre, rp, tile), T.sgs_apply_fused(pre, rp))


def test_window_entry_refuses_a_partial_chunk_tile(cuda_device):
    """A tile that is not a whole number of chunks, or an offset of the
    wrong sign for its direction, is refused with an error code."""
    from sparse_matrix_math_tpu_torch.ops import _build

    pre = PaddedSGS.from_dia(_dia("poisson_2d", (40,), torch.float64, cuda_device), sweeps=4)
    rp = _padded_rhs(pre, torch.float64, cuda_device)
    lib = _build.library()
    lo = np.asarray(pre.p_lower.offsets, dtype=np.int32)
    up = np.asarray(pre.p_upper.offsets, dtype=np.int32)
    w0, w1, out = (torch.empty_like(rp) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream

    def call(tile, l_offs):
        return lib.smm_sgs_apply_f64(
            rp.data_ptr(), pre.inv_diag_p.data_ptr(), pre.diag_p.data_ptr(),
            pre.p_lower.diags_p.data_ptr(), l_offs.ctypes.data, len(l_offs),
            pre.p_upper.diags_p.data_ptr(), up.ctypes.data, len(up), w0.data_ptr(),
            w1.data_ptr(), out.data_ptr(), 4, pre.n_total, pre.lead, pre.shape[0], tile, stream)

    assert call(T.CHUNK, lo) == 0
    assert call(T.CHUNK + 32, lo) != 0
    assert call(T.CHUNK, -lo) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_solves_match_cpu(cuda_device, dtype):
    """The CUDA solve path (kernel matvec) against the CPU one (plain
    matvec) on the same system.  The dots sum in other orders (cuBLAS vs the
    CPU BLAS), which moves the step that crosses eps: by up to 2 in f64, and
    by up to 5% in f32, where BiCGStab is more sensitive to rounding."""
    eps = 1e-3 if dtype == torch.float32 else 1e-8
    b = np.random.default_rng(1).standard_normal(24 * 24)
    for solver in (smm.cg, smm.bicgstab):
        res = {}
        for dev in ("cpu", cuda_device):
            a = _dia("poisson_2d", (24,), dtype, dev)
            res[str(dev)] = solver(a, torch.as_tensor(b, device=dev).to(dtype), epsilon=eps)
        cpu, gpu = res["cpu"], res[str(cuda_device)]
        assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
        slack = 2 if dtype == torch.float64 else max(2, 0.05 * cpu.iterations)
        assert abs(gpu.iterations - cpu.iterations) <= slack
        if dtype == torch.float64:
            # both residuals are below 1e-8 and lambda_min(A) > 0.03
            assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-6


@pytest.mark.parametrize("kind", ["sgs", "ic0", "ilu0"])
def test_preconditioned_solves_match_cpu(cuda_device, kind):
    """The preconditioned padded solve with the K4/K5 kernels on the card
    against the plain versions on the CPU, in f64: the same status, and
    iteration counts within 2 (the dots sum in other orders)."""
    b = np.random.default_rng(2).standard_normal(24 * 24)
    solvers = (smm.bicgstab,) if kind == "ilu0" else (smm.cg, smm.bicgstab)
    for solver in solvers:
        res = {}
        for dev in ("cpu", cuda_device):
            csr = smm.poisson_2d(24, dtype=torch.float64, device=dev)
            pre = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=4)
            before = dict(T.launches)
            res[str(dev)] = solver(smm.dia_from_csr(csr), torch.as_tensor(b, device=dev),
                                   epsilon=1e-8, preconditioner=pre)
        cpu, gpu = res["cpu"], res[str(cuda_device)]
        assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
        assert abs(gpu.iterations - cpu.iterations) <= 2
        assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-6
        name = "sgs_apply" if kind == "sgs" else "tri_pair_apply"
        assert T.launches[name] - before[name] >= gpu.iterations


# -- general patterns: K6 (ELL), K7 and K8 (W-SELL) -------------------------------
# K6 and K7 launch csrc/sell_spmv.cu over the slab-sorted SELL-32 layout: bit
# for bit its plain version, and equal to the planes' plain version (which
# sums the same terms in the same order, padding products included).

WSELL_CASES = [
    ("poisson_2d", (48,), {}),
    ("laplace_3d_jittered", (16,), dict(nway=4)),
    ("laplace_3d_jittered", (14,), dict(nway=2, window_f=8)),
    ("random_spd_csr", (600,), dict(nway=8, max_slot_ratio=64.0)),
]


def _csr(name, args, dtype, device):
    kw = dict(symmetric=True, shift=0.25) if name == "laplace_3d_jittered" else {}
    if name == "random_spd_csr":
        kw = dict(density=0.012, seed=5)
    return getattr(smm, name)(*args, dtype=dtype, device=device, **kw)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,args,kw", WSELL_CASES,
                         ids=[f"{n}{a}{k}" for n, a, k in WSELL_CASES])
def test_wsell_kernels_match_plain(cuda_device, name, args, kw, dtype):
    ws = smm.wsell_from_csr(_csr(name, args, dtype, cuda_device), **kw)
    gen = np.random.default_rng(0)
    x = torch.as_tensor(gen.standard_normal(ws.shape[1]), device=cuda_device).to(dtype)
    before = dict(W.launches)
    y = W.wsell_spmv(ws, x)
    torch.cuda.synchronize()
    assert W.launches["wsell_spmv"] == before["wsell_spmv"] + 1
    assert bits_equal(y, S.sell_spmv_plain(ws.sell, x))
    assert torch.equal(y, W.wsell_spmv_plain(ws, x))
    # K8: the panel instantiations of the same kernel, one launch per 8 columns
    for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 17):
        xs = torch.as_tensor(gen.standard_normal((ws.shape[1], k)), device=cuda_device).to(dtype)
        n0 = W.launches["wsell_spmm"]
        ys = W.wsell_spmm(ws, xs)
        torch.cuda.synchronize()
        assert W.launches["wsell_spmm"] == n0 + -(-k // W.SPMM_COLUMNS)
        assert bits_equal(ys, S.sell_spmm_plain(ws.sell, xs))
        assert torch.equal(ys, W.wsell_spmm_plain(ws, xs))
        # each column of K8 is K7's product of that column, bit for bit
        for j in range(k):
            assert bits_equal(ys[:, j].contiguous(), W.wsell_spmv(ws, xs[:, j].contiguous()))


def test_wsell_empty_slabs_and_rectangular(cuda_device):
    rng = np.random.default_rng(11)
    rows = np.array([0, 3, 4]), np.array([0, 5, 2400]), np.array([1.0, 2.5, -1.5])
    m = rng.random((700, 1500)) < 0.01
    cases = [(rows, (2500, 2500), dict(max_slot_ratio=1e9)),
             ((*np.nonzero(m), rng.standard_normal(int(m.sum()))), (700, 1500), {})]
    for (r, c, v), shape, kw in cases:
        csr = smm.csr_from_coo(smm.coo_from_arrays(r, c, v, shape, device=cuda_device))
        ws = smm.wsell_from_csr(csr, **kw)
        x = torch.as_tensor(rng.standard_normal(shape[1]), device=cuda_device)
        y = W.wsell_spmv(ws, x)
        assert bits_equal(y, S.sell_spmv_plain(ws.sell, x))
        assert torch.equal(y, W.wsell_spmv_plain(ws, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,args", [("poisson_2d", (37,)), ("laplace_3d_jittered", (16,))])
def test_ell_kernel_matches_plain(cuda_device, name, args, dtype):
    ell = smm.ell_from_csr(_csr(name, args, dtype, cuda_device))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(ell.shape[1]),
                        device=cuda_device).to(dtype)
    before = E.launches["ell_spmv"]
    y = E.ell_spmv(ell, x)
    torch.cuda.synchronize()
    assert E.launches["ell_spmv"] == before + 1
    assert bits_equal(y, S.sell_spmv_plain(ell.sell, x))
    assert torch.equal(y, E.ell_spmv_plain(ell, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_ell_panel_kernel_matches_plain(cuda_device, dtype):
    """ELL panels run the panel kernel over ELL's layout: one launch per 8
    columns, bit for bit the plain version and the per-column K6 launches."""
    ell = smm.ell_from_csr(_csr("laplace_3d_jittered", (16,), dtype, cuda_device))
    gen = np.random.default_rng(3)
    for k in (2, 4, 8, 9):
        xs = torch.as_tensor(gen.standard_normal((ell.shape[1], k)), device=cuda_device).to(dtype)
        n0, n6 = E.launches["ell_spmm"], E.launches["ell_spmv"]
        ys = smm.rmult(ell, xs)
        torch.cuda.synchronize()
        assert E.launches["ell_spmm"] == n0 + -(-k // 8) and E.launches["ell_spmv"] == n6
        assert bits_equal(ys, S.sell_spmm_plain(ell.sell, xs))
        for j in range(k):
            assert bits_equal(ys[:, j].contiguous(), E.ell_spmv(ell, xs[:, j].contiguous()))


def test_panel_kernel_takes_an_unaligned_view(cuda_device):
    """A contiguous X that starts off a 16 B boundary is copied to an
    aligned one before the launch: the same result."""
    ws = smm.wsell_from_csr(_csr("laplace_3d_jittered", (16,), torch.float32, cuda_device))
    n = ws.shape[1]
    flat = torch.as_tensor(np.random.default_rng(6).standard_normal(4 * n + 1),
                           device=cuda_device).float()
    xs = flat[1:].view(n, 4)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    assert bits_equal(W.wsell_spmm(ws, xs), S.sell_spmm_plain(ws.sell, xs))


def test_general_wrappers_raise_on_cuda(cuda_device):
    csr = _csr("laplace_3d_jittered", (10,), torch.float64, cuda_device)
    ws, ell = smm.wsell_from_csr(csr), smm.ell_from_csr(csr)
    x = torch.ones(csr.shape[1], dtype=torch.float64, device=cuda_device)
    for fn, a in ((W.wsell_spmv, ws), (E.ell_spmv, ell)):
        with pytest.raises(TypeError):
            fn(a, x.float())
        with pytest.raises(ValueError):
            fn(a, x.cpu())
    xs = torch.ones(csr.shape[1], 3, dtype=torch.float64, device=cuda_device)
    for fn, a in ((W.wsell_spmm, ws), (E.ell_spmm, ell)):
        with pytest.raises(TypeError):
            fn(a, xs.float())
        with pytest.raises(ValueError):
            fn(a, xs.cpu())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_ic0_strict_factor_k7_matches_plain(cuda_device, dtype):
    """K7 on the W-SELL strict factors of IC(0), as the Jacobi sweeps call it."""
    csr = _csr("laplace_3d_jittered", (16,), dtype, cuda_device)
    pre = smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=4,
                                            strict_layout="wsell")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(csr.shape[1]),
                        device=cuda_device).to(dtype)
    for tri in (pre.lower, pre.upper):
        ws = tri.wsell
        assert ws.sell.slots_per_nonzero <= ws.slot_ratio
        before = W.launches["wsell_spmv"]
        y = W.wsell_spmv(ws, x)
        torch.cuda.synchronize()
        assert W.launches["wsell_spmv"] == before + 1
        assert bits_equal(y, S.sell_spmv_plain(ws.sell, x))
        assert torch.equal(y, W.wsell_spmv_plain(ws, x))


@pytest.mark.parametrize("kind", ["wsell", "ell", "reorder", "ic0"])
def test_general_solves_match_cpu(cuda_device, kind):
    """f64 solves on the card (kernels) against the CPU (plain versions):
    the same status, iteration counts within 2 (the dots sum in other
    orders), x within 1e-6."""
    b = np.random.default_rng(2).standard_normal(16 ** 3 if kind != "reorder" else 32 * 32)
    res = {}
    for dev in ("cpu", cuda_device):
        if kind == "reorder":
            csr = smm.poisson_2d(32, device=dev)
            perm = np.random.default_rng(7).permutation(csr.shape[0])
            op = smm.reorder_to_wsell(smm.permute_csr(csr, perm), max_slot_ratio=64)
        else:
            csr = _csr("laplace_3d_jittered", (16,), torch.float64, dev)
            op = smm.ell_from_csr(csr) if kind == "ell" else smm.try_wsell_from_csr(csr)
        pre = (smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=4,
                                                 strict_layout="wsell")
               if kind == "ic0" else None)
        res[str(dev)] = smm.cg(op, torch.as_tensor(b, device=dev), epsilon=1e-8,
                               preconditioner=pre)
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert abs(gpu.iterations - cpu.iterations) <= 2
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-6


# -- the double-word DIA kernel: K9 (and K10, the same kernel) --------------------


def _df_dia(name, args, device):
    """A double-word DIA operator whose values are not exact in float32, so
    the lo planes are not zero."""
    csr = getattr(smm, name)(*args, dtype=torch.float64, device="cpu")
    data = csr.data.numpy() * (1.0 + 1e-9 * np.arange(csr.nnz))
    return smm.DfDiaMatrix.from_host_csr(data, csr.indices.numpy(), csr.indptr.numpy(),
                                         csr.shape, device=device)


@pytest.mark.parametrize("name,args", CASES, ids=[f"{n}{a}" for n, a in CASES])
def test_df_kernel_matches_plain(cuda_device, name, args):
    """K9 and its K10 wrapper against the plain version: both words bit for
    bit, guard rows exactly (0, 0), one launch each."""
    a = _df_dia(name, args, cuda_device)
    p = D.pad_dia_df(a)
    x = smm.df_from_host(np.random.default_rng(0).standard_normal(a.shape[1]),
                         device=cuda_device)
    xh, xl = p.to_padded(x[0]), p.to_padded(x[1])
    before = D.launches["dia_spmv_padded_df"]
    outs = [D.dia_spmv_padded_df(p, xh, xl), D.dia_spmv_streamed_df(p, xh, xl)]
    torch.cuda.synchronize()
    assert D.launches["dia_spmv_padded_df"] == before + 2
    ref = D.dia_spmv_padded_df_plain(p.hi.diags_p, p.lo.diags_p, p.offsets, p.lead, a.shape[0],
                                     xh, xl)
    for y in outs:
        for word, want in zip(y, ref):
            assert torch.equal(word, want)
            assert torch.all(word[:p.lead] == 0) and torch.all(word[p.lead + a.shape[0]:] == 0)


def test_df_kernel_random_values(cuda_device):
    """Random float64 diagonals and x over six orders of magnitude."""
    rng = np.random.default_rng(4)
    n, offsets = 5000, (-130, -1, 0, 3, 257)
    diags = rng.standard_normal((len(offsets), n)) * 10.0 ** rng.integers(-3, 3, (len(offsets), n))
    hi, lo = smm.df_from_host(diags, device=cuda_device)
    a = smm.DfDiaMatrix(diags_hi=hi, diags_lo=lo, offsets=offsets, shape=(n, n), nnz=0)
    p = D.pad_dia_df(a)
    x = smm.df_from_host(rng.standard_normal(n) * 10.0 ** rng.integers(-3, 3, n),
                         device=cuda_device)
    xh, xl = p.to_padded(x[0]), p.to_padded(x[1])
    yh, yl = D.dia_spmv_padded_df(p, xh, xl)
    rh, rl = D.dia_spmv_padded_df_plain(p.hi.diags_p, p.lo.diags_p, offsets, p.lead, n, xh, xl)
    assert torch.equal(yh, rh) and torch.equal(yl, rl)


def test_df_wrapper_raises_on_cuda(cuda_device):
    a = _df_dia("poisson_2d", (7,), cuda_device)
    p = D.pad_dia_df(a)
    xh = torch.zeros(p.n_total, device=cuda_device)
    with pytest.raises(TypeError):
        D.dia_spmv_padded_df(p, xh.double(), xh.double())
    with pytest.raises(ValueError):
        D.dia_spmv_padded_df(p, xh.cpu(), xh.cpu())


@pytest.mark.parametrize("solver", ["cg_df64", "bicgstab_df64", "cg_ir_df64",
                                    "bicgstab_ir_df64"])
def test_df_solves_match_cpu(cuda_device, solver):
    """The double-word solves on the card (K9 matvec; K2 and K4 in the
    refinement's inner solve) against the CPU (plain versions): the same
    status and rounds, iteration counts within 2 (within 5% for the f32
    inner solves, whose dots sum in other orders), x within 1e-10."""
    name = "poisson_2d" if solver.startswith("cg") else "convection_diffusion_2d"
    x_true = np.random.default_rng(5).standard_normal(24 * 24)
    res, launched = {}, {}
    for dev in ("cpu", cuda_device):
        a = _df_dia(name, (24,), dev)
        csr = getattr(smm, name)(24, dtype=torch.float64, device="cpu")
        b = (csr @ torch.from_numpy(x_true)).numpy()
        kw = {}
        if solver == "bicgstab_ir_df64":
            kw["preconditioner"] = PaddedSGS.from_dia(hi_operator(a), sweeps=4)
        before = {**D.launches, **K.launches, **T.launches}
        res[str(dev)] = getattr(smm, solver)(a, b, epsilon=1e-10, **kw)
        after = {**D.launches, **K.launches, **T.launches}
        launched[str(dev)] = {k: after[k] - before[k] for k in after}
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert gpu.outer_rounds == cpu.outer_rounds
    slack = 2 if cpu.outer_rounds is None else max(2, 0.05 * cpu.iterations)
    assert abs(gpu.iterations - cpu.iterations) <= slack
    x_gpu, x_cpu = gpu.x_f64(), cpu.x_f64()
    assert np.linalg.norm(x_gpu - x_cpu) <= 1e-10 * np.linalg.norm(x_cpu)
    n = launched[str(cuda_device)]
    assert all(v == 0 for v in launched["cpu"].values())
    if cpu.outer_rounds is None:
        assert n["dia_spmv_padded_df"] >= gpu.iterations
    else:
        assert n["dia_spmv_padded_df"] >= gpu.outer_rounds
        assert n["dia_spmv_padded"] >= gpu.iterations
        if solver == "bicgstab_ir_df64":
            assert n["sgs_apply"] >= 2 * gpu.iterations


# -- the stream gather of the routed chain: K11 -------------------------------------

ROUTED_CASES = [
    ("uniform", dict(n=20_000, per_row=5), {}),
    ("uniform_three_passes", dict(n=8_000, per_row=5), dict(window_f=4, leaf_slabs=1,
                                                             _digits=(2, 2, 2))),
    ("uniform_wf8", dict(n=8_000, per_row=5), dict(window_f=8)),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name,gen,kw", ROUTED_CASES, ids=[c[0] for c in ROUTED_CASES])
def test_stream_gather_matches_plain(cuda_device, name, gen, kw, dtype):
    csr = smm.uniform_random_csr(gen["n"], per_row=gen["per_row"], dtype=dtype,
                                 device=cuda_device)
    ra = smm.routed_from_csr(csr, max_slot_ratio=999.0, **kw)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(csr.shape[1]),
                        device=cuda_device).to(dtype)
    t = x
    for p in ra.passes:
        before = R.launches["stream_gather"]
        out = R.stream_gather(p.base, p.meta, p.vals, t, x_rows=p.x_rows, window_f=p.window_f)
        torch.cuda.synchronize()
        assert R.launches["stream_gather"] == before + 1
        assert out.shape == (p.out_len,)
        assert torch.equal(out, R.stream_gather_plain(p.base, p.meta, p.vals, t,
                                                      x_rows=p.x_rows, window_f=p.window_f))
        t = out
    n11, n7 = R.launches["stream_gather"], W.launches["wsell_spmv"]
    y = ra @ x
    torch.cuda.synchronize()
    assert R.launches["stream_gather"] == n11 + len(ra.passes)
    assert W.launches["wsell_spmv"] == n7 + 1
    assert bits_equal(y, S.sell_spmv_plain(ra.final.sell, t))
    assert torch.equal(y, W.wsell_spmv_plain(ra.final, t))
    ref = csr @ x
    tol = 1e-5 if dtype == torch.float32 else 1e-13
    assert (y - ref).abs().max() <= tol * ref.abs().max()


def test_stream_gather_wrapper_raises_on_cuda(cuda_device):
    csr = smm.uniform_random_csr(4_000, per_row=4, dtype=torch.float32, device=cuda_device)
    p = smm.routed_from_csr(csr, max_slot_ratio=999.0).passes[0]
    x = torch.ones(csr.shape[1], device=cuda_device)
    kw = dict(x_rows=p.x_rows, window_f=p.window_f)
    with pytest.raises(TypeError):
        R.stream_gather(p.base, p.meta, p.vals, x.double(), **kw)
    with pytest.raises(ValueError):
        R.stream_gather(p.base, p.meta, p.vals, x.cpu(), **kw)
    # a table shorter than x_rows * 128 reads zeros past its end
    padded = torch.zeros(p.x_rows * 128, device=cuda_device)
    padded[:x.shape[0]] = x
    assert torch.equal(R.stream_gather(p.base, p.meta, p.vals, x, **kw),
                       R.stream_gather(p.base, p.meta, p.vals, padded, **kw))
    # no vreg, no launch: the counter stays
    before = R.launches["stream_gather"]
    empty = R.stream_gather(p.base[:0], p.meta[:0], p.vals[:0], x, **kw)
    assert empty.shape == (0,) and R.launches["stream_gather"] == before


@pytest.mark.parametrize("method", ["bicgstab", "cgs", "bicg_symmetric", "cg"])
def test_front_door_solves_match_cpu(cuda_device, method):
    """solve(auto_format=True) on the card (kernels) against the CPU (plain
    versions), f64: the same layout, the same status, iteration counts within
    3 (the dots sum in other orders), x within 1e-6."""
    res = {}
    for dev in ("cpu", cuda_device):
        if method in ("bicgstab", "cgs"):
            csr = smm.uniform_random_csr(20_000, per_row=5, device=dev)
            expect = smm.RoutedMatrix
        else:
            csr = smm.poisson_2d(40, device=dev)
            expect = smm.GridStencilMatrix
        assert isinstance(smm.best_format(csr), expect)
        x_true = torch.as_tensor(np.random.default_rng(3).standard_normal(csr.shape[0]),
                                 device=dev)
        res[str(dev)] = smm.solve(csr, csr @ x_true, method=method, auto_format=True,
                                  epsilon=1e-9)
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert abs(gpu.iterations - cpu.iterations) <= 3
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-6


# -- the multi-RHS path: cg_multi, K8 every iteration ------------------------------


@pytest.mark.parametrize("kind", ["wsell", "ic0", "ell", "stencil"])
def test_cg_multi_matches_cpu(cuda_device, kind):
    """f64 multi-RHS solves on the card (K8 or the ELL panel kernel; the
    grid stencil's plain torch ops) against the CPU (plain versions): the
    same statuses, iteration counts within 2, x within 1e-6."""
    from sparse_matrix_math_tpu_torch.solvers import block

    res = {}
    for dev in ("cpu", cuda_device):
        if kind == "stencil":
            csr = smm.poisson_2d(24, dtype=torch.float64, device=dev)
        else:
            csr = _csr("laplace_3d_jittered", (16,), torch.float64, dev)
        b = torch.as_tensor(np.random.default_rng(2).standard_normal((csr.shape[0], 4)),
                            device=dev)
        op = {"wsell": smm.try_wsell_from_csr, "ic0": smm.try_wsell_from_csr,
              "ell": smm.ell_from_csr, "stencil": smm.try_grid_stencil_from_csr}[kind](csr)
        pre = (smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=4,
                                                 strict_layout="wsell")
               if kind == "ic0" else None)
        block.reset_loop_counts()
        n8 = W.launches["wsell_spmm"]
        res[str(dev)] = smm.cg_multi(op, b, epsilon=1e-8, preconditioner=pre)
        if dev != "cpu" and kind in ("wsell", "ic0"):
            c = block.loop_counts
            per = 7 if kind == "ic0" else 1
            want = per * (c["steps"] + c["rounds"] + 1) + c["residual_fixes"]
            assert W.launches["wsell_spmm"] - n8 == want
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status.tolist() == cpu.status.tolist() == [0] * 4
    assert (gpu.iterations.cpu() - cpu.iterations).abs().max() <= 2
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-6


# -- the solver tail: GMRES on K1, the multigrid V-cycle ----------------------------


@pytest.mark.parametrize("s_step", [1, 8])
@pytest.mark.parametrize("restart", [32, 16])
def test_gmres_matches_cpu(cuda_device, restart, s_step):
    """f64 GMRES(restart) on a DIA matrix on the card (every matvec one K1 launch,
    1 + 2 x cycles + matvecs in all) against the CPU (the plain product): the
    same status, iterations within 2, x within 1e-8."""
    import importlib

    G = importlib.import_module("sparse_matrix_math_tpu_torch.solvers.gmres")
    res = {}
    for dev in ("cpu", cuda_device):
        dia = smm.dia_from_csr(smm.convection_diffusion_2d(40, dtype=torch.float64, device=dev))
        b = torch.as_tensor(np.random.default_rng(4).standard_normal(1600), device=dev)
        k1 = K.launches["dia_spmv"]
        G.loop_counts.update(cycles=0, matvecs=0)
        res[str(dev)] = smm.gmres(dia, b, epsilon=1e-9, restart=restart, s_step=s_step)
        if dev != "cpu":
            c = G.loop_counts
            assert K.launches["dia_spmv"] - k1 == 1 + 2 * c["cycles"] + c["matvecs"]
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert abs(gpu.iterations - cpu.iterations) <= 2
    assert (gpu.x.cpu() - cpu.x).abs().max() <= 1e-8 * cpu.x.abs().max()


def test_multigrid_matches_cpu(cuda_device):
    """The V-cycle (plain torch ops) on the card: one apply within 1e-12 of the
    CPU's in f64, and PCG with it on an odd, anisotropic grid with the same
    status and iterations within 1."""
    res, z = {}, {}
    for dev in ("cpu", cuda_device):
        mg = smm.PoissonMultigrid.for_grid(45, 33, dtype=torch.float64, device=dev)
        r = torch.as_tensor(np.random.default_rng(5).standard_normal(45 * 33), device=dev)
        z[str(dev)] = mg.apply(r)
        a = smm.poisson_2d(45, 33, dtype=torch.float64, device=dev)
        res[str(dev)] = smm.cg(a, r, epsilon=1e-9, preconditioner=mg)
    zc, zg = z["cpu"], z[str(cuda_device)].cpu()
    assert (zg - zc).norm() <= 1e-12 * zc.norm()
    cpu, gpu = res["cpu"], res[str(cuda_device)]
    assert gpu.status == cpu.status == smm.SolverStatus.SUCCESS
    assert abs(gpu.iterations - cpu.iterations) <= 1


@pytest.fixture
def nccl_mesh(cuda_device, tmp_path):
    """A world of one rank on the card over NCCL (the group this machine
    can hold: NCCL refuses two ranks on one card)."""
    from sparse_matrix_math_tpu_torch import parallel

    mesh = parallel.init_distributed(f"file://{tmp_path / 'store'}", 1, 0,
                                     device=cuda_device)
    try:
        yield mesh
    finally:
        torch.distributed.destroy_process_group()


def _dist_jittered(mesh, dtype):
    from sparse_matrix_math_tpu_torch import parallel

    csr = smm.laplace_3d_jittered(16, jitter=4, symmetric=True, dtype=dtype, device="cpu")
    return csr, parallel.distribute_wsell(csr, mesh)


def test_halo_self_copy(nccl_mesh):
    """At world size 1 both neighbour blocks are the rank's own block, with
    no wire traffic (a ppermute to self)."""
    from sparse_matrix_math_tpu_torch.parallel import mesh as M

    x = torch.as_tensor(np.random.default_rng(2).standard_normal(4096), device=nccl_mesh.device)
    wire = M.collectives["halo_wire"]
    left, right = M.halo_exchange(x, nccl_mesh)
    assert bits_equal(left, x) and bits_equal(right, x)
    assert M.collectives["halo_wire"] == wire


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_dist_wsell_shard_is_k7(nccl_mesh, dtype):
    """One dist_wsell_spmv shard product on the card is one K7 launch, bit
    for bit the plain version over the same window layout."""
    from sparse_matrix_math_tpu_torch import parallel

    csr, d = _dist_jittered(nccl_mesh, dtype)
    assert d.local.vals.device.type == "cuda" and d.local.shape == (4096, 3 * 4096)
    x = np.random.default_rng(0).standard_normal(csr.shape[0])
    xl = parallel.distribute_vector(x, d).to(dtype)
    before = W.launches["wsell_spmv"]
    y = parallel.dist_wsell_spmv(d, xl)
    torch.cuda.synchronize()
    assert W.launches["wsell_spmv"] == before + 1
    window = torch.cat([xl, xl, xl])
    assert bits_equal(y, S.sell_spmv_plain(d.local.sell, window))


def test_dist_csr_solve_repeats(nccl_mesh):
    """A distributed CSR solve on the card repeats itself on the same b:
    BiCGStab + distributed SGS(4) in f64, whose count moves with any change
    of rounding, gives the same iterations and x bit for bit twice."""
    from sparse_matrix_math_tpu_torch import parallel as par

    csr = smm.poisson_2d(64, dtype=torch.float64, device="cpu")
    d = par.distribute_csr(csr, nccl_mesh)
    pre = par.distribute_preconditioner(
        smm.SGSPreconditioner.from_matrix(csr, method="jacobi", sweeps=4,
                                          strict_layout="csr"), d)
    b = np.random.default_rng(7).standard_normal(csr.shape[0])
    first, again = (par.dist_solve(d, b, solver="bicgstab", preconditioner=pre, epsilon=1e-9)
                    for _ in range(2))
    assert first.status == smm.SolverStatus.SUCCESS
    assert again.iterations == first.iterations and bits_equal(again.x, first.x)


@pytest.mark.parametrize("kind", ["csr", "dia", "stencil", "wsell"])
def test_dist_solves_on_card(nccl_mesh, kind):
    """f64 CG through each distributed entry point at world size 1 on the
    card against the single-device CG on the card: the same status,
    iterations within 1, x within 1e-8; the W-SELL solve launches K7 once
    per product (one halo exchange each)."""
    from sparse_matrix_math_tpu_torch import parallel as par
    from sparse_matrix_math_tpu_torch.parallel import mesh as M

    dev = nccl_mesh.device
    if kind == "wsell":
        csr, d = _dist_jittered(nccl_mesh, torch.float64)
        card = smm.laplace_3d_jittered(16, jitter=4, symmetric=True, dtype=torch.float64,
                                       device=dev)
    else:
        csr = smm.poisson_2d(64, dtype=torch.float64, device="cpu")
        card = smm.poisson_2d(64, dtype=torch.float64, device=dev)
        d = {"csr": lambda: par.distribute_csr(csr, nccl_mesh),
             "dia": lambda: par.distribute_dia(smm.dia_from_csr(csr), nccl_mesh),
             "stencil": lambda: par.distribute_stencil(smm.try_grid_stencil_from_csr(csr),
                                                       nccl_mesh)}[kind]()
    solve = {"csr": par.dist_solve, "dia": par.dist_dia_solve,
             "stencil": par.dist_stencil_solve, "wsell": par.dist_wsell_solve}[kind]
    b = np.random.default_rng(6).standard_normal(csr.shape[0])
    k7, halos = W.launches["wsell_spmv"], M.collectives["halo"]
    res = solve(d, b, epsilon=1e-9)
    k7, halos = W.launches["wsell_spmv"] - k7, M.collectives["halo"] - halos
    one = smm.cg(card, torch.as_tensor(b, device=dev), epsilon=1e-9)
    assert res.x.device == dev
    assert res.status == one.status == smm.SolverStatus.SUCCESS
    assert abs(res.iterations - one.iterations) <= 1
    x = par.collect(res.x, d)
    assert np.abs(x - one.x.cpu().numpy()).max() <= 1e-8 * np.abs(x).max()
    if kind == "wsell":
        assert k7 == halos >= res.iterations + 2


def _same_bits_in_8_runs(fn):
    first = fn()
    torch.cuda.synchronize()
    return first, all(bits_equal(first, fn()) for _ in range(7))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_row_sum_products_repeat(cuda_device, dtype):
    """The CSR product (a vector and a 2-D panel), the strict-triangular
    gather product and HYB's remainder sum each row in the entries' order
    (ops/spmv.py:row_sum): the same bits in 8 runs, and the bits of the CPU's
    sequential sum of the same products."""
    from sparse_matrix_math_tpu_torch.precond.trisolve import triangular_from_csr_arrays

    csr = smm.uniform_random_csr(200_000, per_row=9, dtype=dtype, device=cuda_device)
    cpu = smm.uniform_random_csr(200_000, per_row=9, dtype=dtype, device="cpu")
    g = np.random.default_rng(4)
    x = torch.as_tensor(g.standard_normal(200_000), device=cuda_device).to(dtype)
    xs = torch.as_tensor(g.standard_normal((200_000, 3)), device=cuda_device).to(dtype)
    for v in (x, xs):
        y, same = _same_bits_in_8_runs(lambda: csr @ v)
        assert same and bits_equal(y.cpu(), cpu @ v.cpu())
    # a lower-triangular factor: the strict lower entries and a diagonal of
    # 10; its strict part runs the gather path
    r, c, v = cpu.row_ids.numpy(), cpu.indices.numpy(), cpu.data.numpy()
    keep = c < r
    diag = np.arange(200_000)
    rows, cols = np.concatenate([r[keep], diag]), np.concatenate([c[keep], diag])
    vals = np.concatenate([v[keep], np.full(200_000, 10.0, v.dtype)])
    order = np.lexsort((cols, rows))
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=200_000))])
    tri = {dev: triangular_from_csr_arrays(vals[order], cols[order], indptr, lower=True,
                                           method="jacobi", sweeps=3, strict_layout="csr",
                                           device=dev)
           for dev in (cuda_device, "cpu")}
    assert tri[cuda_device].wsell is None
    z, same = _same_bits_in_8_runs(lambda: tri[cuda_device]._strict_matvec(x))
    assert same and bits_equal(z.cpu(), tri["cpu"]._strict_matvec(x.cpu()))
    # HYB: the remainder past the dominant diagonals is a CSR product
    hyb = smm.hyb_from_csr(csr)
    assert hyb.rest is not None
    _, same = _same_bits_in_8_runs(lambda: hyb @ x)
    assert same


def test_generic_bicgstab_sgs_repeats(cuda_device, monkeypatch):
    """The generic preconditioned solve (CSR products and SGS(4) gather
    sweeps, no autoroute) gives the same count and x bit for bit on the same
    b: with ``index_add_``'s atomics its count moved from call to call."""
    monkeypatch.setenv("SMM_NO_AUTOROUTE", "1")
    a = smm.poisson_2d(400, dtype=torch.float64, device=cuda_device)
    b = a @ torch.ones(a.shape[0], dtype=torch.float64, device=cuda_device)
    sgs = smm.SGSPreconditioner.from_matrix(a, method="jacobi", sweeps=4, strict_layout="csr")
    runs = [smm.bicgstab(a, b, preconditioner=sgs, epsilon=1e-8, max_iterations=5000)
            for _ in range(3)]
    assert runs[0].status == smm.SolverStatus.SUCCESS
    for r in runs[1:]:
        assert r.iterations == runs[0].iterations and bits_equal(r.x, runs[0].x)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
def test_dist_rsell_shard_is_k11_then_k7(nccl_mesh, dtype):
    """One dist_routed_spmv shard product on the card is one K11 launch per
    routing pass, then one K7 launch, bit for bit the plain versions of the
    same chain; and a routed solve at world size 1 ends as the single-device
    solve on the card does."""
    from sparse_matrix_math_tpu_torch import parallel as par

    csr = smm.uniform_random_csr(20_000, per_row=5, dtype=dtype, device="cpu")
    d = par.distribute_routed(csr, nccl_mesh)
    assert d.local.final.vals.device.type == "cuda" and d.n_passes >= 1
    x = np.random.default_rng(0).standard_normal(csr.shape[0])
    xl = par.distribute_vector(x, d).to(dtype)
    k11, k7 = R.launches["stream_gather"], W.launches["wsell_spmv"]
    y = par.dist_routed_spmv(d, xl)
    torch.cuda.synchronize()
    assert R.launches["stream_gather"] == k11 + d.n_passes
    assert W.launches["wsell_spmv"] == k7 + 1
    t = xl
    for p in d.local.passes:
        t = R.stream_gather_plain(p.base, p.meta, p.vals, t, x_rows=p.x_rows,
                                  window_f=p.window_f)
    assert bits_equal(y, S.sell_spmv_plain(d.local.final.sell, t))
    b = (csr @ torch.ones(csr.shape[0], dtype=dtype)).numpy()
    eps = 1e-4 if dtype == torch.float32 else 1e-9
    res = par.dist_routed_solve(d, b, epsilon=eps)
    single = smm.routed_from_csr(smm.uniform_random_csr(20_000, per_row=5, dtype=dtype,
                                                        device=nccl_mesh.device))
    one = smm.bicgstab(single, torch.as_tensor(b, device=nccl_mesh.device), epsilon=eps)
    assert res.status == one.status == smm.SolverStatus.SUCCESS
    assert abs(res.iterations - one.iterations) <= max(2, one.iterations // 10)
    assert np.abs(par.collect(res.x, d) - 1.0).max() < (1e-3 if dtype == torch.float32 else 1e-6)


@pytest.mark.parametrize("kind", ["df64", "multigrid"])
def test_dist_df64_and_multigrid_on_card(nccl_mesh, kind):
    """dist_cg_ir_df64 and dist_mg_solve (PCG) at world size 1 on the card
    against the single-device solves on the card: the same status, rounds
    and inner iterations within 5% (df64), the same count (multigrid)."""
    from sparse_matrix_math_tpu_torch import parallel as par

    dev = nccl_mesh.device
    if kind == "df64":
        p = smm.poisson_2d(64, dtype=torch.float64, device="cpu")
        host = (p.data.numpy(), p.indices.numpy(), p.indptr.numpy())
        dfa = smm.df_operator_from_host_csr(*host, p.shape, device=dev)
        b = np.add.reduceat(host[0], host[2][:-1])
        res = par.dist_cg_ir_df64(par.distribute_df_dia(dfa, nccl_mesh), b, epsilon=1e-10)
        one = smm.cg_ir_df64(dfa, b, epsilon=1e-10)
        assert res.status == one.status == smm.SolverStatus.SUCCESS
        assert abs(res.outer_rounds - one.outer_rounds) <= 1
        assert abs(res.iterations - one.iterations) <= max(3, one.iterations // 20)
        x = res.x_f64()
        assert np.linalg.norm(b - np.add.reduceat(host[0] * x[host[1]], host[2][:-1])) <= 1e-10
    else:
        a = smm.poisson_2d(96, dtype=torch.float32, device=dev)
        mg = smm.PoissonMultigrid.for_grid(96, device=dev)
        b = a @ torch.ones(a.shape[0], dtype=torch.float32, device=dev)
        res = par.dist_mg_solve(par.distribute_multigrid(mg, nccl_mesh), b, epsilon=1e-4)
        one = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
        assert res.status == one.status == smm.SolverStatus.SUCCESS
        assert res.iterations == one.iterations
        assert float((res.x - 1.0).abs().max()) < 5e-4
