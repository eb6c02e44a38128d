"""The port's CUDA kernels on a card (skipped without one).

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Kernel and plain version round every product and sum alike in the same
order, so they are compared for equality.
"""

import numpy as np
import pytest
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.ops import dia_spmv as K

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
        pytest.skip("needs a CUDA card: the DIA kernels run only there")
    return torch.device("cuda", 0)


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
