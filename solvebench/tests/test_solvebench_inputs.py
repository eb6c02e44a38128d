"""The benchmark's inputs and yardstick on the CPU: the device generator
against the port's host generators, the plain reference against a dense
NumPy product, and the roofline models against counts by hand."""

import numpy as np
import pytest
import torch

from solvebench import generate, reference, roofline
from solvebench.operators import stencil
from sparse_matrix_math_tpu_torch import CSRMatrix
from sparse_matrix_math_tpu_torch.utils.generate import (poisson_2d, poisson_3d,
                                                         poisson_3d_27pt)

DIAGONAL = {5: 4.0, 7: 6.0, 9: 8.0, 27: 26.0}


def _cfg(points, grid, dtype="float64"):
    return {"name": "t", "operator": "stencil", "grid": list(grid), "dtype": dtype,
            "tolerance": 1e-8,
            "stencil": {"points": points, "diagonal": DIAGONAL[points], "neighbour": -1.0}}


@pytest.mark.parametrize("points, port_gen", [(7, poisson_3d), (27, poisson_3d_27pt)])
@pytest.mark.parametrize("grid", [(3, 3, 3), (5, 4, 3), (3, 4, 6), (7, 7, 7)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_generator_equals_the_ports_entry_for_entry(points, port_gen, grid, dtype):
    nx, ny, nz = grid
    ours = generate.operator_csr(_cfg(points, grid), torch.device("cpu"), dtype, CSRMatrix)
    theirs = port_gen(nx, ny, nz, dtype=dtype, device="cpu")
    assert ours.shape == theirs.shape
    for name in ("indptr", "indices", "row_ids"):
        assert torch.equal(getattr(ours, name), getattr(theirs, name)), name
    assert ours.data.dtype == theirs.data.dtype == dtype
    assert torch.equal(ours.data, theirs.data)


@pytest.mark.parametrize("grid", [(3, 3), (5, 4), (2, 7), (9, 9)])
def test_2d_generator_equals_the_ports_poisson_2d(grid):
    ours = generate.operator_csr(_cfg(5, grid), torch.device("cpu"), torch.float32, CSRMatrix)
    theirs = poisson_2d(*grid, dtype=torch.float32, device="cpu")
    for name in ("indptr", "indices", "row_ids", "data"):
        assert torch.equal(getattr(ours, name), getattr(theirs, name)), name


def _hpcg_nonzeros(n):
    """27 a row, less the neighbours past the boundary: 3 per axis inside,
    2 on either face."""
    return ((n - 2) * 3 + 2 * 2) ** 3


def test_hpcg_size_counts():
    assert _hpcg_nonzeros(128) == 55_742_968
    assert _hpcg_nonzeros(256) == 449_455_096
    csr = generate.operator_csr(_cfg(27, (6, 6, 6)), torch.device("cpu"), torch.float64,
                                CSRMatrix)
    assert csr.indices.shape[0] == _hpcg_nonzeros(6)


def _dense(cfg):
    csr = generate.operator_csr(cfg, torch.device("cpu"), torch.float64, CSRMatrix)
    a = np.zeros(csr.shape)
    a[csr.row_ids.numpy(), csr.indices.numpy()] = csr.data.numpy()
    return a


@pytest.mark.parametrize("points, grid", [(7, (4, 5, 3)), (27, (4, 5, 3)), (5, (6, 4)),
                                          (9, (6, 4))])
def test_reference_product_and_residual_against_dense_numpy(points, grid):
    cfg = _cfg(points, grid)
    a = _dense(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(a.shape[0])
    b = rng.standard_normal(a.shape[0])
    ax = reference.apply(cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ax, a @ x, rtol=0, atol=1e-12)
    want = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    got = reference.relative_residual(cfg, torch.from_numpy(x), torch.from_numpy(b))
    assert got == pytest.approx(want, rel=1e-12)


def test_reference_residual_of_a_bad_answer_is_infinite():
    cfg = _cfg(7, (3, 3, 3))
    b = torch.ones(27, dtype=torch.float64)
    assert reference.relative_residual(cfg, torch.full((27,), float("nan")), b) == np.inf
    assert reference.relative_residual(cfg, torch.ones(26), b) == np.inf


def test_operators_are_found_by_name_and_refuse_what_they_do_not_define():
    assert reference.operator(_cfg(7, (3, 3, 3))) is stencil
    for name in ("../run", "stencil.x", ""):
        with pytest.raises(ValueError):
            reference.operator(dict(_cfg(7, (3, 3, 3)), operator=name))
    with pytest.raises(ModuleNotFoundError):
        reference.operator(dict(_cfg(7, (3, 3, 3)), operator="no_such_operator"))
    with pytest.raises(ValueError):
        stencil.offsets(_cfg(7, (3, 3)))  # 7 points on two axes


def test_rhs_pool_is_a_x_of_the_perturbed_ones():
    cfg = _cfg(27, (4, 4, 5))
    cpu = torch.device("cpu")
    pool, norms = generate.rhs_pool(cfg, 2**31 + 7, 8, 0.05, cpu, torch.float64)
    again, _ = generate.rhs_pool(cfg, 2**31 + 7, 8, 0.05, cpu, torch.float64)
    order = generate.rhs_order(2**31 + 7, 8)
    a = _dense(cfg)
    for k, b in enumerate(pool):
        gen = torch.Generator().manual_seed(generate.rhs_seed(order[k]))
        x = 1.0 + 0.05 * (2.0 * torch.rand(a.shape[0], generator=gen, dtype=torch.float64) - 1)
        assert float((x - 1).abs().max()) <= 0.05
        np.testing.assert_allclose(b.numpy(), a @ x.numpy(), rtol=0, atol=1e-12)
        assert torch.equal(b, again[k])
        assert norms[k] == pytest.approx(float(torch.linalg.vector_norm(b)))
    assert not torch.equal(pool[0], pool[1])


def test_every_seed_takes_the_same_set_in_its_own_order():
    cfg = _cfg(27, (4, 4, 5))
    cpu = torch.device("cpu")
    seeds = (2**31 + 7, 2**31 + 8, 5 * 2**40 + 3)
    orders = [generate.rhs_order(seed, 8) for seed in seeds]
    assert all(sorted(order) == list(range(8)) for order in orders)
    assert len({tuple(order) for order in orders}) == len(seeds)
    base, _ = generate.rhs_pool(cfg, seeds[0], 8, 0.05, cpu, torch.float64)
    by_member = {m: base[i] for i, m in enumerate(orders[0])}
    for seed, order in zip(seeds[1:], orders[1:]):
        pool, _ = generate.rhs_pool(cfg, seed, 8, 0.05, cpu, torch.float64)
        for i, m in enumerate(order):
            assert torch.equal(pool[i], by_member[m])


def test_roofline_models_by_hand():
    f64 = _cfg(27, (256, 256, 256))
    f32 = _cfg(7, (243, 243, 243), "float32")
    n64, n32 = 256 ** 3, 243 ** 3
    assert roofline.product_flops(f64) == 2 * 27 * n64
    assert roofline.product_flops(f32) == 2 * 7 * n32
    assert roofline.product_flops(_cfg(5, (10, 10))) == 2 * 5 * 100
    # 4 sweeps of each triangle, 2 k + 1 flops a row each, and D y once
    assert roofline.sgs_flops(f64, 4) == (8 * 27 + 1) * n64
    assert roofline.sgs_flops(f32, 4) == (8 * 7 + 1) * n32
    # both bound by bytes: one vector read, one written, no matrix values
    assert roofline.least_seconds(f64, roofline.sgs_flops(f64, 4)) == pytest.approx(
        2 * n64 * 8 / 3.35e12)
    assert roofline.least_seconds(f32, roofline.product_flops(f32)) == pytest.approx(
        2 * n32 * 4 / 3.35e12)
    # bound by flops where the flops are many enough
    many = 10 ** 12
    assert roofline.least_seconds(f32, many) == pytest.approx(many / 67e12)


@pytest.mark.parametrize("points, grid", [(7, (5, 5, 5)), (27, (5, 5, 5)), (5, (5, 5)),
                                          (9, (5, 5))])
def test_stencil_points_ascend_by_flat_offset(points, grid):
    pts = stencil.offsets(_cfg(points, grid))
    assert len(pts) == points == stencil.points(_cfg(points, grid))
    flat = [sum(o * 5 ** (len(off) - 1 - a) for a, o in enumerate(off)) for off, _ in pts]
    assert flat == sorted(flat)
    assert sum(c for _, c in pts) == 0.0  # -1 around, the diagonal balances
