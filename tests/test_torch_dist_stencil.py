"""The port's distributed matrix-free grid stencils
(sparse_matrix_math_tpu_torch/parallel/dist_stencil.py) on gloo CPU worlds of
1, 2 and 4 ranks, held against the JAX package's on meshes of as many of the
conftest's virtual devices: twin of tests/test_dist_stencil.py.

The rank-side cases are in tests/torch_dist_ranks.py, the tolerances in
tests/torch_dist_check.py.  Iteration bands: CG and BiCGSymmetric within 1,
BiCGStab max(3, 5%), CGS max(3, 20%) (float64 throughout).

The CGS band rests on a measured spread.  ``convection_diffusion_2d(30)``,
b = row sums, eps 1e-10: the two packages' CGS recurrences are the same
line for line (solvers/cgs.py), and only the summation order of the dots
moves the count, every run ending in SUCCESS.  JAX's ``dist_stencil_solve``
on meshes of 1 / 2 / 4 / 8 devices: 108 / 104 / 109 / 113; JAX's
single-device ``cgs_core`` on the CSR with ``jnp.vdot`` / ``sum(u * v)``:
102 / 111.  The port at 1 / 2 / 4 ranks with the local dot as
``torch.dot``: 97 / 102 / 114; ``torch.sum(u * v)``: 104 / 107 / 112; a
pairwise tree: 98 / 110 / 106; ``math.fsum``: 111 / 105 / 95; a sequential
sum: 113 / 94 / 98.  Every count lies in [94, 114]: two summation orders
differ by up to 20 iterations, 19-21% of the counts, and ``torch.dot``'s
own order depends on the machine's vector width.
"""

import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

from sparse_matrix_math_tpu.formats.stencil import try_grid_stencil_from_csr
from sparse_matrix_math_tpu.parallel import (
    collect,
    dist_stencil_solve,
    dist_stencil_spmv,
    distribute_stencil,
    distribute_vector,
    make_mesh,
)
from sparse_matrix_math_tpu.utils import generate as jgen
from torch_dist_check import (
    WORLDS,
    band,
    check_product,
    check_self,
    check_solve,
    ok,
    run_port,
    scipy_csr,
)
from torch_dist_ranks import CASES, STENCIL_SOLVES, STENCIL_SPMV

NAMES = [n for n in CASES if n.startswith("stencil_")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, NAMES)


def _distributed(name, nx, k):
    a = getattr(jgen, name)(nx, dtype=np.float64)
    st = try_grid_stencil_from_csr(a)
    assert st is not None
    mesh = make_mesh(k)
    return a, distribute_stencil(st, mesh), mesh


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("name", list(STENCIL_SPMV))
def test_spmv_matches_dense(port, name, k):
    a, ds, mesh = _distributed(name, STENCIL_SPMV[name], k)
    x = np.random.default_rng(0).standard_normal(a.shape[0])
    want = collect(dist_stencil_spmv(ds, distribute_vector(x, ds, mesh), mesh), ds)
    got = ok(port, k, f"stencil_spmv_{name}")
    a_sp = scipy_csr(a)
    check_product(got, want, a_sp, x, np.float64)
    check_product(got, np.asarray(a.to_dense()) @ x, a_sp, x, np.float64)
    check_product(got, ok(port, 1, f"stencil_spmv_{name}"), a_sp, x, np.float64)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("name,solver", STENCIL_SOLVES)
def test_solve_all_ones_oracle(port, name, solver, k):
    a, ds, mesh = _distributed(name, 30, k)
    b = np.asarray(a.to_dense()).sum(axis=1)  # rhs = row sums -> x = 1
    jres = dist_stencil_solve(ds, b, solver=solver, epsilon=1e-10)
    case = f"stencil_solve_{name}_{solver}"
    got = ok(port, k, case)
    its = int(jres.iterations)
    b_its = {"cg": 1, "bicg_symmetric": 1, "bicgstab": band(its, 0.05, 3),
             "cgs": band(its, 0.20, 3)}[solver]
    a_sp = scipy_csr(a)
    check_solve(got, jres, collect(jres.x, ds), a_sp, b, b_its, 1e-10)
    assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() < 1e-8
    check_self(port, k, case, a_sp, b, b_its)


@pytest.mark.parametrize("k", WORLDS)
def test_solve_matches_single_chip(port, k):
    a, ds, mesh = _distributed("poisson_2d", 24, k)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    jres = dist_stencil_solve(ds, b, solver="cg", epsilon=1e-11)
    got = ok(port, k, "stencil_single_chip")
    a_sp = scipy_csr(a)
    check_solve(got, jres, collect(jres.x, ds), a_sp, b, 1, 1e-11)
    check_self(port, k, "stencil_single_chip", a_sp, b, 1)
