"""The port's distributed multigrid (sparse_matrix_math_tpu_torch/parallel/dist_multigrid.py)
on gloo CPU worlds of 1, 2 and 4 ranks, held against the JAX package's on
meshes of as many of the conftest's virtual devices: twin of
tests/test_dist_multigrid.py, at its sizes (V-cycles at nx 96, 90, 48 and
40 x 72; PCG at 96 and 20^3, CG at 48, the stationary iteration at 90).

The rank-side cases are in tests/torch_dist_ranks.py.  Bounds (float32):
one V-cycle within 2e-5 of max |z| of JAX's distributed and single-device
V-cycles (JAX's own bound); PCG and the stationary iteration JAX's status
and exactly its iteration count, which is also the single-device count of
either package; plain CG JAX's status and its count within 1; x = 1 within
5e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

from sparse_matrix_math_tpu.parallel import (
    dist_mg_solve,
    dist_mg_vcycle,
    distribute_multigrid,
    make_mesh,
)
from sparse_matrix_math_tpu.solvers import cg
from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid
from sparse_matrix_math_tpu.solvers.types import SolverStatus
from sparse_matrix_math_tpu.utils.generate import poisson_2d, poisson_3d
from torch_dist_check import WORLDS, ok, raised, run_port
from torch_dist_ranks import CASES, MG_SOLVES, MG_VCYCLE_GRIDS

NAMES = [n for n in CASES if n.startswith("mg_")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_port(tmp_path_factory, NAMES)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("name", list(MG_VCYCLE_GRIDS))
def test_vcycle_matches_jax(port, name, k):
    """One distributed V-cycle against JAX's distributed one and the
    single-device one: even 96, odd 90, shallow 48, rectangular 40 x 72."""
    grid = MG_VCYCLE_GRIDS[name]
    mg = PoissonMultigrid.for_grid(*grid)
    mesh = make_mesh(k)
    dmg = distribute_multigrid(mg, mesh)
    n = int(np.prod(mg.dims[0]))
    r = jnp.asarray(np.random.default_rng(grid[0] if len(grid) == 1 else 7)
                    .standard_normal(n).astype(np.float32))
    z_ref = np.asarray(mg.apply(r))
    z_jax = np.asarray(dist_mg_vcycle(dmg, r, mesh))
    got = ok(port, k, f"mg_vcycle_{name}")
    assert got["levels"] == dmg.n_levels_dist and got["m0s"] == dmg.m0s
    scale = np.abs(z_ref).max()
    np.testing.assert_allclose(got["z"], z_jax, atol=2e-5 * scale)
    np.testing.assert_allclose(got["z"], z_ref, atol=2e-5 * scale)


@pytest.mark.parametrize("k", WORLDS)
@pytest.mark.parametrize("name", list(MG_SOLVES))
def test_solve_matches_jax(port, name, k):
    solver, grid, eps = MG_SOLVES[name]
    a = (poisson_2d(grid[0], dtype=np.float32) if len(grid) == 1
         else poisson_3d(grid[0], dtype=np.float32))
    mg = PoissonMultigrid.for_grid(*grid)
    b = a @ jnp.ones(a.shape[0], jnp.float32)
    mesh = make_mesh(k)
    jres = dist_mg_solve(distribute_multigrid(mg, mesh), b, solver=solver, epsilon=eps,
                         mesh=mesh)
    got = ok(port, k, f"mg_solve_{name}")
    assert got["status"] == int(jres.status) == SolverStatus.SUCCESS
    its = int(jres.iterations)
    if solver == "cg":
        assert abs(got["iterations"] - its) <= 1, (got["iterations"], its)
    else:
        # the same count as JAX's distributed solve and both single-device ones
        single = (mg.solve(b, epsilon=eps) if solver == "mg"
                  else cg(a, b, epsilon=eps, preconditioner=mg))
        assert got["iterations"] == its == int(single.iterations), (
            got["iterations"], its, int(single.iterations))
        assert got["single_iterations"] == its
    np.testing.assert_allclose(got["x"], 1.0, atol=5e-4)


@pytest.mark.parametrize("k", WORLDS)
def test_rejects_unknown_solver(port, k):
    mesh = make_mesh(k)
    dmg = distribute_multigrid(PoissonMultigrid.for_grid(48), mesh)
    with pytest.raises(ValueError):
        dist_mg_solve(dmg, jnp.ones(48 * 48), solver="gmres", mesh=mesh)
    err = raised(port, k, "mg_unknown_solver")
    assert err is not None and err[0] == "ValueError", err
