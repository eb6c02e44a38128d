"""The port's geometric multigrid (solvers/multigrid.py) held against the JAX
package's, and ``preconditioner="multigrid"`` through both front doors.

* The hierarchy: the port's ``for_grid`` builds the JAX package's levels,
  factors, Jacobi weights and coarsest inverse (the same NumPy float64 code,
  cast alike), on odd, even, anisotropic 2-D and 3-D grids.
* The V-cycle on a hierarchy carried across (``interop.multigrid_from_numpy``
  of the JAX object's arrays): relative error of ``apply`` within 1e-12 in
  f64 and 1e-5 in f32; symmetric and linear.
* ``for_stencil`` maps the stencil's row-major dims onto ``for_grid``'s
  order (anisotropic, odd sides catch a swap) and refuses other stencils.
* ``solve`` (stationary V-cycles) and PCG with the V-cycle: status and
  iterations equal (CG within 1) in f64, x within 1e-8 of ||x||; f32
  iterations within max(3, 10%).
* The front door (twins of tests/test_floor_escalation.py:152-215): the 1e-8
  contract on a 3-D stencil pre-routed to the refinement with the V-cycle
  inside (rounds and inner iterations against the JAX package's), a
  preconditioner object passed through, the Poisson family
  verified from CSR and DIA, other operators refused with ``ValueError``,
  and GMRES pre-routed to the nonsymmetric refinement.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.solvers.multigrid import PoissonMultigrid as JaxMG
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch import interop
from test_torch_wsell import port_csr

S = smm.SolverStatus
GRIDS = [(63,), (48, 36), (37, 23), (13, 9, 11), (17, 17, 17)]
# the V-cycle cases: odd and anisotropic sides in 2-D and 3-D, and a 3-D grid
# that coarsens (each compiles the JAX package's V-cycle once per dtype)
VCYCLE_GRIDS = [(37, 23), (13, 9, 11), (17, 17, 17)]


def carried(jmg):
    """The port's PoissonMultigrid on the JAX object's arrays."""
    return interop.multigrid_from_numpy(
        np.asarray(jmg.coarse_inv),
        [[[np.asarray(v) for v in axis] for axis in level] for level in jmg.factors],
        [np.asarray(w) for w in jmg.winv], jmg.dims, jmg.nu1, jmg.nu2, jmg.omega, "cpu")


def generator(grid, dtype):
    return (jax_gen.poisson_3d(*grid[:1], dtype=dtype) if len(grid) == 3 and
            len(set(grid)) == 1 else jax_gen.poisson_2d(*grid, dtype=dtype))


@pytest.mark.parametrize("grid", GRIDS, ids=[str(g) for g in GRIDS])
def test_hierarchy_matches_jax(grid):
    jmg = JaxMG.for_grid(*grid, dtype=jnp.float64)
    tmg = smm.PoissonMultigrid.for_grid(*grid, dtype=torch.float64, device="cpu")
    assert tmg.dims == jmg.dims and (tmg.nu1, tmg.nu2, tmg.omega) == (2, 2, 0.8)
    np.testing.assert_array_equal(tmg.coarse_inv.numpy(), np.asarray(jmg.coarse_inv))
    for tl, jl in zip(tmg.factors, jmg.factors, strict=True):
        for ta, ja in zip(tl, jl, strict=True):
            for tv, jv in zip(ta, ja, strict=True):
                np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for tw, jw in zip(tmg.winv, jmg.winv, strict=True):
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
@pytest.mark.parametrize("grid", VCYCLE_GRIDS, ids=[str(g) for g in VCYCLE_GRIDS])
def test_vcycle_on_carried_hierarchy(grid, dtype, tol):
    jmg = JaxMG.for_grid(*grid, dtype=jnp.dtype(dtype))
    tmg = carried(jmg)
    n = int(np.prod(grid)) if len(grid) > 1 else grid[0] ** 2
    r = np.random.default_rng(0).standard_normal(n).astype(dtype)
    want = np.asarray(jmg.apply(jnp.asarray(r)), np.float64)
    got = tmg.apply(torch.from_numpy(r)).double().numpy()
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def test_vcycle_symmetric_and_linear():
    mg = smm.PoissonMultigrid.for_grid(40, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(1)
    u, v = (torch.from_numpy(rng.standard_normal(1600)) for _ in range(2))
    mu, mv = mg.apply(u), mg.apply(v)
    assert float(u @ mv) == pytest.approx(float(mu @ v), rel=1e-10)
    np.testing.assert_allclose(mg.apply(2.0 * u - 0.5 * v).numpy(), (2.0 * mu - 0.5 * mv).numpy(),
                               rtol=1e-10, atol=1e-12)


def laplacian_stencils(grid):
    """The dimensionless Laplacian on an nx x ny (x nz) grid as the JAX
    package's GridStencilMatrix and the port's: dims row-major, (ny, nx) or
    (nz, ny, nx)."""
    from sparse_matrix_math_tpu.formats.stencil import GridStencilMatrix as JaxStencil

    d = len(grid)
    dims = tuple(reversed(grid))
    doffs = [(0,) * d]
    for ax in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[ax] = s
            doffs.append(tuple(off))
    coeffs = np.array([2.0 * d] + [-1.0] * (2 * d), np.float32)
    n = int(np.prod(grid))
    jst = JaxStencil(coeffs=jnp.asarray(coeffs), doffs=tuple(doffs), dims=dims, shape=(n, n),
                     nnz=0)
    return jst, interop.grid_stencil_from_numpy(coeffs, doffs, dims, (n, n), 0, "cpu")


@pytest.mark.parametrize("grid", [(15, 9), (9, 7, 5)], ids=["2d", "3d"])
def test_for_stencil_dims_and_refusal(grid):
    jst, tst = laplacian_stencils(grid)
    jmg, tmg = JaxMG.for_stencil(jst), smm.PoissonMultigrid.for_stencil(tst)
    assert tmg.dims == jmg.dims and tmg.dims[0] == tuple(jst.dims)
    assert tmg.coarse_inv.dtype == torch.float32
    r = np.random.default_rng(2).standard_normal(int(np.prod(jst.dims))).astype(np.float32)
    want = np.asarray(jmg.apply(jnp.asarray(r)))
    assert np.linalg.norm(tmg.apply(torch.from_numpy(r)).numpy() - want) <= (
        1e-5 * np.linalg.norm(want))
    bad = interop.grid_stencil_from_numpy(2.0 * np.asarray(jst.coeffs), jst.doffs, jst.dims,
                                          jst.shape, jst.nnz, "cpu")
    with pytest.raises(ValueError, match="Laplacian"):
        smm.PoissonMultigrid.for_stencil(bad)


@pytest.mark.parametrize("grid,eps", [((19, 19, 19), 1e-8), ((64, 48), 1e-8), ((63,), 1e-10)],
                         ids=["3d-odd", "2d-rect", "2d-odd"])
def test_stationary_solve_matches_jax(grid, eps):
    jcsr = (jax_gen.poisson_3d(grid[0], dtype=np.float64) if len(grid) == 3
            else jax_gen.poisson_2d(*grid, dtype=np.float64))
    b = np.random.default_rng(3).standard_normal(jcsr.shape[0])
    jmg = JaxMG.for_grid(*grid, dtype=jnp.float64)
    jres = jmg.solve(jnp.asarray(b), epsilon=eps, max_iterations=60)
    tres = carried(jmg).solve(torch.from_numpy(b), epsilon=eps, max_iterations=60)
    assert tres.status == int(jres.status) == int(S.SUCCESS)
    assert tres.iterations == int(jres.iterations)
    jx = np.asarray(jres.x)
    assert np.linalg.norm(tres.x.numpy() - jx) <= 1e-8 * np.linalg.norm(jx)
    capped = carried(jmg).solve(torch.from_numpy(b), epsilon=1e-30, max_iterations=2)
    assert capped.status == int(S.MAX_ITERATIONS_REACHED) and capped.iterations == 2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("grid", [(48, 36), (17, 17, 17)], ids=["2d-rect", "3d"])
def test_pcg_with_vcycle_matches_jax(grid, dtype):
    jcsr = generator(grid, dtype)
    b = np.asarray(jcsr @ jnp.ones(jcsr.shape[0], dtype))
    eps = 1e-8 if dtype == np.float64 else 1e-4
    jmg = JaxMG.for_grid(*grid, dtype=jnp.dtype(dtype))
    jres = jsmm.cg(jcsr, jnp.asarray(b), epsilon=eps, preconditioner=jmg)
    tres = smm.cg(port_csr(jcsr), torch.from_numpy(b.copy()), epsilon=eps,
                  preconditioner=carried(jmg))
    assert tres.status == int(jres.status) == int(S.SUCCESS)
    its = int(jres.iterations)
    assert its <= 15
    assert abs(tres.iterations - its) <= (1 if dtype == np.float64 else max(3, its // 10))
    jx = np.asarray(jres.x, np.float64)
    xtol = 1e-8 if dtype == np.float64 else 1e-3
    assert np.linalg.norm(tres.x.double().numpy() - jx) <= xtol * np.linalg.norm(jx)


# -- the front door ---------------------------------------------------------


def _stencil_3d(m):
    a64 = jax_gen.poisson_3d(m, dtype=np.float64)
    jst, tst = laplacian_stencils((m, m, m))
    data = np.asarray(a64.data, np.float64)
    iptr = np.asarray(a64.indptr, np.int64)
    return a64, jst, tst, np.add.reduceat(data, iptr[:-1])


def _true_res(a64, b64, x):
    import scipy.sparse as sp

    a = sp.csr_matrix((np.asarray(a64.data), np.asarray(a64.indices), np.asarray(a64.indptr)),
                      shape=a64.shape)
    return float(np.linalg.norm(b64 - a @ x))


@pytest.mark.parametrize("pre", ["multigrid", "object"])
def test_front_door_3d_contract_to_1e8(pre):
    """solve(stencil, f32 b, epsilon=1e-8, preconditioner="multigrid") is
    pre-routed to the double-word refinement with the V-cycle inside and
    meets the f64 contract, as in the JAX package."""
    a64, jst, tst, b64 = _stencil_3d(13 if pre == "multigrid" else 9)
    kind = "multigrid" if pre == "multigrid" else smm.PoissonMultigrid.for_stencil(tst)
    tres = smm.solve(tst, torch.from_numpy(b64.astype(np.float32)), method="cg", epsilon=1e-8,
                     preconditioner=kind, max_iterations=10000)
    assert isinstance(tres, smm.DfSolveResult)
    assert tres.status == int(S.SUCCESS)
    assert _true_res(a64, b64, tres.x_f64()) <= 1e-8
    assert tres.iterations <= 60
    if pre == "multigrid":
        jres = jsmm.solve(jst, jnp.asarray(b64.astype(np.float32)), method="cg", epsilon=1e-8,
                          preconditioner="multigrid", max_iterations=10000)
        assert int(jres.status) == int(S.SUCCESS)
        assert abs(tres.outer_rounds - int(jres.outer_rounds)) <= 1
        assert abs(tres.iterations - int(jres.iterations)) <= max(3, int(jres.iterations) // 10)


def test_front_door_refuses_non_poisson():
    jcsr = jax_gen.convection_diffusion_2d(24, dtype=np.float32)
    b = np.asarray(jcsr @ jnp.ones(576, jnp.float32))
    with pytest.raises(ValueError, match="(?i)multigrid"):
        jsmm.solve(jcsr, jnp.asarray(b), method="cg", epsilon=1e-4, preconditioner="multigrid")
    with pytest.raises(ValueError, match="(?i)multigrid"):
        smm.solve(port_csr(jcsr), torch.from_numpy(b.copy()), method="cg", epsilon=1e-4,
                  preconditioner="multigrid")


def test_front_door_from_csr_and_dia():
    jcsr = jax_gen.poisson_2d(32, dtype=np.float32)
    b = np.array(jcsr @ jnp.ones(1024, jnp.float32))
    tcsr = port_csr(jcsr)
    for ja, ta in ((jcsr, tcsr), (jsmm.try_dia_from_csr(jcsr), smm.try_dia_from_csr(tcsr))):
        kw = dict(method="cg", epsilon=1e-4, preconditioner="multigrid", auto_escalate=False)
        jres = jsmm.solve(ja, jnp.asarray(b), **kw)
        tres = smm.solve(ta, torch.from_numpy(b), **kw)
        assert tres.status == int(jres.status)
        assert tres.status in (int(S.SUCCESS), int(S.MAX_ITERATIONS_REACHED))
        assert abs(tres.iterations - int(jres.iterations)) <= max(3, int(jres.iterations) // 10)


def test_front_door_gmres_pre_routes_to_refinement():
    a64 = jax_gen.convection_diffusion_2d(48, dtype=np.float64)
    data = np.asarray(a64.data, np.float64)
    b64 = np.add.reduceat(data, np.asarray(a64.indptr, np.int64)[:-1])
    tcsr = port_csr(jax_gen.convection_diffusion_2d(48, dtype=np.float32))
    tres = smm.solve(tcsr, torch.from_numpy(b64.astype(np.float32)), method="gmres",
                     epsilon=1e-8, max_iterations=20000)
    assert isinstance(tres, smm.DfSolveResult)
    assert tres.status == int(S.SUCCESS)
    assert _true_res(a64, b64, tres.x_f64()) <= 1e-8
