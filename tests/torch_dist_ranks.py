"""Rank-side cases of the port's distributed tests (tests/test_torch_parallel.py,
tests/test_torch_dist_stencil.py, tests/test_torch_dist_rsell.py,
tests/test_torch_dist_df64.py, tests/test_torch_dist_multigrid.py).

Every case runs on every rank of a gloo CPU world and returns a picklable
payload (global vectors gathered with ``collect``, so each rank's payload
holds the same values when the ranks agree).  :func:`run_world` runs a list
of cases at one world size: in this process over a ``HashStore`` for one
rank, else in ``k`` spawned processes over a ``FileStore``.  The spawned
children import this module, so it imports only torch, NumPy and the port,
never JAX or a test file.
"""

from __future__ import annotations

import functools
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch import native
from sparse_matrix_math_tpu_torch.formats.csr import csr_from_dense
from sparse_matrix_math_tpu_torch.formats.dia import DIAMatrix
from sparse_matrix_math_tpu_torch.ops.df32 import DfDiaMatrix
from sparse_matrix_math_tpu_torch.parallel import (
    collect,
    dist_bicgstab_ir_df64,
    dist_cg_ir_df64,
    dist_df_dia_spmv,
    dist_dia_solve,
    dist_dia_spmv,
    dist_mg_solve,
    dist_mg_vcycle,
    dist_routed_solve,
    dist_routed_spmv,
    dist_solve,
    dist_spmv,
    dist_stencil_solve,
    dist_stencil_spmv,
    dist_wsell_solve,
    dist_wsell_spmv,
    distribute_csr,
    distribute_df_dia,
    distribute_dia,
    distribute_multigrid,
    distribute_preconditioner,
    distribute_routed,
    distribute_stencil,
    distribute_vector,
    distribute_wsell,
    make_mesh,
    spawn_cpu_world,
)
from sparse_matrix_math_tpu_torch.parallel.mesh import GROUP_TIMEOUT, all_gather
from sparse_matrix_math_tpu_torch.solvers.multigrid import PoissonMultigrid
from sparse_matrix_math_tpu_torch.utils import generate as gen
from sparse_matrix_math_tpu_torch.utils.checkpoint import checkpointed_solve, load_checkpoint

CPU = torch.device("cpu")
DTYPES = {"f32": torch.float32, "f64": torch.float64}
NP_DTYPES = {"f32": np.float32, "f64": np.float64}
LAYOUT_NATIVES = ("wsell_plan", "wsell_color", "wsell_emit")

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def ones_rhs(a) -> np.ndarray:
    """b = row sums, so that x = 1 (the reference suite's oracle)."""
    return a.to_dense().sum(dim=1).numpy()


def rand_vec(n, seed, dt):
    return np.random.default_rng(seed).standard_normal(n).astype(NP_DTYPES[dt])


def solved(res, a):
    return {"status": int(res.status), "iterations": int(res.iterations),
            "residual_norm": float(res.residual_norm), "floor_hit": res.floor_hit,
            "x": collect(res.x, a),
            "trace": None if res.residual_trace is None else res.residual_trace.numpy()}


def jittered(m=16, symmetric=False):
    return gen.laplace_3d_jittered(m, jitter=4, symmetric=symmetric, device=CPU)


def sub_mesh(mesh):
    """A mesh over the first half of the ranks (all of a one-rank world),
    or None on the ranks outside it; every rank must call it."""
    members = list(range(max(mesh.size // 2, 1)))
    group = dist.new_group(members, timeout=GROUP_TIMEOUT)
    return make_mesh(group=group) if mesh.rank in members else None


# -- TestDistSpMV, TestHaloExchange -------------------------------------------


def _spmv_case(a, x, mesh, mode="auto"):
    da = distribute_csr(a, mesh, mode=mode)
    return {"mode": da.mode, "y": collect(dist_spmv(da, distribute_vector(x, da)), da)}


for _dt in DTYPES:
    def _poisson(mesh, workdir, dt=_dt):
        return _spmv_case(gen.poisson_2d(13, dtype=DTYPES[dt], device=CPU),
                          rand_vec(169, 3, dt), mesh)

    def _unstructured(mesh, workdir, dt=_dt):
        return _spmv_case(gen.random_spd_csr(97, density=0.2, seed=5, dtype=DTYPES[dt],
                                             device=CPU), rand_vec(97, 7, dt), mesh)

    def _halo_vs_allgather(mesh, workdir, dt=_dt):
        a = gen.poisson_2d(16, dtype=DTYPES[dt], device=CPU)
        x = rand_vec(256, 1, dt)
        return {m: _spmv_case(a, x, mesh, mode=m) for m in ("halo", "allgather")}

    CASES[f"spmv_poisson_{_dt}"] = _poisson
    CASES[f"spmv_unstructured_{_dt}"] = _unstructured
    CASES[f"halo_vs_allgather_{_dt}"] = _halo_vs_allgather


@case
def auto_mode(mesh, workdir):
    return {name: distribute_csr(a, mesh).mode for name, a in (
        ("poisson", gen.poisson_2d(16, device=CPU)),
        ("random", gen.random_spd_csr(97, density=0.2, seed=5, device=CPU)))}


@case
def halo_wide_pattern(mesh, workdir):
    return distribute_csr(gen.random_spd_csr(97, density=0.2, seed=5, device=CPU), mesh,
                          mode="halo").mode


@case
def halo_sgs_bicgstab(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh, mode="halo")
    p = smm.get_preconditioner(a, "sgs", method="jacobi", sweeps="exact")
    dp = distribute_preconditioner(p, da)
    return solved(dist_solve(da, ones_rhs(a), solver="bicgstab", preconditioner=dp,
                             epsilon=1e-9), da)


# -- TestDistSolve ------------------------------------------------------------

for _solver in ("cg", "bicg_symmetric", "cgs", "bicgstab"):
    def _converge(mesh, workdir, solver=_solver):
        a = gen.poisson_2d(16, device=CPU)
        da = distribute_csr(a, mesh)
        return solved(dist_solve(da, ones_rhs(a), solver=solver, epsilon=1e-8), da)

    CASES[f"solve_{_solver}"] = _converge


@case
def gmres_convection(mesh, workdir):
    a = gen.convection_diffusion_2d(16, cx=0.6, cy=0.2, device=CPU)
    da = distribute_csr(a, mesh)
    b = ones_rhs(a)
    out = solved(dist_solve(da, b, solver="gmres", epsilon=1e-10, restart=20), da)
    single = smm.gmres(a, torch.from_numpy(b), epsilon=1e-10, restart=20)
    out["single_iterations"] = int(single.iterations)
    return out


@case
def gmres_jacobi(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh)
    b = ones_rhs(a)
    dp = distribute_preconditioner(smm.get_preconditioner(a, "jacobi"), da)
    out = solved(dist_solve(da, b, solver="gmres", preconditioner=dp, epsilon=1e-9), da)
    out["plain_iterations"] = int(dist_solve(da, b, solver="gmres", epsilon=1e-9).iterations)
    return out


@case
def cg_pipelined(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh)
    return solved(dist_solve(da, ones_rhs(a), solver="cg_pipelined", epsilon=1e-10), da)


@case
def chebyshev(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh)
    return solved(dist_solve(da, ones_rhs(a), solver="chebyshev", epsilon=1e-9,
                             max_iterations=3000), da)


@case
def cg_single_chip(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    b = ones_rhs(a)
    da = distribute_csr(a, mesh)
    out = solved(dist_solve(da, b, solver="cg", epsilon=1e-10), da)
    out["single_iterations"] = int(smm.cg(a, torch.from_numpy(b), epsilon=1e-10).iterations)
    return out


for _kind in ("jacobi", "sgs", "ic0", "ilu0"):
    def _preconditioned(mesh, workdir, kind=_kind):
        a = gen.poisson_2d(12, device=CPU)
        da = distribute_csr(a, mesh)
        p = (smm.get_preconditioner(a, kind) if kind == "jacobi"
             else smm.get_preconditioner(a, kind, method="jacobi", sweeps="exact"))
        solver = "cg" if kind in ("jacobi", "ic0") else "bicgstab"
        return solved(dist_solve(da, ones_rhs(a), solver=solver,
                                 preconditioner=distribute_preconditioner(p, da),
                                 epsilon=1e-9), da)

    CASES[f"precond_{_kind}"] = _preconditioned


@case
def max_iterations(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh)
    return solved(dist_solve(da, ones_rhs(a), solver="cg", max_iterations=2,
                             epsilon=1e-12), da)


@case
def record_residuals(mesh, workdir):
    a = gen.poisson_2d(10, device=CPU)
    da = distribute_csr(a, mesh)
    return solved(dist_solve(da, ones_rhs(a), solver="cg", epsilon=1e-9,
                             record_residuals=True), da)


# -- TestDistCheckpoint -------------------------------------------------------


@case
def checkpoint(mesh, workdir):
    a = gen.poisson_2d(16, device=CPU)
    da = distribute_csr(a, mesh)
    b = ones_rhs(a)
    solver = functools.partial(dist_solve, solver="cg")
    whole = os.path.join(workdir, "whole.npz")
    res = checkpointed_solve(solver, da, b, checkpoint_path=whole, chunk_iterations=25,
                             epsilon=1e-10)
    out = solved(res, da)
    out["path"] = whole
    out["file_iterations"] = load_checkpoint(whole).iterations_done
    # stopped after one chunk, then resumed from the file
    part = os.path.join(workdir, "part.npz")
    first = checkpointed_solve(solver, da, b, checkpoint_path=part, chunk_iterations=25,
                               max_iterations=25, epsilon=1e-10)
    resumed = checkpointed_solve(solver, da, b, checkpoint_path=part, chunk_iterations=25,
                                 epsilon=1e-10)
    out["first"] = (int(first.status), int(first.iterations))
    out["resumed"] = solved(resumed, da)
    return out


# -- TestDistDIA ----------------------------------------------------------------


@case
def dia_spmv(mesh, workdir):
    dia = smm.dia_from_csr(gen.poisson_2d(40, device=CPU))
    d = distribute_dia(dia, mesh)
    x = np.random.default_rng(0).standard_normal(1600)
    return collect(dist_dia_spmv(d, distribute_vector(x, d)), d)


for _solver in ("cg", "bicgstab"):
    def _dia_solve(mesh, workdir, solver=_solver):
        csr = gen.poisson_2d(40, device=CPU)
        b = (csr @ torch.ones(1600, dtype=torch.float64)).numpy()
        d = distribute_dia(smm.dia_from_csr(csr), mesh)
        out = solved(dist_dia_solve(d, b, solver=solver, epsilon=1e-10), d)
        single = getattr(smm, solver)(csr, torch.from_numpy(b), epsilon=1e-10)
        out["single_iterations"] = int(single.iterations)
        return out

    CASES[f"dia_solve_{_solver}"] = _dia_solve


@case
def dia_offset_span(mesh, workdir):
    n = 256
    far = DIAMatrix(diags=torch.ones((2, n), dtype=torch.float64), offsets=(0, 200),
                    shape=(n, n), nnz=2 * n)
    return distribute_dia(far, mesh).block_rows


# -- TestDistWSell --------------------------------------------------------------


@case
def wsell_spmv(mesh, workdir):
    csr = jittered()
    d = distribute_wsell(csr, mesh)
    x = np.random.default_rng(0).standard_normal(csr.shape[0])
    return {"y": collect(dist_wsell_spmv(d, distribute_vector(x, d)), d),
            "slot_ratio": d.slot_ratio, "nway": d.nway}


@case
def wsell_cg(mesh, workdir):
    sym = jittered(symmetric=True)
    b = (sym @ torch.ones(sym.shape[0], dtype=torch.float64)).numpy()
    d = distribute_wsell(sym, mesh)
    out = solved(dist_wsell_solve(d, b, solver="cg", epsilon=1e-10), d)
    out["single_iterations"] = int(smm.cg(sym, torch.from_numpy(b), epsilon=1e-10).iterations)
    return out


@case
def wsell_gmres(mesh, workdir):
    csr = jittered()
    b = (csr @ torch.ones(csr.shape[0], dtype=torch.float64)).numpy()
    d = distribute_wsell(csr, mesh)
    return solved(dist_wsell_solve(d, b, solver="gmres", epsilon=1e-9), d)


# -- TestMeshResolution ---------------------------------------------------------


@case
def default_mesh_csr(mesh, workdir):
    sub = sub_mesh(mesh)
    if sub is None:
        return None
    a = gen.poisson_2d(12, dtype=torch.float32, device=CPU)
    da = distribute_csr(a, sub)
    return solved(dist_solve(da, ones_rhs(a), solver="cg", epsilon=1e-4), da)


@case
def default_mesh_dia(mesh, workdir):
    sub = sub_mesh(mesh)
    if sub is None:
        return None
    a = gen.poisson_2d(8, dtype=torch.float32, device=CPU)
    dd = distribute_dia(smm.dia_from_csr(a), sub)
    return solved(dist_dia_solve(dd, ones_rhs(a), solver="cg", epsilon=1e-4), dd)


@case
def default_mesh_stencil(mesh, workdir):
    sub = sub_mesh(mesh)
    if sub is None:
        return None
    a = gen.poisson_2d(12, dtype=torch.float32, device=CPU)
    dst = distribute_stencil(smm.try_grid_stencil_from_csr(a), sub)
    return solved(dist_stencil_solve(dst, ones_rhs(a), solver="cg", epsilon=1e-4), dst)


@case
def mismatched_mesh(mesh, workdir):
    sub = sub_mesh(mesh)
    a = gen.poisson_2d(12, dtype=torch.float32, device=CPU)
    da = distribute_csr(a, mesh)
    if sub is None or sub.size == mesh.size:
        return None
    return dist_solve(da, ones_rhs(a), solver="cg", mesh=sub)


@case
def mismatched_axis(mesh, workdir):
    a = gen.poisson_2d(12, dtype=torch.float32, device=CPU)
    da = distribute_csr(a, mesh)
    return dist_solve(da, ones_rhs(a), solver="cg", mesh=make_mesh(axis="cols"))


# -- tests/test_torch_dist_stencil.py -----------------------------------------

STENCIL_SPMV = {"poisson_2d": 36, "poisson_3d": 11, "convection_diffusion_2d": 30}
STENCIL_SOLVES = [("poisson_2d", "cg"), ("poisson_2d", "bicg_symmetric"),
                  ("convection_diffusion_2d", "bicgstab"), ("convection_diffusion_2d", "cgs")]

for _name, _nx in STENCIL_SPMV.items():
    def _stencil_spmv(mesh, workdir, name=_name, nx=_nx):
        a = getattr(gen, name)(nx, device=CPU)
        ds = distribute_stencil(smm.try_grid_stencil_from_csr(a), mesh)
        x = np.random.default_rng(0).standard_normal(a.shape[0])
        return collect(dist_stencil_spmv(ds, distribute_vector(x, ds)), ds)

    CASES[f"stencil_spmv_{_name}"] = _stencil_spmv

for _name, _solver in STENCIL_SOLVES:
    def _stencil_solve(mesh, workdir, name=_name, solver=_solver):
        a = getattr(gen, name)(30, device=CPU)
        ds = distribute_stencil(smm.try_grid_stencil_from_csr(a), mesh)
        return solved(dist_stencil_solve(ds, ones_rhs(a), solver=solver, epsilon=1e-10), ds)

    CASES[f"stencil_solve_{_name}_{_solver}"] = _stencil_solve


@case
def stencil_single_chip(mesh, workdir):
    a = gen.poisson_2d(24, device=CPU)
    ds = distribute_stencil(smm.try_grid_stencil_from_csr(a), mesh)
    b = np.random.default_rng(5).standard_normal(a.shape[0])
    return solved(dist_stencil_solve(ds, b, solver="cg", epsilon=1e-11), ds)


# -- tests/test_torch_dist_rsell.py -------------------------------------------

RSELL_N = 6 * 1024  # at 4 ranks the blocks are 2048 rows: the last holds none


def rsell_system():
    a = gen.uniform_random_csr(RSELL_N, per_row=4, seed=7, dtype=torch.float32, device=CPU)
    return a, np.random.default_rng(0).standard_normal(RSELL_N).astype(np.float32)


@case
def rsell_spmv(mesh, workdir):
    a, x = rsell_system()
    da = distribute_routed(a, mesh, max_slot_ratio=99.0)
    y = dist_routed_spmv(da, distribute_vector(x, da))
    rows = torch.tensor([da.local.final.nnz], dtype=torch.int64)
    return {"y_padded": da.gather_vector(y), "padded_rows": da.padded_rows,
            "n_shards": da.n_shards, "n_passes": da.n_passes, "slot_ratio": da.slot_ratio,
            "final_nway": da.final_nway, "shard_nnz": all_gather(rows, mesh).tolist()}


for _solver in ("bicgstab", "gmres"):
    def _rsell_solve(mesh, workdir, solver=_solver):
        a, _ = rsell_system()
        b = (a @ torch.ones(RSELL_N, dtype=torch.float32)).numpy()
        da = distribute_routed(a, mesh, max_slot_ratio=99.0)
        return solved(dist_routed_solve(da, b, epsilon=1e-4, solver=solver), da)

    CASES[f"rsell_solve_{_solver}"] = _rsell_solve


@case
def rsell_rectangular(mesh, workdir):
    return distribute_routed(csr_from_dense(torch.ones((8, 4), dtype=torch.float64)), mesh)


@case
def rsell_slot_cap(mesh, workdir):
    return distribute_routed(rsell_system()[0], mesh, max_slot_ratio=1.0)


@case
def rsell_unknown_solver(mesh, workdir):
    a, x = rsell_system()
    return dist_routed_solve(distribute_routed(a, mesh, max_slot_ratio=99.0), x,
                             solver="chebyshev")


# -- tests/test_torch_dist_df64.py --------------------------------------------


def df_dia_host(nx, perturb=True, drift=0.0):
    """The JAX test's ``_df_dia_host``: poisson_2d(nx) in float64, its values
    perturbed (non-trivial lo planes) and an optional drift on the +1
    diagonal; the operator and its host CSR arrays."""
    a = gen.poisson_2d(nx, dtype=torch.float64, device=CPU)
    data = a.data.numpy().copy()
    indices, indptr = a.indices.numpy(), a.indptr.numpy()
    if perturb:
        data = data * (1.0 + 1e-9 * np.arange(data.size))
    if drift:
        rows = np.repeat(np.arange(a.shape[0]), np.diff(indptr))
        data[indices == rows + 1] += drift
    return (DfDiaMatrix.from_host_csr(data, indices, indptr, a.shape, device=CPU),
            data, indices, indptr)


def csr_mv(data, indices, indptr, x):
    return np.add.reduceat(data * x[indices], indptr[:-1])


def df_solved(res):
    return {"status": int(res.status), "iterations": int(res.iterations),
            "outer_rounds": int(res.outer_rounds), "x": res.x_f64(),
            "residual_norm2": float(res.residual_norm2)}


@case
def df_spmv(mesh, workdir):
    dfa, *_ = df_dia_host(24)
    d = distribute_df_dia(dfa, mesh)
    x64 = np.random.default_rng(0).standard_normal(dfa.shape[0])
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    # this rank's (hi, lo) blocks, as JAX's test passes the sharded pair
    yh, yl = dist_df_dia_spmv(d, (distribute_vector(hi, d), distribute_vector(lo, d)))
    return {"hi": collect(yh, d), "lo": collect(yl, d), "block_rows": d.block_rows}


@case
def df_cg_ir(mesh, workdir):
    dfa, data, indices, indptr = df_dia_host(48)
    b = csr_mv(data, indices, indptr,
               np.random.default_rng(1).standard_normal(dfa.shape[0]))
    out = df_solved(dist_cg_ir_df64(distribute_df_dia(dfa, mesh), b, epsilon=1e-10))
    out["single"] = df_solved(smm.cg_ir_df64(dfa, b, epsilon=1e-10))
    return out


@case
def df_bicgstab_ir(mesh, workdir):
    dfa, data, indices, indptr = df_dia_host(32, drift=1e-2)
    b = csr_mv(data, indices, indptr,
               np.random.default_rng(2).standard_normal(dfa.shape[0]))
    return df_solved(dist_bicgstab_ir_df64(distribute_df_dia(dfa, mesh), b, epsilon=1e-9))


@case
def df_status_paths(mesh, workdir):
    dfa, data, indices, indptr = df_dia_host(8)
    n = dfa.shape[0]
    d = distribute_df_dia(dfa, mesh)
    capped = dist_cg_ir_df64(d, np.ones(n), max_iterations=0)
    x_true = np.random.default_rng(3).standard_normal(n)
    resumed = dist_cg_ir_df64(d, csr_mv(data, indices, indptr, x_true), x0=x_true,
                              epsilon=1e-8)
    return {"capped": int(capped.status),
            "resumed": (int(resumed.status), int(resumed.iterations),
                        int(resumed.outer_rounds))}


@case
def df_tiny_epsilon(mesh, workdir):
    dfa, *_ = df_dia_host(8)
    return dist_cg_ir_df64(distribute_df_dia(dfa, mesh), np.ones(dfa.shape[0]),
                           epsilon=1e-20)


@case
def df_wide_band(mesh, workdir):
    # offsets past the block cannot be covered by the neighbour exchange
    n = 64
    data = np.ones(2 * n - 40, np.float64)
    rows = np.concatenate([np.arange(n), np.arange(n - 40)])
    cols = np.concatenate([np.arange(n), np.arange(40, n)])
    order = np.lexsort((cols, rows))
    indptr = np.cumsum(np.concatenate([[0], np.bincount(rows, minlength=n)]))
    dfa = DfDiaMatrix.from_host_csr(data[order], cols[order], indptr, (n, n), device=CPU)
    return distribute_df_dia(dfa, mesh).block_rows


# -- tests/test_torch_dist_multigrid.py ---------------------------------------

MG_VCYCLE_GRIDS = {"96": (96,), "90": (90,), "48": (48,), "40x72": (40, 72)}


def mg_rand(n, seed):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


for _name, _grid in MG_VCYCLE_GRIDS.items():
    def _mg_vcycle(mesh, workdir, grid=_grid):
        mg = PoissonMultigrid.for_grid(*grid, device=CPU)
        n = int(np.prod(mg.dims[0]))
        dmg = distribute_multigrid(mg, mesh)
        z = dist_mg_vcycle(dmg, mg_rand(n, grid[0] if len(grid) == 1 else 7))
        return {"z": z.numpy(), "levels": dmg.n_levels_dist, "m0s": dmg.m0s}

    CASES[f"mg_vcycle_{_name}"] = _mg_vcycle

# (solver, grid, epsilon)
MG_SOLVES = {"pcg_96": ("pcg", (96,), 1e-4), "cg_48": ("cg", (48,), 1e-4),
             "mg_90": ("mg", (90,), 1e-3), "pcg_20x20x20": ("pcg", (20, 20, 20), 1e-4)}

for _name, (_solver, _grid, _eps) in MG_SOLVES.items():
    def _mg_solve(mesh, workdir, solver=_solver, grid=_grid, eps=_eps):
        a = (gen.poisson_2d(grid[0], dtype=torch.float32, device=CPU) if len(grid) == 1
             else gen.poisson_3d(grid[0], dtype=torch.float32, device=CPU))
        mg = PoissonMultigrid.for_grid(*grid, device=CPU)
        b = a @ torch.ones(a.shape[0], dtype=torch.float32)
        res = dist_mg_solve(distribute_multigrid(mg, mesh), b, solver=solver, epsilon=eps)
        out = {"status": int(res.status), "iterations": int(res.iterations),
               "x": res.x.numpy()}
        if solver == "mg":
            out["single_iterations"] = int(mg.solve(b, epsilon=eps).iterations)
        else:
            out["single_iterations"] = int(
                smm.cg(a, b, epsilon=eps, preconditioner=mg if solver == "pcg" else None
                       ).iterations)
        return out

    CASES[f"mg_solve_{_name}"] = _mg_solve


@case
def mg_unknown_solver(mesh, workdir):
    dmg = distribute_multigrid(PoissonMultigrid.for_grid(48, device=CPU), mesh)
    return dist_mg_solve(dmg, np.ones(48 * 48, np.float32), solver="gmres")


def fail_on_rank_one(mesh):
    """Rank 1 raises while rank 0 waits in a collective for it."""
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    dist.barrier(group=mesh.group)


# -- running -------------------------------------------------------------------


def run_cases(mesh, names, workdir, numpy_layouts=False):
    """Every named case on this rank: ``{name: ("ok", payload)}``, or
    ``("raises", type name, message)`` for a case that raised."""
    torch.set_num_threads(1)
    if numpy_layouts:
        for name in LAYOUT_NATIVES:
            setattr(native, name, lambda *a, **k: None)
    out = {}
    for name in names:
        try:
            out[name] = ("ok", CASES[name](mesh, workdir))
        except (ValueError, TypeError, KeyError, RuntimeError) as e:
            out[name] = ("raises", type(e).__name__, str(e), traceback.format_exc())
    return out


def run_world(k, names, workdir, numpy_layouts=False):
    """:func:`run_cases` on ``k`` gloo CPU ranks; the ranks' results in rank
    order."""
    if k > 1:
        return spawn_cpu_world(run_cases, k, names, workdir, numpy_layouts,
                               store_dir=workdir)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=GROUP_TIMEOUT)
    saved = {name: getattr(native, name) for name in LAYOUT_NATIVES}
    try:
        return [run_cases(make_mesh(), names, workdir, numpy_layouts)]
    finally:
        for name, fn in saved.items():
            setattr(native, name, fn)
        dist.destroy_process_group()
