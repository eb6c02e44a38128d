"""The port's distributed layer (sparse_matrix_math_tpu_torch.parallel) on gloo
CPU worlds of 1, 2 and 4 ranks, held against the JAX package's
``parallel`` on meshes of as many of the conftest's virtual devices: twin of
tests/test_parallel.py.

Each world size runs every case once (tests/torch_dist_ranks.py: one rank in
this process, else one spawn of k processes); the tests here compute the JAX
side and compare, by the tolerances of tests/torch_dist_check.py.  Every
case also checks that all ranks returned the same payload, and the port at
2 and 4 ranks is held against the port at one rank.  Iteration bands: CG
and BiCGSymmetric within 1 in f64 (max(2, 2%) in f32), BiCGStab and CGS
max(3, 5%), GMRES and pipelined CG max(2, 2%), Chebyshev one check interval.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
from sparse_matrix_math_tpu.formats.dia import DIAMatrix as JaxDIA
from sparse_matrix_math_tpu.formats.dia import dia_from_csr as jax_dia_from_csr
from sparse_matrix_math_tpu.formats.stencil import try_grid_stencil_from_csr as jax_stencil
from sparse_matrix_math_tpu.parallel import (
    collect,
    dist_dia_solve,
    dist_dia_spmv,
    dist_solve,
    dist_spmv,
    dist_stencil_solve,
    dist_wsell_solve,
    dist_wsell_spmv,
    distribute_csr,
    distribute_dia,
    distribute_preconditioner,
    distribute_stencil,
    distribute_vector,
    distribute_wsell,
    make_mesh,
)
from sparse_matrix_math_tpu.utils import generate as jgen
from sparse_matrix_math_tpu.utils.checkpoint import checkpointed_solve, load_checkpoint
from torch_dist_check import (
    WORLDS,
    band,
    check_product,
    check_self,
    check_solve,
    check_success,
    ok,
    raised,
    run_port,
    scipy_csr,
)
from torch_dist_ranks import CASES
from torch_layout_code import same_layout_code  # noqa: F401  (autouse fixture)

import sparse_matrix_math_tpu_torch.parallel as tpar

NAMES = [n for n in CASES if not n.startswith("stencil_")]
DT = {"f32": np.float32, "f64": np.float64}


@pytest.fixture(scope="module")
def port(tmp_path_factory, same_layout_code):  # noqa: F811
    return run_port(tmp_path_factory, NAMES)


def ones_rhs(a):
    return np.asarray(a.to_dense()).sum(axis=1)


def jax_solve(a, b, k, **kw):
    """The JAX package's dist_solve on ``k`` virtual devices: (result, x)."""
    mesh = make_mesh(k)
    da = distribute_csr(a, mesh, mode=kw.pop("mode", "auto"))
    pre = kw.pop("precond", None)
    if pre is not None:
        kw["preconditioner"] = distribute_preconditioner(pre, da, mesh)
    res = dist_solve(da, b, mesh=mesh, **kw)
    return res, collect(res.x, da)


def test_exports_match_jax():
    """Every name of this slice's five JAX modules is exported by the port."""
    import importlib

    import sparse_matrix_math_tpu.parallel as jpar

    mods = [importlib.import_module(f"sparse_matrix_math_tpu.parallel.{m}")
            for m in ("mesh", "dist", "dist_dia", "dist_stencil", "dist_wsell")]
    names = [n for n in jpar.__all__
             if any(n in m.__all__ or getattr(getattr(jpar, n), "__module__", None)
                    == m.__name__ for m in mods)]
    assert len(names) == 27
    missing = [n for n in names if n not in tpar.__all__ or not hasattr(tpar, n)]
    assert not missing, missing


@pytest.mark.parametrize("k", WORLDS)
class TestDistSpMV:
    @pytest.mark.parametrize("dt", ["f32", "f64"])
    def test_matches_single_chip(self, port, k, dt):
        a = jgen.poisson_2d(13, dtype=DT[dt])  # 169 rows: uneven over the shards
        x = np.random.default_rng(3).standard_normal(169).astype(DT[dt])
        got = ok(port, k, f"spmv_poisson_{dt}")["y"]
        mesh = make_mesh(k)
        da = distribute_csr(a, mesh)
        want = collect(dist_spmv(da, distribute_vector(x, da, mesh), mesh), da)
        a_sp = scipy_csr(a)
        check_product(got, want, a_sp, x, DT[dt])
        check_product(got, np.asarray(a.rmult(jnp.asarray(x))), a_sp, x, DT[dt])
        check_product(got, ok(port, 1, f"spmv_poisson_{dt}")["y"], a_sp, x, DT[dt])

    @pytest.mark.parametrize("dt", ["f32", "f64"])
    def test_unstructured_matrix(self, port, k, dt):
        a = jgen.random_spd_csr(97, density=0.2, seed=5, dtype=DT[dt])
        x = np.random.default_rng(7).standard_normal(97).astype(DT[dt])
        got = ok(port, k, f"spmv_unstructured_{dt}")
        mesh = make_mesh(k)
        da = distribute_csr(a, mesh)
        assert got["mode"] == da.mode
        want = collect(dist_spmv(da, distribute_vector(x, da, mesh), mesh), da)
        check_product(got["y"], want, scipy_csr(a), x, DT[dt])


@pytest.mark.parametrize("k", WORLDS)
class TestHaloExchange:
    def test_auto_mode_detection(self, port, k):
        mesh = make_mesh(k)
        want = {"poisson": distribute_csr(jgen.poisson_2d(16), mesh).mode,
                "random": distribute_csr(
                    jgen.random_spd_csr(97, density=0.2, seed=5), mesh).mode}
        assert ok(port, k, "auto_mode") == want
        assert want["poisson"] == "halo"  # B >= 16 at every k here
        if k == 4:
            assert want["random"] == "allgather"

    @pytest.mark.parametrize("dt", ["f32", "f64"])
    def test_halo_matches_allgather(self, port, k, dt):
        a = jgen.poisson_2d(16, dtype=DT[dt])
        x = np.random.default_rng(1).standard_normal(256).astype(DT[dt])
        got = ok(port, k, f"halo_vs_allgather_{dt}")
        a_sp = scipy_csr(a)
        mesh = make_mesh(k)
        for mode in ("halo", "allgather"):
            assert got[mode]["mode"] == mode
            da = distribute_csr(a, mesh, mode=mode)
            want = collect(dist_spmv(da, distribute_vector(x, da, mesh), mesh), da)
            check_product(got[mode]["y"], want, a_sp, x, DT[dt])
        check_product(got["halo"]["y"], got["allgather"]["y"], a_sp, x, DT[dt])

    def test_halo_rejects_wide_pattern(self, port, k):
        """The port refuses the halo mode exactly where the JAX package does
        (at 4 shards; at 1 and 2 every column lies in the window)."""
        r = jgen.random_spd_csr(97, density=0.2, seed=5)
        try:
            distribute_csr(r, make_mesh(k), mode="halo")
            jax_msg = None
        except ValueError as e:
            jax_msg = str(e)
        got = raised(port, k, "halo_wide_pattern")
        if jax_msg is None:
            assert got is None
        else:
            assert got == ("ValueError", jax_msg) and "neighbor window" in jax_msg
        assert (jax_msg is not None) == (k == 4)

    def test_halo_preconditioned_solve(self, port, k):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        pre = jsmm.get_preconditioner(a, "sgs", method="jacobi", sweeps="exact")
        jres, jx = jax_solve(a, b, k, mode="halo", precond=pre, solver="bicgstab",
                             epsilon=1e-9)
        got = ok(port, k, "halo_sgs_bicgstab")
        a_sp = scipy_csr(a)
        check_solve(got, jres, jx, a_sp, b, band(int(jres.iterations), 0.05, 3), 1e-9)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-6
        check_self(port, k, "halo_sgs_bicgstab", a_sp, b, 3)


@pytest.mark.parametrize("k", WORLDS)
class TestDistSolve:
    BANDS = {"cg": (0.0, 1), "bicg_symmetric": (0.0, 1), "cgs": (0.05, 3),
             "bicgstab": (0.05, 3)}

    @pytest.mark.parametrize("solver", ["cg", "bicg_symmetric", "cgs", "bicgstab"])
    def test_all_solvers_converge(self, port, k, solver):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver=solver, epsilon=1e-8)
        got = ok(port, k, f"solve_{solver}")
        frac, floor = self.BANDS[solver]
        a_sp = scipy_csr(a)
        check_solve(got, jres, jx, a_sp, b, band(int(jres.iterations), frac, floor), 1e-8)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-7
        check_self(port, k, f"solve_{solver}", a_sp, b, floor)

    def test_gmres_distributed(self, port, k):
        a = jgen.convection_diffusion_2d(16, cx=0.6, cy=0.2, dtype=np.float64)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="gmres", epsilon=1e-10, restart=20)
        got = ok(port, k, "gmres_convection")
        its = int(jres.iterations)
        a_sp = scipy_csr(a)
        check_solve(got, jres, jx, a_sp, b, band(its, 0.02, 2), 1e-10)
        assert np.abs(got["x"] - 1.0).max() <= 1e-7
        # the distributed iterates follow the single-device gmres
        assert abs(got["iterations"] - got["single_iterations"]) <= band(its, 0.02, 2)
        check_self(port, k, "gmres_convection", a_sp, b, 2)

    def test_gmres_distributed_preconditioned(self, port, k):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="gmres", precond=jsmm.get_preconditioner(
            a, "jacobi"), epsilon=1e-9)
        got = ok(port, k, "gmres_jacobi")
        check_solve(got, jres, jx, scipy_csr(a), b, band(int(jres.iterations), 0.02, 2),
                    1e-9)
        assert got["status"] == 0 and got["iterations"] <= got["plain_iterations"]
        assert np.abs(got["x"] - 1.0).max() <= 1e-6

    def test_pipelined_cg_distributed(self, port, k):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="cg_pipelined", epsilon=1e-10)
        got = ok(port, k, "cg_pipelined")
        check_solve(got, jres, jx, scipy_csr(a), b, band(int(jres.iterations), 0.02, 2),
                    1e-10)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-9

    def test_chebyshev_distributed(self, port, k):
        """Lanczos starts from the JAX package's vector over the padded rows,
        so the eigenvalue bounds, and the checks, follow JAX's."""
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="chebyshev", epsilon=1e-9, max_iterations=3000)
        got = ok(port, k, "chebyshev")
        check_solve(got, jres, jx, scipy_csr(a), b, 10, 1e-9)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-8

    def test_matches_single_chip_iterates(self, port, k):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="cg", epsilon=1e-10)
        got = ok(port, k, "cg_single_chip")
        check_solve(got, jres, jx, scipy_csr(a), b, 1, 1e-10)
        assert abs(got["iterations"] - got["single_iterations"]) <= 1

    @pytest.mark.parametrize("kind", ["jacobi", "sgs", "ic0", "ilu0"])
    def test_preconditioned(self, port, k, kind):
        a = jgen.poisson_2d(12)
        b = ones_rhs(a)
        pre = (jsmm.get_preconditioner(a, kind) if kind == "jacobi"
               else jsmm.get_preconditioner(a, kind, method="jacobi", sweeps="exact"))
        solver = "cg" if kind in ("jacobi", "ic0") else "bicgstab"
        jres, jx = jax_solve(a, b, k, precond=pre, solver=solver, epsilon=1e-9)
        got = ok(port, k, f"precond_{kind}")
        b_its = 1 if solver == "cg" else band(int(jres.iterations), 0.05, 3)
        a_sp = scipy_csr(a)
        check_solve(got, jres, jx, a_sp, b, b_its, 1e-9)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-6
        check_self(port, k, f"precond_{kind}", a_sp, b, b_its)

    def test_max_iterations_reached(self, port, k):
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="cg", max_iterations=2, epsilon=1e-12)
        got = ok(port, k, "max_iterations")
        assert got["status"] == int(jres.status) == 2
        assert got["iterations"] == int(jres.iterations) == 2
        np.testing.assert_allclose(got["x"], jx, rtol=1e-12, atol=1e-12)

    def test_record_residuals(self, port, k):
        a = jgen.poisson_2d(10)
        b = ones_rhs(a)
        jres, jx = jax_solve(a, b, k, solver="cg", epsilon=1e-9, record_residuals=True)
        got = ok(port, k, "record_residuals")
        its = got["iterations"]
        assert its == int(jres.iterations)
        trace, jtrace = got["trace"], np.asarray(jres.residual_trace)
        assert trace.shape == jtrace.shape
        assert np.isfinite(trace[: its + 1]).all() and np.isnan(trace[its + 1:]).all()
        assert trace[its] <= 1e-9
        # the recurrence's norms agree to 1e-6, down to the rounding of ||b||
        np.testing.assert_allclose(trace[: its + 1], jtrace[: its + 1], rtol=1e-6,
                                   atol=64 * np.finfo(np.float64).eps * trace[0])


@pytest.mark.parametrize("k", WORLDS)
class TestDistCheckpoint:
    def test_checkpointed_dist_solve(self, port, k, tmp_path):
        """checkpointed_solve composes with dist_solve; the file holds the
        global x in the JAX package's padded layout, which the JAX package
        loads (and resumes from, at the same shard count)."""
        a = jgen.poisson_2d(16)
        b = ones_rhs(a)
        got = ok(port, k, "checkpoint")
        mesh = make_mesh(k)
        da = distribute_csr(a, mesh)
        solver = functools.partial(dist_solve, solver="cg", mesh=mesh)
        jres = checkpointed_solve(solver, da, b, checkpoint_path=str(tmp_path / "ck.npz"),
                                  chunk_iterations=25, epsilon=1e-10)
        chunks = -(-int(jres.iterations) // 25)
        check_solve(got, jres, collect(jres.x, da), scipy_csr(a), b, chunks, 1e-10)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-8
        assert got["file_iterations"] == got["iterations"]
        saved = load_checkpoint(got["path"])  # the JAX package reads the port's file
        assert saved.iterations_done == got["iterations"]
        assert saved.x.shape == (da.padded_rows,)
        np.testing.assert_array_equal(saved.x[: a.shape[0]], got["x"])
        resumed = checkpointed_solve(solver, da, b, checkpoint_path=got["path"],
                                     chunk_iterations=25, epsilon=1e-10)
        assert int(resumed.status) == 0 and int(resumed.iterations) == got["iterations"]
        # stopped after one chunk and resumed: the uninterrupted run's result
        assert got["first"] == (2, 25)
        assert got["resumed"]["iterations"] == got["iterations"]
        np.testing.assert_array_equal(got["resumed"]["x"], got["x"])


@pytest.mark.parametrize("k", WORLDS)
class TestDistDIA:
    def test_spmv_parity(self, port, k):
        csr = jgen.poisson_2d(40)
        mesh = make_mesh(k)
        d = distribute_dia(jax_dia_from_csr(csr), mesh)
        x = np.random.default_rng(0).standard_normal(1600)
        want = collect(dist_dia_spmv(d, distribute_vector(x, d, mesh), mesh), d)
        a_sp = scipy_csr(csr)
        check_product(ok(port, k, "dia_spmv"), want, a_sp, x, np.float64)
        check_product(ok(port, k, "dia_spmv"), a_sp @ x, a_sp, x, np.float64)

    @pytest.mark.parametrize("solver", ["cg", "bicgstab"])
    def test_solve_parity(self, port, k, solver):
        csr = jgen.poisson_2d(40)
        b = np.asarray(csr @ jnp.ones(1600, jnp.float64))
        mesh = make_mesh(k)
        d = distribute_dia(jax_dia_from_csr(csr), mesh)
        jres = dist_dia_solve(d, b, solver=solver, epsilon=1e-10, mesh=mesh)
        got = ok(port, k, f"dia_solve_{solver}")
        b_its = 1 if solver == "cg" else band(int(jres.iterations), 0.05, 3)
        check_solve(got, jres, collect(jres.x, d), scipy_csr(csr), b, b_its, 1e-10)
        assert np.abs(got["x"] - 1.0).max() <= 1e-7
        assert abs(got["iterations"] - got["single_iterations"]) <= b_its

    def test_offset_span_rejected(self, port, k):
        """Refused where the JAX package refuses (the block under the 200
        offset: 2 and 4 shards), with its message."""
        n = 256
        far = JaxDIA(diags=jnp.ones((2, n)), offsets=(0, 200), shape=(n, n), nnz=2 * n)
        try:
            distribute_dia(far, make_mesh(k))
            jax_msg = None
        except ValueError as e:
            jax_msg = str(e)
        got = raised(port, k, "dia_offset_span")
        assert got == (None if jax_msg is None else ("ValueError", jax_msg))
        assert (jax_msg is not None) == (k > 1)


def _jittered(symmetric=False):
    return jgen.laplace_3d_jittered(16, jitter=4, symmetric=symmetric)  # n = 4096


@pytest.mark.parametrize("k", WORLDS)
class TestDistWSell:
    """K7's plain version in every shard (on a card, K7 itself)."""

    def test_spmv_parity(self, port, k):
        csr = _jittered()
        mesh = make_mesh(k)
        d = distribute_wsell(csr, mesh)
        x = np.random.default_rng(0).standard_normal(csr.shape[0])
        want = collect(dist_wsell_spmv(d, distribute_vector(x, d, mesh), mesh), d)
        got = ok(port, k, "wsell_spmv")
        a_sp = scipy_csr(csr)
        check_product(got["y"], want, a_sp, x, np.float64)
        check_product(got["y"], a_sp @ x, a_sp, x, np.float64)
        assert got["nway"] == d.nway
        assert got["slot_ratio"] == pytest.approx(d.slot_ratio, rel=0.1)

    def test_solve_parity(self, port, k):
        sym = _jittered(symmetric=True)
        b = np.asarray(sym @ jnp.ones(sym.shape[0], jnp.float64))
        mesh = make_mesh(k)
        d = distribute_wsell(sym, mesh)
        jres = dist_wsell_solve(d, b, solver="cg", epsilon=1e-10, mesh=mesh)
        got = ok(port, k, "wsell_cg")
        a_sp = scipy_csr(sym)
        check_solve(got, jres, collect(jres.x, d), a_sp, b, 1, 1e-10)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-7
        assert abs(got["iterations"] - got["single_iterations"]) <= 1
        check_self(port, k, "wsell_cg", a_sp, b, 1)

    def test_gmres_over_wsell(self, port, k):
        csr = _jittered()
        b = np.asarray(csr @ jnp.ones(csr.shape[0], jnp.float64))
        mesh = make_mesh(k)
        d = distribute_wsell(csr, mesh)
        jres = dist_wsell_solve(d, b, solver="gmres", epsilon=1e-9, mesh=mesh)
        got = ok(port, k, "wsell_gmres")
        check_solve(got, jres, collect(jres.x, d), scipy_csr(csr), b,
                    band(int(jres.iterations), 0.02, 2), 1e-9)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 1e-6


@pytest.mark.parametrize("k", WORLDS)
class TestMeshResolution:
    """Solve-time entry points take the mesh the operand was built on: here
    a group of the first half of the ranks (the JAX package: a mesh of the
    first half of its devices), with no mesh passed at solve time."""

    @staticmethod
    def sub(k):
        return make_mesh(max(k // 2, 1))

    def test_solve_defaults_to_operand_mesh(self, port, k):
        a = jgen.poisson_2d(12, dtype=np.float32)
        b = ones_rhs(a)
        da = distribute_csr(a, self.sub(k))
        jres = dist_solve(da, b, solver="cg", epsilon=1e-4)
        got = ok(port, k, "default_mesh_csr")
        check_solve(got, jres, collect(jres.x, da), scipy_csr(a), b,
                    band(int(jres.iterations), 0.02, 2), 1e-4)
        assert got["status"] == 0 and np.abs(got["x"] - 1.0).max() <= 5e-3

    def test_dia_default_mesh(self, port, k):
        a = jgen.poisson_2d(8, dtype=np.float32)
        b = ones_rhs(a)
        dd = distribute_dia(jax_dia_from_csr(a), self.sub(k))
        jres = dist_dia_solve(dd, b, solver="cg", epsilon=1e-4)
        got = ok(port, k, "default_mesh_dia")
        check_solve(got, jres, collect(jres.x, dd), scipy_csr(a), b,
                    band(int(jres.iterations), 0.02, 2), 1e-4)

    def test_stencil_default_mesh(self, port, k):
        a = jgen.poisson_2d(12, dtype=np.float32)
        b = ones_rhs(a)
        dst = distribute_stencil(jax_stencil(a), self.sub(k))
        jres = dist_stencil_solve(dst, b, solver="cg", epsilon=1e-4)
        got = ok(port, k, "default_mesh_stencil")
        check_solve(got, jres, collect(jres.x, dst), scipy_csr(a), b,
                    band(int(jres.iterations), 0.02, 2), 1e-4)

    def test_mismatched_mesh_rejected(self, port, k):
        """An operand of k shards with a mesh of k / 2 ranks: the JAX
        package's message (one rank has no smaller mesh)."""
        got = raised(port, k, "mismatched_mesh")
        if k == 1:
            assert got is None
            return
        with pytest.raises(ValueError, match=f"{k} shards") as jax_err:
            a = jgen.poisson_2d(12, dtype=np.float32)
            dist_solve(distribute_csr(a, make_mesh(k)), ones_rhs(a), solver="cg",
                       mesh=self.sub(k))
        assert got == ("ValueError", str(jax_err.value))

    def test_mismatched_axis_rejected(self, port, k):
        """A mesh of another axis name: a ValueError naming both axes (the
        JAX package raises a bare KeyError at mesh.py:155)."""
        kind, msg = raised(port, k, "mismatched_axis")
        assert kind == "ValueError" and "'cols'" in msg and "'rows'" in msg


def test_solve_check_refuses_a_wrong_x():
    """The solve comparison catches a wrong answer: x off by 1e-6 is no
    SUCCESS at eps 1e-10, whatever the other package returned."""
    a_sp = scipy_csr(jgen.poisson_2d(16))
    x = np.ones(256)
    b = a_sp @ x
    check_success(x, a_sp, b, 1e-10)
    with pytest.raises(AssertionError):
        check_success(x + 1e-6 * np.random.default_rng(0).standard_normal(256), a_sp, b,
                      1e-10)


def test_row_sum_in_entry_order():
    """The CSR shard product's row sum (ops/spmv.py:row_sum, which the
    single-device CSR product shares) adds each row's run of products in
    the entries' order (empty rows give 0): the bits of a sequential sum."""
    import torch

    from sparse_matrix_math_tpu_torch.ops.spmv import row_sum as _row_sum

    rng = np.random.default_rng(3)
    row_nnz = rng.integers(0, 7, 200)
    row_nnz[::17] = 0
    nnz = int(row_nnz.sum())
    vals = (rng.standard_normal(nnz) * 10.0 ** rng.integers(-6, 7, nnz)).astype(np.float32)
    want = np.zeros(200, np.float32)
    for i, (lo, m) in enumerate(zip(np.cumsum(row_nnz) - row_nnz, row_nnz)):
        acc = np.float32(0.0)
        for v in vals[lo:lo + m]:
            acc = np.float32(acc + v)
        want[i] = acc
    got = _row_sum(torch.from_numpy(vals),
                   torch.from_numpy(np.concatenate([[0], np.cumsum(row_nnz)])))
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.fixture
def one_rank():
    """A gloo world of one rank in this process."""
    import torch.distributed as dist

    from sparse_matrix_math_tpu_torch.parallel.mesh import GROUP_TIMEOUT

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=GROUP_TIMEOUT)
    try:
        yield tpar.make_mesh()
    finally:
        dist.destroy_process_group()


def test_spawn_reports_a_failed_rank(tmp_path):
    """A rank that raises stops the world at once (its peer, waiting in a
    collective, is killed) and its traceback reaches the caller."""
    import time

    import torch_dist_ranks

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank one fails"):
        tpar.spawn_cpu_world(torch_dist_ranks.fail_on_rank_one, 2, store_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_init_distributed_without_a_card_raises(monkeypatch):
    """The default device is the rank's CUDA card; with none, and no CPU
    asked for, nothing falls back to gloo."""
    import torch
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpar.init_distributed("file:///nonexistent/store", 1, 0)
    assert not dist.is_initialized()


def test_mesh_placement_and_gathering(one_rank):
    """make_mesh's size check, put_sharded under both shardings,
    gather_to_host, and the self exchange of a one-rank world."""
    import torch

    mesh = one_rank
    assert mesh.shape == {"rows": 1} and mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="requested 2 devices, only 1 available"):
        tpar.make_mesh(2)
    host = np.arange(12.0)
    rows = tpar.put_sharded(host, mesh, tpar.row_sharding(mesh))
    whole = tpar.put_sharded(host, mesh, tpar.replicated_sharding(mesh))
    assert rows.tolist() == whole.tolist() == host.tolist()
    np.testing.assert_array_equal(tpar.gather_to_host(rows, mesh), host)
    left, right = tpar.halo_exchange(rows, mesh)
    assert left is rows and right is rows
