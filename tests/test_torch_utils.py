"""The port's profiling and checkpoint modules (sparse_matrix_math_tpu_torch.utils)
held against the JAX package's: twin of tests/test_utils.py.

Profiling: ``spmv_throughput`` reports the JAX keys with positive rates for
every format; ``solve_with_stats`` gives JAX's status and iterations on the
same f64 system; ``trace`` writes a Chrome trace.  Checkpoints: a resumed
chunked solve equals the uninterrupted chunked run bit for bit (the chunk
boundaries are the same and the saved x is exact), and checkpoints and CSR
snapshots written by either package load in the other.
"""

import dataclasses
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu.utils import checkpoint as jck
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu.utils import profiling as jprof
from sparse_matrix_math_tpu_torch.utils import checkpoint as ck
from sparse_matrix_math_tpu_torch.utils import profiling as prof

S = smm.SolverStatus


def test_port_exports_every_top_level_name():
    assert set(jsmm.__all__) - set(smm.__all__) == set()
    for name in ("SolveStats", "solve_with_stats", "spmv_throughput", "checkpointed_solve",
                 "save_checkpoint", "load_checkpoint", "save_csr_npz", "load_csr_npz"):
        assert getattr(smm, name) is getattr(smm.utils, name)


@pytest.fixture(scope="module")
def system():
    a = smm.poisson_2d(16, device="cpu")
    return a, a @ torch.ones(a.shape[0], dtype=a.dtype)


def _host_residual(a, b, x):
    dense = a.to_dense().numpy()
    return float(np.linalg.norm(np.asarray(b, np.float64) - dense @ np.asarray(x, np.float64)))


# ---------------------------------------------------------------- profiling

FORMATS = {
    "csr": lambda a: a,
    "dia": smm.dia_from_csr,
    "ell": smm.ell_from_csr,
    "wsell": smm.wsell_from_csr,
    "routed": smm.routed_from_csr,
}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_spmv_throughput_every_format(system, fmt):
    a, _ = system
    m = FORMATS[fmt](a)
    stats = prof.spmv_throughput(m, iters=3)
    want = jprof.spmv_throughput(jax_gen.poisson_2d(16), iters=3)
    assert set(stats) == set(want) == {"seconds_per_op", "gnnz_per_s", "gflop_per_s"}
    assert stats["seconds_per_op"] > 0 and stats["gnnz_per_s"] > 0
    assert stats["gflop_per_s"] == pytest.approx(2 * stats["gnnz_per_s"])
    assert stats["gnnz_per_s"] == pytest.approx(m.nnz / stats["seconds_per_op"] / 1e9)


def test_spmv_throughput_default_x_and_benchmark_op(monkeypatch):
    a = smm.poisson_2d(8, dtype=torch.float32, device="cpu")
    seen = []

    def op(m, x):
        seen.append(x)
        return smm.rmult(m, x)

    sec = prof.benchmark_op(op, a, torch.ones(64, dtype=torch.float32), iters=3, warmup=0)
    assert sec > 0 and len(seen) == 1 + 3  # warmup runs at least once
    calls = []
    real = prof.benchmark_op
    monkeypatch.setattr(prof, "benchmark_op",
                        lambda f, m, x, iters: calls.append((m, x)) or real(f, m, x, iters=iters))
    prof.spmv_throughput(a, iters=2)
    (m, x), = calls
    assert m is a and x.dtype == torch.float32 and x.device == a.device
    assert torch.equal(x, torch.ones(64))


@pytest.mark.parametrize("solver", ["cg", "bicg_symmetric", "cgs", "bicgstab"])
def test_solve_with_stats_names_hit_the_table(system, solver):
    a, b = system
    fn = getattr(smm, solver)
    st = prof.solve_with_stats(fn, a, b, epsilon=1e-8, record_residuals=True)
    per_iter = {"cg": 1, "bicg_symmetric": 1, "cgs": 2, "bicgstab": 2}[solver]
    assert st.status == S.SUCCESS and st.iterations > 0 and st.wall_seconds > 0
    assert st.spmv_gnnz_per_s == pytest.approx(
        per_iter * st.iterations * a.nnz / st.wall_seconds / 1e9)
    assert st.seconds_per_iteration == pytest.approx(st.wall_seconds / st.iterations)
    assert isinstance(st.residual_trace, np.ndarray)
    assert st.residual_trace[st.iterations] <= 1e-8
    assert repr(st).startswith(f"SolveStats(status=0, iters={st.iterations}, residual=")


def test_solve_with_stats_matches_jax():
    """poisson_2d(32) f64, b = A @ ones, CG at 1e-8 in both packages: the
    same status and iteration count; the stats hold the solve's own."""
    ja = jax_gen.poisson_2d(32)
    jb = ja @ jnp.ones(ja.shape[0], jnp.float64)
    want = jprof.solve_with_stats(jsmm.cg, ja, jb, epsilon=1e-8)
    a = smm.poisson_2d(32, device="cpu")
    b = torch.from_numpy(np.array(jb))
    got = prof.solve_with_stats(smm.cg, a, b, epsilon=1e-8, warm=False)
    assert got.status == want.status == S.SUCCESS
    assert got.iterations == want.iterations
    assert got.residual_norm <= 1e-8 and want.residual_norm <= 1e-8
    assert got.residual_trace is None and want.residual_trace is None
    assert [f.name for f in dataclasses.fields(prof.SolveStats)] == [
        f.name for f in dataclasses.fields(jprof.SolveStats)]
    # an unknown solver name reports no SpMV rate, as in JAX
    other = prof.solve_with_stats(lambda *a, **k: smm.cg(*a, **k), a, b, epsilon=1e-8)
    assert other.spmv_gnnz_per_s is None and other.iterations == got.iterations


def test_trace_writes_a_chrome_trace(system, tmp_path):
    a, b = system
    log_dir = str(tmp_path / "trace")
    with prof.trace(log_dir) as p:
        smm.cg(a, b, epsilon=1e-8, max_iterations=3)
    files = glob.glob(os.path.join(log_dir, "trace.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::dot" for e in events)
    assert len(p.key_averages()) > 0


def test_sync_finds_the_first_tensor():
    x = torch.ones(3)
    res = smm.SolveResult(x=x, status=0, iterations=1, residual_norm=torch.tensor(0.0))
    assert prof._first_tensor(res) is x
    assert prof._first_tensor((None, [1, x])) is x
    assert prof._first_tensor(None) is None and prof._sync(7) == 7


# --------------------------------------------------------------- checkpoint

def _interrupting(solver, after_calls):
    """``solver`` that raises on call ``after_calls + 1``: a preemption
    between two chunks."""
    calls = {"n": 0}

    def run(*args, **kwargs):
        if calls["n"] == after_calls:
            raise KeyboardInterrupt("preempted")
        calls["n"] += 1
        return solver(*args, **kwargs)

    return run


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_resumed_chunked_solve_is_bitwise_the_uninterrupted_one(system, tmp_path, solver):
    a, b = system
    fn = getattr(smm, solver)
    kw = dict(chunk_iterations=10, epsilon=1e-9)
    whole = ck.checkpointed_solve(fn, a, b, checkpoint_path=str(tmp_path / "whole.npz"), **kw)
    path = str(tmp_path / "cut.npz")
    with pytest.raises(KeyboardInterrupt):
        ck.checkpointed_solve(_interrupting(fn, 2), a, b, checkpoint_path=path, **kw)
    assert ck.load_checkpoint(path).iterations_done == 20
    resumed = ck.checkpointed_solve(fn, a, b, checkpoint_path=path, **kw)
    assert resumed.status == whole.status == S.SUCCESS
    assert resumed.iterations == whole.iterations > 20
    assert torch.equal(resumed.x, whole.x)
    assert torch.equal(resumed.residual_norm, whole.residual_norm)
    assert ck.load_checkpoint(path).iterations_done == whole.iterations


def test_chunked_resume_matches(system, tmp_path):
    a, b = system
    path = str(tmp_path / "ck.npz")
    res = ck.checkpointed_solve(smm.cg, a, b, checkpoint_path=path, chunk_iterations=10,
                                epsilon=1e-9)
    assert res.status == S.SUCCESS and isinstance(res.iterations, int)
    np.testing.assert_allclose(res.x.numpy(), 1.0, atol=1e-7)
    saved = ck.load_checkpoint(path)
    assert saved is not None and saved.iterations_done == res.iterations
    with np.load(path) as z:
        assert z["iterations_done"].dtype == np.int64
        assert z["residual_norm"].dtype == np.float64
        assert z["x"].dtype == np.float64 and sorted(z.files) == [
            "iterations_done", "residual_norm", "x"]
    assert not glob.glob(str(tmp_path / "*.tmp.npz"))


def test_resume_from_converged_and_capped_checkpoints(system, tmp_path):
    a, b = system
    path = str(tmp_path / "ck.npz")
    first = ck.checkpointed_solve(smm.cg, a, b, checkpoint_path=path, chunk_iterations=50,
                                  epsilon=1e-9)
    calls = []

    def counting(*args, **kwargs):
        calls.append(kwargs["max_iterations"])
        return smm.cg(*args, **kwargs)

    again = ck.checkpointed_solve(counting, a, b, checkpoint_path=path, epsilon=1e-9)
    assert calls == [] and again.status == S.SUCCESS and again.floor_hit is False
    assert again.iterations == first.iterations and torch.equal(again.x, first.x)
    # a checkpoint already past the cap: one 0-iteration call reports the outcome
    capped = ck.checkpointed_solve(counting, a, b, checkpoint_path=path, epsilon=1e-14,
                                   max_iterations=first.iterations)
    assert calls == [0] and capped.status == S.MAX_ITERATIONS_REACHED
    assert capped.iterations == first.iterations


def test_resume_after_interrupt(system, tmp_path):
    a, b = system
    path = str(tmp_path / "ck.npz")
    r1 = ck.checkpointed_solve(smm.cg, a, b, checkpoint_path=path, chunk_iterations=5,
                               max_iterations=10, epsilon=1e-12)
    assert r1.status == S.MAX_ITERATIONS_REACHED
    assert ck.load_checkpoint(path).iterations_done == 10
    r2 = ck.checkpointed_solve(smm.cg, a, b, checkpoint_path=path, chunk_iterations=50,
                               epsilon=1e-9)
    assert r2.status == S.SUCCESS and r2.iterations > 10
    np.testing.assert_allclose(r2.x.numpy(), 1.0, atol=1e-7)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(system, tmp_path, writer):
    """Ten CG iterations checkpointed by one package, resumed to 1e-9 by the
    other; the host's float64 residual confirms the SUCCESS."""
    a, b = system
    ja = jax_gen.poisson_2d(16)
    jb = jnp.asarray(b.numpy())
    path = str(tmp_path / "ck.npz")
    kw = dict(checkpoint_path=path, chunk_iterations=5, max_iterations=10, epsilon=1e-12)
    if writer == "jax":
        first = jck.checkpointed_solve(jsmm.cg, ja, jb, **kw)
    else:
        first = ck.checkpointed_solve(smm.cg, a, b, **kw)
    assert int(first.iterations) == 10
    kw = dict(checkpoint_path=path, chunk_iterations=50, epsilon=1e-9)
    if writer == "jax":
        res = ck.checkpointed_solve(smm.cg, a, b, **kw)
        x = res.x.numpy()
    else:
        res = jck.checkpointed_solve(jsmm.cg, ja, jb, **kw)
        x = np.asarray(res.x)
    assert int(res.status) == S.SUCCESS and int(res.iterations) > 10
    assert _host_residual(a, b.numpy(), x) <= 1e-9
    assert jck.load_checkpoint(path).iterations_done == ck.load_checkpoint(
        path).iterations_done == int(res.iterations)


def test_csr_npz_roundtrip(system, tmp_path):
    a, _ = system
    p = str(tmp_path / "m.npz")
    ck.save_csr_npz(p, a)
    a2 = ck.load_csr_npz(p, device="cpu")
    assert a2.shape == a.shape and a2.device == a.device
    assert a.has_same_nonzero_pattern(a2)
    for f in ("data", "indices", "indptr", "row_ids"):
        assert torch.equal(getattr(a, f), getattr(a2, f))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_npz_cross_packages(tmp_path, dtype):
    ja = jax_gen.random_spd_csr(50, density=0.1, seed=2, dtype=dtype)
    ta = smm.csr_from_coo(smm.coo_from_arrays(
        np.asarray(ja.row_ids), np.asarray(ja.indices), np.asarray(ja.data), ja.shape,
        device="cpu"))
    from_jax, from_port = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jck.save_csr_npz(from_jax, ja)
    ck.save_csr_npz(from_port, ta)
    t_loaded = ck.load_csr_npz(from_jax, device="cpu")
    j_loaded = jck.load_csr_npz(from_port)
    for got in (t_loaded, ta):
        assert got.shape == ja.shape and got.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    for arrays in ((t_loaded.data.numpy(), t_loaded.indices.numpy(), t_loaded.indptr.numpy()),
                   (np.asarray(j_loaded.data), np.asarray(j_loaded.indices),
                    np.asarray(j_loaded.indptr))):
        np.testing.assert_array_equal(arrays[0], np.asarray(ja.data))
        np.testing.assert_array_equal(arrays[1], np.asarray(ja.indices))
        np.testing.assert_array_equal(arrays[2], np.asarray(ja.indptr))
