"""The port's command line (python -m sparse_matrix_math_tpu_torch) held
against the JAX package's: twin of tests/test_cli.py.

Both mains run in this process on matrices the test writes (dense-text
files through ``save_dense_text`` and a symmetric MatrixMarket file); the port gets
``--device cpu``.  The JSON lines have the same keys and, timings aside,
the same values: ``info`` exactly; ``solve`` the same status and iteration
count and the residual to 1e-6 relative (the dots sum in other orders);
``bench-spmv`` the same formats, each with the three rate keys or None in
both.  The exit codes are equal, the failure exit code too.
"""

import json

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu as jsmm
from sparse_matrix_math_tpu.__main__ import main as jax_main
from sparse_matrix_math_tpu.io import save_dense_text
from sparse_matrix_math_tpu.utils import generate as jax_gen
from sparse_matrix_math_tpu_torch.__main__ import main as port_main


def run(capsys, main, argv):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return rc, json.loads(out)


def both(capsys, argv, head=()):
    """(rc, json) of the JAX CLI and of the port's on ``cpu``."""
    return (run(capsys, jax_main, [*head, *argv]),
            run(capsys, port_main, ["--device", "cpu", *head, *argv]))


def write_mtx(path, a):
    """The lower triangle of a symmetric CSR matrix as a MatrixMarket
    coordinate real symmetric file (1-based indices)."""
    rows, cols = np.asarray(a.row_ids), np.asarray(a.indices)
    vals = np.asarray(a.data)
    keep = rows >= cols
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {int(keep.sum())}\n")
        for r, c, v in zip(rows[keep], cols[keep], vals[keep]):
            f.write(f"{r + 1} {c + 1} {float(v)!r}\n")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    # a nonsymmetric pattern: a tridiagonal Laplacian with one entry above the band
    skew = np.diag(np.full(30, 4.0)) - np.eye(30, k=1) - np.eye(30, k=-1)
    skew[0, 5] = -0.5
    out = {}
    for name, a in (("poisson", jax_gen.poisson_2d(8)),
                    ("convection", jax_gen.convection_diffusion_2d(8)),
                    ("skew", jsmm.csr_from_dense(skew))):
        out[name] = str(d / f"{name}.smmdt")
        save_dense_text(out[name], a)
    out["mesh"] = str(d / "mesh.mtx")
    write_mtx(out["mesh"], jax_gen.poisson_2d(7))
    return out


@pytest.mark.parametrize("name", ["poisson", "convection", "skew", "mesh"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_info_matches_jax(capsys, files, name, dtype):
    (jrc, want), (rc, got) = both(capsys, ["info", files[name]], head=("--dtype", dtype))
    assert rc == jrc == 0
    assert got == want
    assert got["dtype"] == {"f64": "float64", "f32": "float32"}[dtype]
    assert got["symmetric_pattern"] is (name != "skew")


SOLVES = [
    ("poisson", ["--method", "cg"]),
    ("mesh", ["--method", "cg"]),
    ("poisson", ["--method", "bicg_symmetric"]),
    ("poisson", ["--method", "cgs"]),
    ("poisson", ["--method", "cg", "--preconditioner", "jacobi"]),
    ("poisson", ["--method", "cg", "--preconditioner", "ic0"]),
    ("poisson", ["--method", "cg", "--preconditioner", "chebyshev"]),
    ("convection", ["--method", "bicgstab", "--preconditioner", "sgs"]),
    ("convection", ["--method", "bicgstab", "--preconditioner", "ilu0"]),
    ("convection", ["--method", "gmres"]),
    ("skew", ["--method", "bicgstab", "--tol", "1e-10"]),
]


@pytest.mark.parametrize("name,argv", SOLVES, ids=[f"{n}-{'-'.join(a[1::2])}" for n, a in SOLVES])
def test_solve_matches_jax(capsys, files, name, argv):
    (jrc, want), (rc, got) = both(capsys, ["solve", files[name], *argv])
    assert rc == jrc == 0
    assert set(got) == set(want) == {"status", "iterations", "residual_norm"}
    assert got["status"] == want["status"] == "SUCCESS"
    assert got["iterations"] == want["iterations"]
    assert got["residual_norm"] == pytest.approx(want["residual_norm"], rel=1e-6, abs=1e-12)


def test_solve_failure_exit_code(capsys, files):
    argv = ["solve", files["poisson"], "--max-iterations", "1", "--tol", "1e-14"]
    (jrc, want), (rc, got) = both(capsys, argv)
    assert rc == jrc == 1
    assert got["status"] == want["status"] == "MAX_ITERATIONS_REACHED"
    assert got["iterations"] == want["iterations"] == 1
    assert got["residual_norm"] == pytest.approx(want["residual_norm"], rel=1e-6)


def test_solve_output_and_rhs_files(capsys, files, tmp_path):
    rhs = str(tmp_path / "b.npy")
    np.save(rhs, np.random.default_rng(3).standard_normal(64))
    outs = [str(tmp_path / "jx.npy"), str(tmp_path / "tx.npy")]
    for main, out, head in ((jax_main, outs[0], []), (port_main, outs[1], ["--device", "cpu"])):
        rc, js = run(capsys, main, [*head, "solve", files["poisson"], "--rhs", rhs,
                                    "--output", out])
        assert rc == 0 and js["status"] == "SUCCESS" and js["output"] == out
    jx, tx = np.load(outs[0]), np.load(outs[1])
    assert tx.dtype == jx.dtype == np.float64 and tx.shape == (64,)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9)
    rc, js = run(capsys, port_main, ["--device", "cpu", "solve", files["poisson"],
                                     "--output", outs[1]])
    assert rc == 0 and js["output"] == outs[1]
    np.testing.assert_allclose(np.load(outs[1]), 1.0, atol=1e-7)


@pytest.mark.parametrize("routed", [False, True])
def test_bench_spmv_matches_jax(capsys, files, routed):
    argv = ["bench-spmv", files["poisson"], "--iters", "2"] + (["--routed"] if routed else [])
    (jrc, want), (rc, got) = both(capsys, argv)
    assert rc == jrc == 0
    assert set(got) == set(want) >= {"csr", "dia", "ell", "wsell"}
    assert ("rsell" in got) is routed
    for fmt, stats in got.items():
        assert (stats is None) == (want[fmt] is None), fmt
        if stats is not None:
            assert set(stats) == set(want[fmt]) == {"seconds_per_op", "gnnz_per_s",
                                                    "gflop_per_s"}
            assert stats["gnnz_per_s"] > 0


def test_device_flag_defaults_to_cuda(files):
    """Without --device the CLI loads onto the card; with no card torch
    refuses the CUDA tensors rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        port_main(["info", files["poisson"]])
