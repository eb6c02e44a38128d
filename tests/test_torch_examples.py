"""The port's example scripts (examples/torch_*.py) run end to end at the
sizes tests/test_examples.py gives the JAX package's, on the CPU, and print
the lines that file checks: twin of tests/test_examples.py.  Each script
runs on the card unless given ``--cpu`` (or ``device="cpu"``)."""

import importlib.util
import os
import subprocess
import sys

import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXAMPLES, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _value(out, key):
    line = [ln for ln in out.splitlines() if key in ln][0]
    return float(line.split(key)[1].split()[0].rstrip(","))


def test_poisson_solve_example(capsys):
    _load("torch_poisson_solve").main(16, device="cpu")
    out = capsys.readouterr().out
    assert "PCG+IC0" in out
    assert "SolveStats(status=0" in out and "PCG+IC0: SolveResult(status=SUCCESS" in out
    assert _value(out, "max |x - 1| =") < 1e-4


def test_unstructured_solve_example(capsys):
    _load("torch_unstructured_solve").main(16, device="cpu")
    out = capsys.readouterr().out
    assert "nonsymmetric BiCGStab+SGS: status=0" in out
    assert "auto-format CG: status=0" in out and "nonsymmetric GMRES+ILU0: status=0" in out
    assert "multi-RHS PCG+SGS: statuses=[0, 0, 0, 0]" in out


def test_multigrid_solve_example(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["torch_multigrid_solve.py", "33", "--cpu"])
    _load("torch_multigrid_solve").main()
    out = capsys.readouterr().out
    assert "iterations" in out or "status" in out
    assert "n=1089: PCG+V-cycle" in out and "status=0" in out


def test_df64_solve_example(capsys):
    _load("torch_df64_solve").main(24, device="cpu")
    out = capsys.readouterr().out
    assert "cg_df64: status=SUCCESS" in out
    # the printed true residual must actually be at the 1e-10 bar
    line = [ln for ln in out.splitlines() if "true residual" in ln][0]
    assert float(line.split(":")[1].strip()) < 1e-9
    assert "cg_ir_df64 (+mg inner): status=SUCCESS" in out


def test_accuracy_autopilot_example(capsys):
    _load("torch_accuracy_autopilot").main(24, device="cpu")
    out = capsys.readouterr().out
    assert "floor_hit = " in out
    assert "DfSolveResult SUCCESS" in out
    assert "floor_hit = True" in out and _value(out, "true ||b-Ax|| =") <= 1e-8


def test_poisson3d_1e8_example(capsys):
    _load("torch_poisson3d_1e8").main(11, device="cpu")
    out = capsys.readouterr().out
    assert "SUCCESS" in out
    assert _value(out, "f64 true residual") <= 1e-8


def test_cpu_switch_from_the_command_line():
    """``--cpu`` on the command line, as a user runs the script."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(EXAMPLES, "torch_poisson_solve.py"),
                          "12", "--cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "PCG+IC0: SolveResult(status=SUCCESS" in out.stdout


def test_examples_import_no_jax():
    """Loading every port example leaves jax and the JAX package out of
    sys.modules."""
    code = (
        "import glob, importlib.util, os, sys\n"
        f"for path in sorted(glob.glob(os.path.join({EXAMPLES!r}, 'torch_*.py'))):\n"
        "    spec = importlib.util.spec_from_file_location('ex', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'sparse_matrix_math_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
