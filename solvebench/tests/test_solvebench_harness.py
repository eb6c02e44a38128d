"""The harness on the CPU: metric arithmetic on synthetic timings and a
synthetic trace, discovery by name, the refusal to measure without a card,
the module check, and ``correct`` against the control and planted faults."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from solvebench import reference, run
from solvebench import trace as tracing

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "solvebench"
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _run_with(solves, cfg=None, traffic=None, trace=None, spans=None):
    cfg = cfg or {"operator": "stencil", "grid": [10, 10, 10], "dtype": "float32",
                  "stencil": {"points": 7, "diagonal": 6.0, "neighbour": -1.0}}
    r = run.Run(cfg, {"traffic": traffic or {"solve": {}}})
    r.solves = [run.Solve(*s) for s in solves]
    r.trace, r.spans = trace, spans
    return r


def test_solve_ms_and_p90_from_synthetic_timings():
    times = [0.1 * (i + 1) for i in range(20)]  # 0.1 .. 2.0 s
    r = _run_with([(t, 0, 10) for t in times])
    assert run.read_metric("solve_ms", r) == pytest.approx(1e3 * sum(times) / 20)
    # nearest rank: the 18th of 20
    assert run.read_metric("solve_p90_ms", r) == pytest.approx(1800.0)
    assert run.read_metric("iters_per_solve", r) == 10
    assert run.read_metric("solve_ms", _run_with([])) is None


def _synthetic_trace():
    # one solve span [0, 1000] ns; an spmv span [100, 300], an apply span
    # [400, 600], a build span [20, 60]; device ops launched in each
    spans = {"solve": [(0, 1000)], "spmv": [(100, 300)], "precond_apply": [(400, 600)],
             "precond_build": [(20, 60)]}
    ops = [tracing.DeviceOp("build", 30, 50, 25),
           tracing.DeviceOp("k3", 150, 350, 110),
           tracing.DeviceOp("sweep", 420, 700, 410),
           tracing.DeviceOp("axpy", 700, 800, 650),
           tracing.DeviceOp("dot", 850, 900, 690),
           tracing.DeviceOp("outside", 2000, 2100, 1500)]
    host = [(0, 1000, "solvebench.solve"), (640, 690, "aten::dot"),
            (800, 850, "aten::item")]
    return tracing.Trace(ops, spans, host)


def test_trace_attribution_and_idle_share():
    tr = _synthetic_trace()
    assert tr.window() == (0, 1000)
    assert tr.device_seconds("spmv") == pytest.approx(200e-9)
    assert tr.device_seconds("precond_apply") == pytest.approx(280e-9)
    assert tr.device_seconds("solve") == pytest.approx((20 + 200 + 280 + 100 + 50) * 1e-9)
    # busy: [30, 50] [150, 350] [420, 800] [850, 900] inside the window
    assert tr.busy_seconds() == pytest.approx((20 + 200 + 380 + 50) * 1e-9)
    r = _run_with([(1e-6, 0, 4)], trace=tr, spans=tracing.SpanCounts(
        calls={"spmv": 4, "precond_apply": 5, "precond_build": 1},
        host_s={"precond_build": 2e-3}))
    assert run.read_metric("device_idle_pct", r) == pytest.approx(100 * (1 - 650 / 1000))
    assert run.read_metric("spmv_us_per_iter", r) == pytest.approx(200e-3 / 4)
    assert run.read_metric("sweep_us_per_iter", r) == pytest.approx(280e-3 / 4)
    assert run.read_metric("vector_us_per_iter", r) == pytest.approx(150e-3 / 4)
    assert run.read_metric("precond_build_ms", r) == pytest.approx(2.0)
    # gaps [0,30] [50,150] [350,420] [800,850] [900,1000]; in [800, 850] the
    # host was in aten::item
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(50e-9)
    assert gaps["solvebench.solve"] == pytest.approx((30 + 100 + 70 + 100) * 1e-9)
    assert tr.top_device_ops(2) == [["sweep", pytest.approx(280e-9)],
                                    ["k3", pytest.approx(200e-9)]]


def test_rooflines_from_synthetic_trace():
    tr = _synthetic_trace()
    cfg = {"operator": "stencil", "grid": [100, 100, 100], "dtype": "float64",
           "stencil": {"points": 27, "diagonal": 26.0, "neighbour": -1.0}}
    spans = tracing.SpanCounts(calls={"spmv": 1, "precond_apply": 1})
    traffic = {"solve": {"preconditioner_options": {"sweeps": 4}}}
    r = _run_with([(1.0, 0, 1)], cfg=cfg, traffic=traffic, trace=tr, spans=spans)
    least = 2 * 10 ** 6 * 8 / 3.35e12  # bytes-bound at this size
    assert run.read_metric("spmv_roofline_pct", r) == pytest.approx(100 * least / 200e-9)
    assert run.read_metric("sweep_roofline_pct", r) == pytest.approx(100 * least / 280e-9)


def test_readers_find_nothing_without_a_linked_trace():
    tr = _synthetic_trace()
    unlinked = tracing.Trace([dataclasses.replace(op, launch=None) for op in tr.device_ops],
                             tr.spans, tr.host_ops)
    for trace in (None, unlinked):
        r = _run_with([(1.0, 0, 3)], trace=trace, spans=tracing.SpanCounts())
        for name in ("spmv_us_per_iter", "sweep_us_per_iter", "vector_us_per_iter",
                     "spmv_roofline_pct", "sweep_roofline_pct", "precond_build_ms"):
            assert run.read_metric(name, r) is None, name
    assert run.read_metric("device_idle_pct", _run_with([(1.0, 0, 3)])) is None


@pytest.mark.parametrize("kind, names", [
    ("spmv", ("spmv_us_per_iter", "spmv_roofline_pct")),
    ("precond_apply", ("sweep_us_per_iter", "sweep_roofline_pct")),
    ("precond_build", ("precond_build_ms",))])
def test_readers_find_nothing_where_a_span_misses_calls(kind, names):
    """A span that opened fewer times than the solves iterated (or, for the
    build, than there were solves) no longer wraps the call that does the
    work: its readers find nothing, and the run fails on it."""
    full = {"spmv": 4, "precond_apply": 4, "precond_build": 2}
    traffic = {"solve": {"preconditioner_options": {"sweeps": 4}}}
    solves = [(1e-6, 0, 2), (1e-6, 0, 2)]
    counts = tracing.SpanCounts(calls=dict(full), host_s={"precond_build": 1e-3})
    r = _run_with(solves, traffic=traffic, trace=_synthetic_trace(), spans=counts)
    assert all(run.read_metric(n, r) is not None for n in names)
    counts.calls[kind] -= 1
    for n in names:
        assert run.read_metric(n, r) is None, n


def test_a_span_target_that_does_not_resolve_raises():
    counts = tracing.SpanCounts()
    for target in ("sparse_matrix_math_tpu_torch.solvers._padded:no_such_call",
                   "sparse_matrix_math_tpu_torch.precond.padded_sgs:PaddedSGS.no_such",
                   "solvebench.no_such_module:f"):
        with pytest.raises(LookupError):
            with tracing.wrapped([{"target": target, "span": "spmv"}], counts):
                pass
    # the targets that resolve are restored when one fails
    import sparse_matrix_math_tpu_torch.solvers._padded as padded

    raw = padded.dia_spmv_padded
    with pytest.raises(LookupError):
        with tracing.wrapped([{"target": "sparse_matrix_math_tpu_torch.solvers._padded:"
                                         "dia_spmv_padded", "span": "spmv"},
                              {"target": "solvebench.no_such_module:f", "span": "spmv"}],
                             counts):
            pass
    assert padded.dia_spmv_padded is raw


def test_a_metric_the_manifest_lists_and_the_run_lacks_is_missing():
    manifest = {"end_to_end": [{"name": "a"}],
                "per_layer": [{"name": "c", "workloads": ["x"]}, {"name": "d"},
                              {"name": "e", "workloads": ["y"]}]}
    out = {"metrics": {"a": {"value": 1.0}, "c": {"value": 2.0}}}
    assert run.missing_metrics(manifest, "x", False, out) == []
    assert run.missing_metrics(manifest, "x", True, out) == ["d"]
    assert run.missing_metrics(manifest, "y", True, out) == ["d", "e"]


def test_every_manifest_entry_is_found_by_name():
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in configs.values():
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        wl, cfg = run.load_cell(w["name"])
        assert (wl["name"], wl["config"], wl["chips"]) == (w["name"], w["config"], w["chips"])
        assert cfg["name"] in configs
        for trace in (False, True):
            names = [m["name"] for m in run.cell_metrics(MANIFEST, w["name"], trace)]
            assert names, (w["name"], trace)
        assert "setup_s" in [m["name"] for m in run.cell_metrics(MANIFEST, w["name"], False)]
        assert (BENCH / "operators" / f"{cfg['operator']}.py").is_file(), cfg["name"]
    for t in tracing.span_targets(BENCH):
        owner, attr = tracing._resolve(t["target"])
        assert hasattr(owner, attr), t


def test_cell_metrics_follow_workloads_keys():
    manifest = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
                "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in run.cell_metrics(manifest, "x", False)] == ["a", "b"]
    assert [m["name"] for m in run.cell_metrics(manifest, "y", False)] == ["a"]
    assert [m["name"] for m in run.cell_metrics(manifest, "y", True)] == ["c"]


def test_no_card_means_no_result(monkeypatch, capsys):
    """The measurement path refuses to run without a CUDA card: no fallback
    to the CPU, no result line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_cell_of_more_than_one_card_is_refused(monkeypatch, capsys):
    """A cell of 4 cards on a machine with fewer is refused before any
    work, with no result line; so is one whose rows do not split into 4
    blocks of multiples of 8, by name, before any rank starts."""
    wl, cfg = run.load_cell(CELLS[0])
    monkeypatch.setattr(run, "load_cell", lambda name: (dict(wl, chips=4), cfg))
    monkeypatch.setattr(run, "pin_caches", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    argv = ["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]
    rc = run.main(argv)
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "needs 4 CUDA card(s); found 1" in captured.err
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(run, "load_cell", lambda name: (dict(wl, chips=4),
                                                        dict(cfg, grid=[6, 5, 4])))
    monkeypatch.setattr(run, "launch", lambda *a, **k: pytest.fail("a rank was started"))
    rc = run.main(argv)
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "has 120 rows, not a multiple of 8 x 4 ranks" in captured.err


def test_the_benchmark_alone_measures_nothing(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    has no program to run: the run exits non-zero with no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "solvebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "solvebench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    for name in ("jax.numpy", "flax", "sparse_matrix_math_tpu.solvers"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    found = run.forbidden_modules()
    assert "sparse_matrix_math_tpu.solvers" in found and "jax.numpy" in found
    assert "jaxtyping_like" not in found
    assert not any(m.startswith("sparse_matrix_math_tpu_torch") for m in found)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from solvebench import run\n"
        "wl, cfg = run.load_cell(%r)\n"
        "cfg = dict(cfg, grid=[6, 5, 4])\n"
        "for trace in (False, True):\n"
        "    run.run_cell(wl['name'], 3, 0.2, trace, torch.device('cpu'), run.load_json(\n"
        "        run.ROOT / 'BENCHMARK.json'), cell=(wl, cfg))\n"
        "print(run.forbidden_modules())\n" % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _tiny(name, grid=(8, 7, 6)):
    wl, cfg = run.load_cell(name)
    return wl, dict(cfg, grid=list(grid))


def _run_tiny(name, solver=None, seconds=0.3, seed=2**31 + 99):
    wl, cfg = _tiny(name)
    return run.run_cell(name, seed, seconds, False, torch.device("cpu"), MANIFEST,
                        solver=solver, cell=(wl, cfg))


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    out = _run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    c = out["checks"]
    assert c["worst_rel_residual"]["value"] <= c["worst_rel_residual"]["limit"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The plain reference's CG in the precision below the configuration's,
    in the program's place, fails the limit."""
    out = _run_tiny(name, solver=reference.control_solver(_tiny(name)[1]))
    assert not out["correct"]
    c = out["checks"]["worst_rel_residual"]
    assert c["value"] > c["limit"]


class _Faulty:
    """The port's solve with a fault planted where the answer is produced."""

    def __init__(self, fault):
        import sparse_matrix_math_tpu_torch as port

        self.port, self.fault, self.calls, self.last = port, fault, 0, None

    def __call__(self, op, b, **kw):
        res = self.port.solve(op, b, **kw)
        self.calls += 1
        x = res.x
        if self.fault == "unchanged":  # the state returned as it came in: x0
            x = torch.zeros_like(x)
        elif self.fault == "altered":  # one entry of the answer changed
            x = x.clone()
            x[x.shape[0] // 2] += 1e-3
        elif self.fault == "half":  # every second solve skipped: the last answer again
            if self.calls % 2 == 0 and self.last is not None:
                x = self.last
        elif self.fault == "claimed":  # a few iterations, claimed as converged
            x = self.port.solve(op, b, **dict(kw, max_iterations=2)).x
        elif self.fault == "status":  # the right answer, reported as not converged
            return dataclasses.replace(res, status=2)
        self.last = res.x
        return dataclasses.replace(res, x=x)


@pytest.mark.parametrize("fault", ["unchanged", "altered", "half", "claimed", "status"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_faults_are_not_correct(name, fault, monkeypatch):
    # every solution held to the reference, so that "half" is caught on
    # every run; a real run samples 8 of its ~17-73 solves
    monkeypatch.setattr(run, "SAMPLE", 10 ** 6)
    out = _run_tiny(name, solver=_Faulty(fault), seconds=0.5)
    assert out["attempted"] >= 2  # the second solve is the first that "half" skips
    assert not out["correct"], (fault, out["checks"])
    assert out["failed"] >= 1
    assert math.isfinite(out["checks"]["worst_rel_residual"]["value"]) or fault != "status"


class _Event:
    """A kineto event as torch's profiler gives it."""

    def __init__(self, name, device, start, end, corr=0, linked=0, annotation=False):
        self._v = (name, device, start, end, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def _prof(events):
    class R:
        def events(self):
            return events

    class P:
        kineto_results = R()

    class Prof:
        profiler = P()

    return Prof()


def test_from_profiler_links_device_operations_to_their_launch():
    # ids 5 and 6 are CUPTI correlations; 5 also names a host operator,
    # whose start (12) must not be taken for the kernel's launch (31)
    events = [
        _Event("solvebench.solve", False, 0, 1000, corr=1, annotation=True),
        _Event("solvebench.spmv", False, 10, 200, corr=2, annotation=True),
        _Event("aten::mul", False, 12, 20, corr=5),
        _Event("cudaLaunchKernel", False, 31, 33, corr=5, linked=2),
        _Event("dia_staged_kernel", True, 40, 140, corr=5, linked=2),
        _Event("solvebench.spmv", True, 40, 140, annotation=True),  # its device projection
        _Event("aten::add", False, 300, 320, corr=3),
        _Event("elementwise_kernel", True, 330, 360, corr=6, linked=3),  # no runtime event
        _Event("cuLaunchKernel", False, 500, 502, corr=7),
    ]
    tr = tracing.from_profiler(_prof(events))
    assert [(op.name, op.launch) for op in tr.device_ops] == [
        ("dia_staged_kernel", 31), ("elementwise_kernel", 300)]
    assert tr.spans == {"solve": [(0, 1000)], "spmv": [(10, 200)]}
    assert tr.device_seconds("spmv") == pytest.approx(100e-9)
    assert tr.device_seconds("solve") == pytest.approx(130e-9)
