"""One run of one cell of the port's solve benchmark.

    python3 solvebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up makes the cell's operator and a pool of right-hand sides on the
card from the seed, lays the operator out once through the port's public
layout call the cell names, and runs one warm solve.  Then, as one caller in
a closed loop, it solves the pool's systems in turn, each from ``x0 = 0`` to
the configuration's tolerance times ``||b||``, for ``--seconds``.  With
``--trace 1`` the window runs under ``torch.profiler`` with spans around
the program's layers (``spans/``), for at most :data:`TRACE_SECONDS`.

Once the window has closed, a sample of its solutions drawn from the seed is
held to the plain reference's float64 true residual, and every solve's status
to SUCCESS.  The last line of standard output is the JSON result; the last
lines of standard error are the numbers compared, each beside its limit.
The cell's metrics are the ``BENCHMARK.json`` entries that apply to it, each
read by ``metrics/<name>.py``; a reader that finds nothing is left out.
"""

import time

_STARTED = time.perf_counter()  # set-up counts from here: imports included

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, NamedTuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the script's own directory would shadow standard modules (trace): import
# the benchmark and the program from the checkout's root instead
if sys.path and Path(sys.path[0] or ".").resolve() == BENCH:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# compile caches in fixed directories inside the checkout
CACHE = ROOT / ".bench_cache"
TRACE_SECONDS = 3.0  # the traced window's most
SAMPLE = 8           # solutions held to the reference per run
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_matrix_math_tpu")


class Solve(NamedTuple):
    seconds: float
    status: int
    iterations: int


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cfg: dict, workload: dict):
        self.cfg, self.traffic = cfg, workload["traffic"]
        self.solves: List[Solve] = []
        self.setup_s = self.layout_s = None
        self.trace = None  # trace.Trace of a traced window
        self.spans = None  # trace.SpanCounts of a traced window

    def iterations(self) -> int:
        return sum(s.iterations for s in self.solves)

    def span_calls(self, kind: str) -> int:
        """Calls of the traced window that opened a span of ``kind``."""
        return self.spans.calls.get(kind, 0) if self.spans else 0

    def device_us(self, kind: str):
        """Device microseconds launched inside spans of ``kind``; None when
        the trace links no device operation to its launch."""
        if self.trace is None or not self.trace.linked():
            return None
        return 1e6 * self.trace.device_seconds(kind)


class Sample:
    """A uniform sample of at most ``size`` solutions of a stream of unknown
    length (reservoir sampling), drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.kept = size, random.Random(seed), []

    def offer(self, k: int, x) -> None:
        if len(self.kept) < self.size:
            self.kept.append((k, x))
            return
        j = self.rng.randrange(k + 1)
        if j < self.size:
            self.kept[j] = (k, x)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    wl = load_json(BENCH / "workloads" / f"{name}.json")
    return wl, load_json(BENCH / "configs" / f"{wl['config']}.json")


def cell_metrics(manifest: dict, name: str, trace: bool) -> List[dict]:
    """The manifest's end-to-end (``trace`` false) or per-layer metrics that
    apply to the cell."""
    entries = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def read_metric(name: str, run: Run):
    spec = importlib.util.spec_from_file_location(f"solvebench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, manifest: dict,
             solver=None, started: float = None, cell=None) -> dict:
    """Run the cell once on ``device`` and return its result object.
    ``solver`` takes the place of the port's ``solve`` (the control);
    ``cell``, a (workload, configuration) pair, the cell's files."""
    import torch

    from solvebench import generate, reference
    from solvebench import trace as tracing

    started = time.perf_counter() if started is None else started
    wl, cfg = cell or load_cell(name)
    port = importlib.import_module("sparse_matrix_math_tpu_torch")
    run = Run(cfg, wl)
    traffic = wl["traffic"]
    dtype = getattr(torch, cfg["dtype"])
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    csr = generate.operator_csr(cfg, device, dtype, port.CSRMatrix)
    pool, norms = generate.rhs_pool(cfg, seed, traffic["pool"], traffic["perturbation"],
                                    device, dtype)
    sync()
    t0 = time.perf_counter()
    operator = getattr(port, traffic["layout"])(csr)
    sync()
    run.layout_s = time.perf_counter() - t0
    if operator is None:
        raise RuntimeError(f"{traffic['layout']} refused the {cfg['name']} operator")
    del csr
    solve = solver or port.solve
    options = dict(traffic["solve"])
    tol = float(cfg["tolerance"])
    counts = tracing.SpanCounts()

    def one(k: int):
        i = k % len(pool)
        with tracing.span("solve", counts) if trace else contextlib.nullcontext():
            t1 = time.perf_counter()
            res = solve(operator, pool[i], epsilon=tol * norms[i], **options)
            sync()
            return res, time.perf_counter() - t1

    one(0)  # warm: every kernel this cell runs is built and loaded here
    gc.collect()
    run.setup_s = time.perf_counter() - started

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    sample = Sample(SAMPLE, seed)
    if trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        ctx = contextlib.ExitStack()
        prof = ctx.enter_context(profile(activities=activities))
        ctx.enter_context(tracing.wrapped(tracing.span_targets(BENCH), counts))
    else:
        ctx = contextlib.nullcontext()
    with ctx:
        t_start = time.perf_counter()
        k = 0
        while k == 0 or time.perf_counter() - t_start < window:
            res, sec = one(k)
            run.solves.append(Solve(sec, int(res.status), int(res.iterations)))
            sample.offer(k, res.x)
            k += 1
        window_s = time.perf_counter() - t_start
    del res
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del operator
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        run.trace, run.spans = tracing.from_profiler(prof), counts

    failing = {k for k, s in enumerate(run.solves) if s.status != 0}
    worst = 0.0
    for k, x in sample.kept:
        rel = reference.relative_residual(cfg, x, pool[k % len(pool)])
        worst = max(worst, rel)
        if not rel <= tol:
            failing.add(k)
    checks = {"worst_rel_residual": {"value": worst, "limit": tol},
              "solves_not_success": {"value": sum(s.status != 0 for s in run.solves),
                                     "limit": 0}}

    metrics = {}
    for m in cell_metrics(manifest, name, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(memory_peak),
           "power_limit_w": _power_limit() if on_card else None}
    out = {"correct": not failing and bool(run.solves), "attempted": len(run.solves),
           "failed": len(failing), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_seconds(), run.trace.window_seconds()
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["measured_s"] = window_s
    out["sampled"] = len(sample.kept)
    out["checks"] = checks
    return out


def _power_limit():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,"
                              "nounits", "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def missing_metrics(manifest: dict, name: str, trace: bool, out: dict) -> List[str]:
    """The manifest's metrics of the cell that the run's readers found
    nothing for: a reader finds nothing where the program no longer runs
    the code its span wraps, or where its trace links nothing."""
    return [m["name"] for m in cell_metrics(manifest, name, trace)
            if m["name"] not in out["metrics"]]


def report(out: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for key, c in out["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def pin_caches() -> None:
    """Point every compile cache the process may use at fixed directories
    inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, solver_for=None) -> int:
    """Run one cell on the card; ``solver_for(cfg)`` gives a solver to put in
    the program's place (the control)."""
    args = parse_args(argv)
    import torch

    # the system under test: where it is missing there is nothing to measure
    importlib.import_module("sparse_matrix_math_tpu_torch")
    wl, cfg = load_cell(args.workload)
    if int(wl["chips"]) != 1:
        print(f"{args.workload} asks for {wl['chips']} cards: this harness runs one "
              "process on one card, and has no multi-rank runner yet", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    pin_caches()
    torch.set_num_threads(1)
    solver = solver_for(cfg) if solver_for else None
    manifest = load_json(ROOT / "BENCHMARK.json")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), manifest, solver=solver, started=_STARTED)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    missing = missing_metrics(manifest, args.workload, bool(args.trace), out)
    if missing and not solver_for:
        print(f"no reading of {', '.join(missing)}, which BENCHMARK.json lists for "
              f"{args.workload}", file=sys.stderr)
        return 4
    report(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
