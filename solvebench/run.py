"""One run of one cell of the port's solve benchmark.

    python3 solvebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up makes the cell's operator and a pool of right-hand sides on the
card (one set for every seed, in the seed's order: ``generate.py``), lays
the operator out once through the port's public layout call the cell names,
and runs one warm solve.  Then, as one caller in
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

A cell of P > 1 cards runs as P rank processes of the same script, rank r on
``cuda:r`` (:func:`launch`).  Each builds only its own contiguous block of
the rows, lays it out through the port's call the cell names with the mesh,
and solves its block of each system (:func:`run_rank`); a solve's time is the
slowest rank's, and each metric the worst rank's.  Rank 0 judges the gathered
solutions and prints the result.
"""

import time

_STARTED = time.perf_counter()  # set-up counts from here: imports included
_STARTED_WALL = time.time()     # the same instant on the clock that rank processes share

import argparse  # noqa: E402
import contextlib  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402
from datetime import timedelta  # noqa: E402
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

PORT = "sparse_matrix_math_tpu_torch"
# compile caches in fixed directories inside the checkout
CACHE = ROOT / ".bench_cache"
TRACE_SECONDS = 3.0  # the traced window's most
SAMPLE = 8           # solutions held to the reference per run
FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_matrix_math_tpu")

# A multi-rank run: a rank's collectives fail after GROUP_TIMEOUT instead of
# hanging; the launcher ends the ranks after LAUNCH_SECONDS (a first run
# builds the kernels).
GROUP_TIMEOUT = timedelta(seconds=600)
LAUNCH_SECONDS = 1200.0
STARTED_VAR = "SOLVEBENCH_STARTED"   # the launcher's start on the wall clock
LAUNCHER_VAR = "SOLVEBENCH_LAUNCHER"  # the launcher's process id


class Solve(NamedTuple):
    seconds: float
    status: int
    iterations: int


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cfg: dict, workload: dict, share=1):
        self.cfg, self.traffic = cfg, workload["traffic"]
        self.share = share  # this rank's rows over all of them: 1 on one card
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


def read_metrics(manifest: dict, name: str, trace: bool, run: Run) -> dict:
    """The cell's metrics that the run's readers found something for."""
    metrics = {}
    for m in cell_metrics(manifest, name, trace):
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def _profiled(trace: bool, on_card: bool, counts):
    """The window's context and its profiler: ``torch.profiler``, started
    here, and the span wrappers when ``trace``; else nothing."""
    if not trace:
        return contextlib.nullcontext(), None
    from torch.profiler import ProfilerActivity, profile

    from solvebench import trace as tracing

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    ctx = contextlib.ExitStack()
    prof = ctx.enter_context(profile(activities=activities))
    ctx.enter_context(tracing.wrapped(tracing.span_targets(BENCH), counts))
    return ctx, prof


def _window(run: Run, one, sample: Sample, window: float, go=bool) -> float:
    """Solve the pool in turn, once at least, while ``go`` (given whether
    the window has time left) says so; the seconds it took."""
    t_start = time.perf_counter()
    k = 0
    while True:
        res, sec = one(k)
        run.solves.append(Solve(sec, int(res.status), int(res.iterations)))
        sample.offer(k, res.x)
        k += 1
        if not go(time.perf_counter() - t_start < window):
            break
    return time.perf_counter() - t_start


def _result(run: Run, failing: set, worst: float, tol: float, metrics: dict, dev: dict,
            window_s: float, sampled: int, trace: bool) -> dict:
    checks = {"worst_rel_residual": {"value": worst, "limit": tol},
              "solves_not_success": {"value": sum(s.status != 0 for s in run.solves),
                                     "limit": 0}}
    out = {"correct": not failing and bool(run.solves), "attempted": len(run.solves),
           "failed": len(failing), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_seconds(), run.trace.window_seconds()
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["measured_s"] = window_s
    out["sampled"] = sampled
    out["checks"] = checks
    return out


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
    port = importlib.import_module(PORT)
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
    operator = port_attr(traffic["layout"])(csr)
    sync()
    run.layout_s = time.perf_counter() - t0
    if operator is None:
        raise RuntimeError(f"{traffic['layout']} refused the {cfg['name']} operator")
    del csr
    solve = solver or port_attr(traffic.get("call", "solve"))
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
    ctx, prof = _profiled(trace, on_card, counts)
    with ctx:
        window_s = _window(run, one, sample, window)
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

    metrics = read_metrics(manifest, name, trace, run)
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(memory_peak),
           "power_limit_w": _power_limit() if on_card else None}
    return _result(run, failing, worst, tol, metrics, dev, window_s, len(sample.kept), trace)


# -- a cell of more than one card ---------------------------------------------


def rank_rows(cfg: dict, world: int, rank: int):
    """``(lo, hi)``: rank ``rank``'s block of the operator's rows split into
    ``world`` contiguous blocks, for a grid a slab of its slowest axis.  A
    ValueError names an operator that cannot build a block of rows, or a
    row count that is not a multiple of 8 x ``world`` (the port pads its
    row blocks to multiples of 8, and a rank's block has to be its own)."""
    from solvebench import reference

    module = reference.operator(cfg)
    if not hasattr(module, "csr_rows"):
        raise ValueError(f"operator {cfg['operator']!r} has no csr_rows: a cell of "
                         f"{world} ranks needs one rank's rows")
    n = module.rows(cfg)
    if n % (8 * world):
        raise ValueError(f"{cfg['name']} has {n} rows, not a multiple of 8 x {world} ranks")
    return rank * n // world, (rank + 1) * n // world


def port_attr(dotted: str):
    """The port's ``<module>.<name>`` (``parallel.dist_solve``), or its
    top-level ``<name>``; a LookupError names one that does not resolve."""
    module, _, attr = dotted.rpartition(".")
    try:
        return getattr(importlib.import_module(f"{PORT}.{module}" if module else PORT), attr)
    except (ImportError, AttributeError) as err:
        raise LookupError(f"{dotted} is not a call of {PORT}: {err!r}") from err


def combined_solves(per_rank: List[List[Solve]]) -> List[Solve]:
    """The ranks' solves taken together, solve by solve: the slowest rank's
    seconds, the first status other than SUCCESS, the most iterations."""
    if len({len(solves) for solves in per_rank}) != 1:
        raise RuntimeError(f"the ranks ran {[len(s) for s in per_rank]} solves")
    return [Solve(max(s.seconds for s in same),
                  next((s.status for s in same if s.status != 0), 0),
                  max(s.iterations for s in same)) for same in zip(*per_rank)]


def worst_readings(per_rank: List[dict], specs: List[dict]) -> dict:
    """Each metric's worst reading over the ranks, by its ``better``: the
    largest where lower is better, the smallest where higher is.  A metric
    that some rank found nothing for is left out."""
    metrics = {}
    for m in specs:
        values = [readings[m["name"]]["value"] for readings in per_rank
                  if m["name"] in readings]
        if values and len(values) == len(per_rank):
            pick = max if m["better"] == "lower" else min
            metrics[m["name"]] = {"value": pick(values), "unit": m["unit"]}
    return metrics


def _on_whole_system(solver, mesh, lo: int, hi: int):
    """``solver`` (the control), which solves the whole system on one
    device, in the place of a multi-rank call: each rank gathers the whole
    right-hand side, solves it, and keeps its own rows of the solution."""
    import torch
    import torch.distributed as dist

    def call(operator, b_local, epsilon, **options):
        parts = [torch.empty_like(b_local) for _ in range(mesh.size)]
        dist.all_gather(parts, b_local.contiguous(), group=mesh.group)
        res = solver(operator, torch.cat(parts), epsilon=epsilon, **options)
        return types.SimpleNamespace(x=res.x[lo:hi], status=res.status,
                                     iterations=res.iterations)

    return call


def run_rank(name: str, seed: int, seconds: float, trace: bool, mesh, manifest: dict,
             solver=None, started_wall: float = None, cell=None):
    """This rank's part of one run of a cell over ``mesh.size`` ranks:
    ``(result, readings)``, the result object on rank 0 (None on the
    others) and this rank's own metric readings.  ``solver`` (the control)
    takes the program's place on the whole system; ``started_wall`` is the
    launcher's start on the wall clock."""
    import torch
    import torch.distributed as dist

    from solvebench import generate, reference
    from solvebench import trace as tracing

    started_wall = time.time() if started_wall is None else started_wall
    wl, cfg = cell or load_cell(name)
    port = importlib.import_module(PORT)
    traffic = wl["traffic"]
    dtype = getattr(torch, cfg["dtype"])
    device, group = mesh.device, mesh.group
    on_card = device.type == "cuda"
    lo, hi = rank_rows(cfg, mesh.size, mesh.rank)
    run = Run(cfg, wl, share=(hi - lo) / reference.operator(cfg).rows(cfg))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def gathered(value) -> list:
        everyone = [None] * mesh.size
        dist.all_gather_object(everyone, value, group=group)
        return everyone

    csr = generate.operator_rows(cfg, lo, hi, device, dtype, port.CSRMatrix)
    pool, norms = generate.rhs_pool(cfg, seed, traffic["pool"], traffic["perturbation"],
                                    device, dtype, rows=(lo, hi))
    sync()
    dist.barrier(group=group)
    t0 = time.perf_counter()
    operator = port_attr(traffic["layout"])(csr, mesh)
    sync()
    run.layout_s = max(gathered(time.perf_counter() - t0))
    if operator is None:
        raise RuntimeError(f"{traffic['layout']} refused the {cfg['name']} operator")
    del csr
    solve = (_on_whole_system(solver, mesh, lo, hi) if solver
             else port_attr(traffic.get("call", "solve")))
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
    window_start = time.time()

    flag = torch.zeros(1, dtype=torch.int32, device=device)

    def go(more: bool) -> bool:
        """Rank 0's decision, on every rank, outside the timed solves."""
        flag.fill_(int(more))
        dist.broadcast(flag, src=mesh.global_rank(0), group=group)
        return bool(flag.item())

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    sample = Sample(SAMPLE, seed)
    ctx, prof = _profiled(trace, on_card, counts)
    with ctx:
        window_s = _window(run, one, sample, window, go)
    memory_peak = max(gathered(torch.cuda.max_memory_allocated(device) if on_card else 0))
    del operator
    if on_card:
        torch.cuda.empty_cache()
    if trace:
        run.trace, run.spans = tracing.from_profiler(prof), counts
    run.solves = combined_solves(gathered(run.solves))
    run.setup_s = max(gathered(window_start)) - started_wall

    failing = {k for k, s in enumerate(run.solves) if s.status != 0}
    worst = 0.0
    for k, x in sample.kept:
        whole = _gathered_block(x, hi - lo, mesh)
        if mesh.rank == 0:
            member = generate.rhs_order(seed, len(pool))[k % len(pool)]
            b = generate.rhs(cfg, member, traffic["perturbation"], device, dtype)
            rel = reference.relative_residual(cfg, whole, b)
            worst = max(worst, rel)
            if not rel <= tol:
                failing.add(k)

    readings = read_metrics(manifest, name, trace, run)
    everyone = gathered(readings)
    if mesh.rank != 0:
        return None, readings
    metrics = worst_readings(everyone, cell_metrics(manifest, name, trace))
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": mesh.size, "memory_peak_bytes": int(memory_peak),
           "power_limit_w": _power_limit() if on_card else None}
    out = _result(run, failing, worst, tol, metrics, dev, window_s, len(sample.kept), trace)
    return out, readings


def _gathered_block(x, rows: int, mesh):
    """The ranks' blocks of a solution, in float64, concatenated on rank 0
    (None on the others).  A block that is not a vector of this rank's
    ``rows`` goes as NaN, so that the whole reads infinity."""
    import torch
    import torch.distributed as dist

    if isinstance(x, torch.Tensor) and tuple(x.shape) == (rows,):
        block = x.to(device=mesh.device, dtype=torch.float64).contiguous()
    else:
        block = torch.full((rows,), math.nan, dtype=torch.float64, device=mesh.device)
    parts = [torch.empty_like(block) for _ in range(mesh.size)] if mesh.rank == 0 else None
    dist.gather(block, parts, dst=mesh.global_rank(0), group=mesh.group)
    return torch.cat(parts) if parts else None


def rank_main(args, manifest: dict, solver_for=None, backend: str = "nccl", cell=None) -> int:
    """One rank process of a multi-rank run, as :func:`launch` starts it:
    joins the default process group from the environment (rank r on
    ``cuda:r`` under NCCL, the CPU under gloo) with a finite timeout, runs
    its part of the cell on the port's mesh, and checks its own process.
    Rank 0 prints the result where every rank's check passed.  A rank that
    fails prints why and ends at once, so that the launcher stops the
    others; one that is stopped prints its threads' stacks."""
    import torch
    import torch.distributed as dist

    _end_with_launcher()
    faulthandler.register(signal.SIGTERM, all_threads=True, chain=True)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    try:
        dist.init_process_group(backend, init_method="env://", world_size=world, rank=rank,
                                timeout=GROUP_TIMEOUT)
        mesh = importlib.import_module(f"{PORT}.parallel").make_mesh()
        wl, cfg = cell or load_cell(args.workload)
        solver = solver_for(cfg) if solver_for else None
        out, readings = run_rank(args.workload, args.seed, args.seconds, bool(args.trace), mesh,
                                 manifest, solver=solver, cell=(wl, cfg),
                                 started_wall=float(os.environ.get(STARTED_VAR, _STARTED_WALL)))
        code = closing_check(manifest, args.workload, bool(args.trace), readings, solver_for)
        codes = [None] * world
        dist.all_gather_object(codes, code)
        dist.destroy_process_group()
    except Exception:  # a rank's boundary: report, and end without the
        # process group's teardown, which can wait on peers that are gone
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if out is not None and not any(codes):
        report(out)
    return code


def _end_with_launcher() -> None:
    """Have the kernel end this process when the launcher ends (Linux), so
    that no rank outlives a launcher that was killed."""
    try:
        import ctypes

        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        return
    if os.environ.get(LAUNCHER_VAR) not in (None, str(os.getppid())):
        os._exit(1)  # the launcher ended before the call above


def launch(script: str, args: List[str], world: int, seconds: float = LAUNCH_SECONDS) -> int:
    """Run ``script`` with ``args`` as ``world`` rank processes through
    ``torch.distributed.run`` (torchrun, in this process: it sets ``RANK``,
    ``LOCAL_RANK`` and ``WORLD_SIZE``, joins the ranks at a free port on
    127.0.0.1 and, where one rank fails, stops the others), and wait for
    them for at most ``seconds``.  The ranks write to this process's
    standard output, and to its standard error with each line led by
    ``[rank<r>]:``.  Returns 0 where every rank exited 0; the
    first failed rank's code (128 + the signal) where one did not, named on
    standard error; 1 where the time ran out, after each rank still running
    has printed its stacks.  Every rank has ended when this returns."""
    from torch.distributed import run as torchrun
    from torch.distributed.elastic.multiprocessing.api import SignalException
    from torch.distributed.elastic.multiprocessing.errors import ChildFailedError

    os.environ.update({STARTED_VAR: repr(_STARTED_WALL), LAUNCHER_VAR: str(os.getpid()),
                       # each line of a rank's standard error begins with its name
                       "TORCHELASTIC_LOG_LINE_PREFIX_TEMPLATE": "[rank${rank}]:"})
    # each rank's share of the cores for its host threads (torchrun would set 1)
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, len(os.sched_getaffinity(0)) // world)))
    # torchrun leaves its handlers of these in place: put the caller's back
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT,
                                                 signal.SIGHUP, signal.SIGQUIT)}
    late = threading.Event()

    def time_out():
        late.set()
        os.kill(os.getpid(), signal.SIGTERM)  # torchrun stops the ranks on it

    timer = threading.Timer(seconds, time_out)
    timer.start()
    logs = tempfile.TemporaryDirectory(prefix="solvebench_ranks_")
    try:
        torchrun.run(torchrun.parse_args([
            "--standalone", f"--nproc-per-node={world}", "--local-addr=127.0.0.1",
            "--tee=2", f"--log-dir={logs.name}", script, *args]))
        return 0
    except ChildFailedError as err:
        for rank, failure in sorted(err.failures.items()):
            c = failure.exitcode
            how = f"exited with code {c}" if c > 0 else f"was ended by signal {-c}"
            print(f"rank {rank} of {world} {how}; its lines on standard error are above",
                  file=sys.stderr)
        c = err.get_first_failure()[1].exitcode
        return c if c > 0 else 128 - c
    except SignalException as err:
        if not late.is_set():
            return 128 + int(err.sigval)
        print(f"the ranks still ran after {seconds:g} s: stopped; each printed its stacks "
              "above", file=sys.stderr)
        return 1
    finally:
        timer.cancel()
        logs.cleanup()
        for s, h in handlers.items():
            signal.signal(s, h)


# -- the process ---------------------------------------------------------------


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


def closing_check(manifest: dict, name: str, trace: bool, metrics: dict, control) -> int:
    """What the run's process exits with once the window has closed: 3
    where it has loaded JAX or the JAX package, 4 where a reader that the
    manifest lists for the cell found nothing (not for the control), else 0."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    missing = missing_metrics(manifest, name, trace, {"metrics": metrics})
    if missing and not control:
        print(f"no reading of {', '.join(missing)}, which BENCHMARK.json lists for "
              f"{name}", file=sys.stderr)
        return 4
    return 0


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
    """Run one cell on the card(s); ``solver_for(cfg)`` gives a solver to
    put in the program's place (the control).  A cell of more than one card
    starts the script that was run once per card (:func:`launch`); each of
    those processes runs its rank (:func:`rank_main`)."""
    args = parse_args(argv)
    import torch

    # the system under test: where it is missing there is nothing to measure
    importlib.import_module(PORT)
    wl, cfg = load_cell(args.workload)
    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    pin_caches()
    torch.set_num_threads(1)
    if chips > 1:
        manifest = load_json(ROOT / "BENCHMARK.json")
        if "RANK" in os.environ:
            return rank_main(args, manifest, solver_for)
        try:
            rank_rows(cfg, chips, 0)
            port_attr(wl["traffic"]["layout"])
            port_attr(wl["traffic"].get("call", "solve"))
        except (ValueError, LookupError) as err:
            print(f"{args.workload}: {err}", file=sys.stderr)
            return 2
        return launch(os.path.abspath(sys.argv[0]), sys.argv[1:] if argv is None else argv,
                      chips)
    solver = solver_for(cfg) if solver_for else None
    manifest = load_json(ROOT / "BENCHMARK.json")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), manifest, solver=solver, started=_STARTED)
    code = closing_check(manifest, args.workload, bool(args.trace), out["metrics"], solver_for)
    if code == 0:
        report(out)
    return code


if __name__ == "__main__":
    sys.exit(main())
