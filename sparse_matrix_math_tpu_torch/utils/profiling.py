"""Observability: timers, SpMV throughput, solver statistics, profiler hooks.

Port of ``sparse_matrix_math_tpu/utils/profiling.py``.  The reference has no
tracing, metrics, or instrumentation (SURVEY §5); this module adds them on
top of the richer SolveResult:

* :func:`benchmark_op` — wall-clock an op with device synchronisation,
  seconds per op.
* :func:`spmv_throughput` — nnz/s for any matrix format's rmult.
* :func:`solve_with_stats` — run a solver and return a :class:`SolveStats`
  (time to solution, iterations, nnz/s, residual trace).
* :func:`trace` — context manager around ``torch.profiler`` writing a
  Chrome trace into a directory.
* :func:`span` — the program's own ranges, ``smm.<name>``, open only while
  a ``torch.profiler`` records.

Spans.  The solve path opens these ``record_function`` ranges, in the same
timeline as the device operations, so :func:`trace`'s Chrome trace carries
them and each device operation or idle gap falls under the span open at
its launch.  They nest by time under ``smm.solve``:

* ``smm.solve`` — one :func:`~..solvers.api.solve` call, whole, or one
  ``parallel.dist_padded_solve``;
* ``smm.precond_build`` — a preconditioner built for a solve
  (``api._build_preconditioner_for``), a factor re-laid into the padded
  layout (``_padded.padded_preconditioner``), or a distributed padded SGS
  window laid out (``parallel/dist_padded.py``);
* ``smm.iteration`` — one pass of a chunk loop (``_loop.passes``,
  ``_loop.chunk``): every executed iteration, frozen ones (after
  convergence, to the chunk's end) included;
* ``smm.spmv`` — one operator product of the padded (DIA) or grid-stencil
  solve path, or of the distributed padded DIA path;
* ``smm.precond_apply`` — one preconditioner apply of those paths;
* ``smm.verify`` — one outer round's true-residual check;
* ``smm.host_sync`` — one counted host readback (``_loop.read``,
  ``_loop.running``, ``_loop.to_host``), the events
  ``_loop.host_syncs`` counts;
* ``smm.halo`` — one non-wrapping halo exchange
  (``parallel/mesh.py:open_halo_rows``, which ``open_halo_exchange`` calls),
  from its post to its wait, inside the product, apply or build that needs
  it;
* ``smm.allreduce`` — one ``parallel/mesh.py:all_reduce``: each dot of a
  distributed solve.

With no profiler recording, :func:`span` is one flag check and a shared
no-op context: no environment variable or option turns spans on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["benchmark_op", "spmv_throughput", "SolveStats", "solve_with_stats", "trace",
           "span", "spanned", "recording", "SPAN_PREFIX"]

SPAN_PREFIX = "smm."
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """The range ``smm.<name>`` while a profiler records, else a shared
    no-op context (see the module docstring for the names)."""
    if recording():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF


def spanned(name: str, fn: Optional[Callable]) -> Optional[Callable]:
    """``fn`` with each call inside :func:`span` ``(name)``; None for None."""
    if fn is None:
        return None

    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return call


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, (list, tuple)):
        for leaf in out:
            t = _first_tensor(leaf)
            if t is not None:
                return t
    return None


def _sync(out):
    """Wait until the work that produced ``out`` has finished:
    ``torch.cuda.synchronize`` on the device of its first tensor, nothing on
    the CPU, where the ops have finished when they return.  Replaces the
    JAX package's ``block_until_ready`` plus one-element host readback
    (``utils/profiling.py:31-41``), a workaround for a TPU runtime whose
    ``block_until_ready`` returned early; a CUDA synchronize waits for every
    queued kernel on the device."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return out


def benchmark_op(
    fn: Callable,
    *args,
    iters: int = 20,
    warmup: int = 2,
) -> float:
    """Median-free simple timing: seconds per op of ``fn(*args)`` with
    device synchronisation before/after the timed loop."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def spmv_throughput(a, x: Optional[torch.Tensor] = None, *, iters: int = 20) -> dict:
    """SpMV throughput for any registered format: GNNZ/s and GFLOP/s
    (2 flops per stored entry — the reference's FMA count, h:1478-1491).
    ``x`` defaults to ones on ``a``'s device in ``a``'s dtype."""
    from ..ops.spmv import rmult

    if x is None:
        x = torch.ones(a.shape[1], dtype=a.dtype, device=a.device)
    sec = benchmark_op(rmult, a, x, iters=iters)
    return {
        "seconds_per_op": sec,
        "gnnz_per_s": a.nnz / sec / 1e9,
        "gflop_per_s": 2 * a.nnz / sec / 1e9,
    }


@dataclasses.dataclass(frozen=True)
class SolveStats:
    """Timing + convergence statistics for one solve."""

    status: int
    iterations: int
    residual_norm: float
    wall_seconds: float
    seconds_per_iteration: float
    spmv_gnnz_per_s: Optional[float]  # nnz/s through the solver's SpMVs
    residual_trace: Optional[np.ndarray]

    def __repr__(self) -> str:
        return (
            f"SolveStats(status={self.status}, iters={self.iterations}, "
            f"residual={self.residual_norm:.3e}, wall={self.wall_seconds:.4f}s, "
            f"s/iter={self.seconds_per_iteration:.6f})"
        )


# SpMVs per iteration for each solver family (CG/BiCGSym: 1; CGS/BiCGStab: 2
# — SURVEY §3.2/§3.3 call stacks).  Keys cover both the short aliases and
# the functions' __name__s (``cg`` is ``conjugate_gradient``, ``cgs`` is
# ``conjugate_gradient_squared``), so no solver_name is needed.
_SPMVS_PER_ITER = {
    "cg": 1,
    "conjugate_gradient": 1,
    "bicg_symmetric": 1,
    "cgs": 2,
    "conjugate_gradient_squared": 2,
    "bicgstab": 2,
}


def solve_with_stats(
    solver: Callable,
    a,
    b,
    *args,
    solver_name: Optional[str] = None,
    warm: bool = True,
    **kwargs,
) -> SolveStats:
    """Run ``solver(a, b, *args, **kwargs)`` and collect SolveStats.

    With ``warm=True`` the solve runs twice and the second run is timed:
    the first builds the kernels and fills the allocator, so the second
    gives steady-state numbers, the ones that matter for a resident solver
    loop.
    """
    if warm:
        _sync(solver(a, b, *args, **kwargs).x)
    t0 = time.perf_counter()
    res = solver(a, b, *args, **kwargs)
    _sync(res.x)
    wall = time.perf_counter() - t0

    iters = max(int(res.iterations), 1)
    name = solver_name or getattr(solver, "__name__", "")
    spmv_rate = None
    nnz = getattr(a, "nnz", None)
    if nnz is not None and name in _SPMVS_PER_ITER:
        spmv_rate = _SPMVS_PER_ITER[name] * iters * nnz / wall / 1e9
    trace_arr = (
        res.residual_trace.cpu().numpy() if res.residual_trace is not None else None
    )
    return SolveStats(
        status=int(res.status),
        iterations=int(res.iterations),
        residual_norm=float(res.residual_norm),
        wall_seconds=wall,
        seconds_per_iteration=wall / iters,
        spmv_gnnz_per_s=spmv_rate,
        residual_trace=trace_arr,
    )


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context (CPU activity, and CUDA activity when
    a card is present); on exit writes a Chrome trace,
    ``trace.<pid>.<ns>.json``, into ``log_dir`` — view it in Perfetto or
    ``chrome://tracing``.  Replaces the JAX package's ``jax.profiler`` XPlane
    directory (``utils/profiling.py:160-167``).  Yields the profiler, whose
    ``key_averages()`` summarises the window; the trace holds the program's
    ``smm.`` spans (module docstring)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
