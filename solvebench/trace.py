"""Spans around the program's layers, and the device trace read against them.

A span is a ``torch.profiler.record_function`` range named
``solvebench.<kind>`` that the benchmark wraps around a call of the
program, with the host time and the calls counted beside it.  Which calls
are wrapped is data: each file ``spans/<name>.json`` names one target,
``"module:attribute"`` or ``"module:Class.attribute"``, and the kind of span
it opens (``spmv``, ``precond_apply``, ``precond_build``).  The wrappers
are installed for the traced window only.

:func:`from_profiler` reduces a profiler's events to plain records: the
device operations with the host time of their launch, the spans, and the
host operations.  A device operation belongs to the spans that hold its
launch.  The readers under ``metrics/`` compute from these records alone,
so the tests feed them synthetic ones.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "solvebench."
_DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_ACTIVITIES = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int   # ns
    end: int     # ns
    launch: Optional[int]  # host ns of its launch, None when not linked


@dataclasses.dataclass
class Trace:
    device_ops: List[DeviceOp]
    spans: Dict[str, List[Tuple[int, int]]]  # kind -> [(start, end)] in ns
    host_ops: List[Tuple[int, int, str]]     # (start, end, name)

    def window(self) -> Optional[Tuple[int, int]]:
        """From the first solve span's start to the last one's end."""
        solves = self.spans.get("solve")
        if not solves:
            return None
        return min(s for s, _ in solves), max(e for _, e in solves)

    def device_seconds(self, kind: str) -> float:
        """Seconds of the device operations launched inside spans of ``kind``."""
        return sum(op.end - op.start for op in self.device_ops if _inside(
            self.spans.get(kind, ()), op.launch)) * 1e-9

    def linked(self) -> bool:
        return any(op.launch is not None for op in self.device_ops)

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of device operations clipped to the window, merged."""
        win = self.window()
        if win is None:
            return []
        cut = sorted((max(op.start, win[0]), min(op.end, win[1])) for op in self.device_ops
                     if op.end > win[0] and op.start < win[1])
        merged: List[List[int]] = []
        for s, e in cut:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_seconds(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def window_seconds(self) -> float:
        win = self.window()
        return 0.0 if win is None else (win[1] - win[0]) * 1e-9

    def top_device_ops(self, limit: int = 10) -> List[list]:
        total: Dict[str, int] = {}
        for op in self.device_ops:
            total[op.name] = total.get(op.name, 0) + (op.end - op.start)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:limit]
        return [[name, ns * 1e-9] for name, ns in ranked]

    def idle_gaps(self, limit: int = 10) -> List[list]:
        """The device's idle time in the window, summed by the innermost host
        operation under way at each gap's midpoint (``host`` where none is)."""
        win = self.window()
        if win is None:
            return []
        busy = self.busy_intervals()
        edges = [win[0]] + [t for iv in busy for t in iv] + [win[1]]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        ops = sorted(self.host_ops)
        total: Dict[str, int] = {}
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (s + e) // 2
            while j < len(ops) and ops[j][0] <= mid:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "host"
            total[name] = total.get(name, 0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:limit]
        return [[name, ns * 1e-9] for name, ns in ranked]


def _inside(spans, t) -> bool:
    """Whether host time ``t`` lies in one of ``spans`` (sorted, disjoint)."""
    if t is None or not spans:
        return False
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def from_profiler(prof) -> Trace:
    """The records of a finished ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    runtime_at: Dict[int, int] = {}
    op_at: Dict[int, int] = {}
    device, spans, host = [], {}, []
    for ev in events:
        kind = _activity(ev)
        name = ev.name()
        if kind in _DEVICE_ACTIVITIES:
            device.append(ev)
            continue
        if kind in _RUNTIME_ACTIVITIES:
            runtime_at[ev.correlation_id()] = ev.start_ns()
        elif kind in ("cpu_op", "user_annotation"):
            op_at[ev.correlation_id()] = ev.start_ns()
            if kind == "user_annotation" and name.startswith(SPAN_PREFIX):
                spans.setdefault(name[len(SPAN_PREFIX):], []).append(
                    (ev.start_ns(), ev.end_ns()))
        else:
            continue
        host.append((ev.start_ns(), ev.end_ns(), name))
    ops = []
    for ev in device:
        launch = runtime_at.get(ev.correlation_id())
        if launch is None:
            launch = op_at.get(ev.linked_correlation_id())
        ops.append(DeviceOp(ev.name(), ev.start_ns(), ev.end_ns(), launch))
    return Trace(ops, {k: sorted(v) for k, v in spans.items()}, host)


def _activity(ev) -> str:
    """The event's kind, as kineto's activity types name them: torch's
    events carry no accessor for it, so device events are device operations
    unless they are annotations, and host events are annotations, CUDA
    runtime or driver calls (by name), or operators."""
    name = ev.name()
    if str(ev.device_type()).endswith("CUDA"):
        if ev.is_user_annotation() or name.startswith(SPAN_PREFIX):
            return "gpu_user_annotation"
        return "kernel"
    if ev.is_user_annotation():
        return "user_annotation"
    if name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper()):
        return "cuda_runtime"
    return "cpu_op"


@dataclasses.dataclass
class SpanCounts:
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def span_targets(bench_dir: Path) -> List[dict]:
    """Every ``spans/*.json``, in name order."""
    return [json.loads(p.read_text()) for p in sorted((bench_dir / "spans").glob("*.json"))]


def _resolve(target: str):
    module_name, _, path = target.partition(":")
    owner = importlib.import_module(module_name)
    *outer, attr = path.split(".")
    for part in outer:
        owner = getattr(owner, part)
    return owner, attr


@contextlib.contextmanager
def span(kind: str, counts: SpanCounts):
    """Open a ``solvebench.<kind>`` range for the block and count it."""
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(SPAN_PREFIX + kind):
        yield
    counts.calls[kind] = counts.calls.get(kind, 0) + 1
    counts.host_s[kind] = counts.host_s.get(kind, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def wrapped(targets: List[dict], counts: SpanCounts):
    """Wrap each target in its span for the duration of the block.  A
    target that does not resolve raises LookupError: the program has moved
    the call, and the metrics its span reads would read something else."""
    saved = []
    try:
        for t in targets:
            try:
                owner, attr = _resolve(t["target"])
                raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            except (ImportError, AttributeError, KeyError) as err:
                raise LookupError(f"span target {t['target']} does not resolve: {err!r}") \
                    from err
            saved.append((owner, attr, raw))
            setattr(owner, attr, _wrap(raw, t["span"], counts))
        yield
    finally:
        for owner, attr, raw in reversed(saved):
            setattr(owner, attr, raw)


def _wrap(raw, kind: str, counts: SpanCounts):
    fn = raw.__func__ if isinstance(raw, (classmethod, staticmethod)) else raw

    def inner(*args, **kwargs):
        with span(kind, counts):
            return fn(*args, **kwargs)

    if isinstance(raw, classmethod):
        return classmethod(inner)
    if isinstance(raw, staticmethod):
        return staticmethod(inner)
    return inner
