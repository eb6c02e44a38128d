"""The program's own spans read from a traced run's records.

While a ``torch.profiler`` records, the port opens ``record_function``
ranges named ``smm.<name>`` inside its solve path (``solve``,
``precond_build``, ``iteration``, ``spmv``, ``precond_apply``, ``verify``,
``host_sync``; ``sparse_matrix_math_tpu_torch/utils/profiling.py``).
:func:`trace.from_profiler` keeps every such range among ``Trace.host_ops``
as ``(start, end, name)``, and links each device operation to the host time
of its launch, so these helpers need nothing beyond the records.  A program
that opens no such span gives them empty lists, and the readers built on
them then return None.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

# for the readers: whether a time lies in sorted, disjoint intervals
from solvebench.trace import _inside as inside  # noqa: F401

PREFIX = "smm."

Interval = Tuple[int, int]


def spans(trace, name: str) -> List[Interval]:
    """The ``smm.<name>`` ranges that start inside the window, sorted."""
    win = trace.window() if trace is not None else None
    if win is None:
        return []
    full = PREFIX + name
    return sorted((s, e) for s, e, n in trace.host_ops if n == full and win[0] <= s <= win[1])


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``intervals``, as sorted disjoint intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(trace) -> List[Interval]:
    """The window less the union of the device operations."""
    win = trace.window()
    if win is None:
        return []
    edges = [win[0]] + [t for iv in trace.busy_intervals() for t in iv] + [win[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
