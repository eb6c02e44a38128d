"""Milliseconds from a solve's start to the device's start on its loop:
from the ``smm.solve`` span's start to the start of the first device
operation launched inside that solve's first ``smm.iteration`` span,
averaged over the window's solves.  It holds the preconditioner build, the
padding of the operator and the vectors, the starting products and the
first apply, and whatever the host waited for before the loop.  Nothing
where the program opens no such spans or the trace links nothing."""

import bisect

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    solves, iters = ps.spans(tr, "solve"), ps.spans(tr, "iteration")
    if not solves or not iters or not tr.linked():
        return None
    starts = [s for s, _ in iters]
    launched = sorted((op.launch, op.start) for op in tr.device_ops if op.launch is not None)
    preps = []
    for s, e in solves:
        i = bisect.bisect_left(starts, s)
        if i == len(iters) or iters[i][0] > e:
            continue
        first = iters[i]
        begun = None
        for launch, start in launched[bisect.bisect_left(launched, (first[0], -1)):]:
            if launch > first[1]:
                break
            begun = start if begun is None else min(begun, start)
        if begun is not None:
            preps.append(begun - s)
    return 1e-6 * sum(preps) / len(preps) if preps else None
