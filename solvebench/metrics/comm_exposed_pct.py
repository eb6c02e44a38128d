"""Share of the traced window in which the device ran communication and
nothing else: the union of the operations launched inside the program's
``smm.halo`` and ``smm.allreduce`` spans, less its overlap with the union
of every other operation, both clipped to the window, over the window.
Nothing where the program opens no such spans or the trace links
nothing."""

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    comm_spans = ps.merge(ps.spans(tr, "halo") + ps.spans(tr, "allreduce"))
    if not comm_spans or not tr.linked():
        return None
    win = tr.window()
    if win is None or win[1] <= win[0]:
        return None
    comm, rest = [], []
    for op in tr.device_ops:
        if op.end <= win[0] or op.start >= win[1]:
            continue
        clipped = (max(op.start, win[0]), min(op.end, win[1]))
        (comm if ps.inside(comm_spans, op.launch) else rest).append(clipped)
    comm, rest = ps.merge(comm), ps.merge(rest)
    exposed = sum(e - s for s, e in comm) - ps.overlap(comm, rest)
    return 100.0 * exposed / (win[1] - win[0])
