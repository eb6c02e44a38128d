"""Share of the traced window in which the device sat idle while the host
was inside one of the program's counted readbacks (``smm.host_sync``:
``_loop.read``, ``_loop.running``, ``_loop.to_host``): the intersection of
the idle intervals, the window less the union of the device operations,
with the spans, over the window.  Nothing where the program opens no
readback span or the trace holds no device operation."""

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    syncs = ps.spans(tr, "host_sync")
    if not syncs or not tr.device_ops or not tr.window_seconds():
        return None
    win = tr.window()
    clipped = ps.merge((max(s, win[0]), min(e, win[1])) for s, e in syncs)
    idle = ps.overlap(ps.idle_intervals(tr), clipped)
    return 100.0 * idle / (win[1] - win[0])
