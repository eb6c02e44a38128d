"""Device microseconds per executed iteration of the distributed solve's
all-reduces: the operations launched inside the program's
``smm.allreduce`` spans (``parallel/mesh.py:all_reduce``, one a dot), over
the ``smm.iteration`` spans, frozen iterations included.  Nothing where the
program opens no such spans or the trace links nothing."""

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    iters, reduces = ps.spans(tr, "iteration"), ps.spans(tr, "allreduce")
    if not iters or not reduces or not tr.linked():
        return None
    inside = ps.merge(reduces)
    ns = sum(op.end - op.start for op in tr.device_ops if ps.inside(inside, op.launch))
    return 1e-3 * ns / len(iters)
