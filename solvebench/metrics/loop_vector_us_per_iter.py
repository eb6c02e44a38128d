"""Device microseconds per executed iteration of the loop's own work: the
operations launched inside ``smm.iteration`` spans and outside the
``smm.spmv`` and ``smm.precond_apply`` spans within them (the vector
updates, dots and ``torch.where`` freezes), over the ``smm.iteration``
spans, frozen iterations included.  Nothing where the program opens no
iteration span or the trace links no device operation to its launch."""

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    iters = ps.spans(tr, "iteration")
    if not iters or not tr.linked():
        return None
    loop = ps.merge(iters)
    kernels = ps.merge(ps.spans(tr, "spmv") + ps.spans(tr, "precond_apply"))
    ns = sum(op.end - op.start for op in tr.device_ops
             if ps.inside(loop, op.launch) and not ps.inside(kernels, op.launch))
    return 1e-3 * ns / len(iters)
