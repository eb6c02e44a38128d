"""Device microseconds per executed iteration of the distributed solve's
halo exchanges: the operations launched inside the program's ``smm.halo``
spans (the NCCL sends and receives of ``parallel/mesh.py:open_halo_rows``),
over the ``smm.iteration`` spans, frozen iterations included.  Nothing
where the program opens no such spans or the trace links nothing."""

from solvebench import program_spans as ps


def read(run):
    tr = run.trace
    iters, halos = ps.spans(tr, "iteration"), ps.spans(tr, "halo")
    if not iters or not halos or not tr.linked():
        return None
    halo = ps.merge(halos)
    ns = sum(op.end - op.start for op in tr.device_ops if ps.inside(halo, op.launch))
    return 1e-3 * ns / len(iters)
