"""The distributed shard product's share of its roofline: the least time of
``y = A x`` over the rank's share of the rows (roofline.py), against the
device time per ``smm.spmv`` span of the program, the operations launched
inside its nested ``smm.halo`` spans (the exchange) left out.  Nothing
where the program opens no such spans or the trace links nothing."""

from solvebench import program_spans as ps
from solvebench import roofline


def read(run):
    tr = run.trace
    products = ps.spans(tr, "spmv")
    if not products or not tr.linked():
        return None
    inside, halo = ps.merge(products), ps.merge(ps.spans(tr, "halo"))
    ns = sum(op.end - op.start for op in tr.device_ops
             if ps.inside(inside, op.launch) and not ps.inside(halo, op.launch))
    if not ns:
        return None
    least = roofline.least_seconds(run.cfg, roofline.product_flops(run.cfg), run.share)
    return 100.0 * least / (1e-9 * ns / len(products))
