"""The distributed shard's SGS apply's share of its roofline: the least time
of a truncated SGS apply of the cell's sweeps over the rank's share of the
rows (roofline.py: its own rows, so the halo rows swept again count against
the kernel), against the device time per ``smm.precond_apply`` span of the
program, the operations launched inside its nested ``smm.halo`` spans left
out.  Nothing where the program opens no such spans or the trace links
nothing."""

from solvebench import program_spans as ps
from solvebench import roofline


def read(run):
    tr = run.trace
    applies = ps.spans(tr, "precond_apply")
    sweeps = run.traffic["solve"].get("preconditioner_options", {}).get("sweeps")
    if not applies or not sweeps or not tr.linked():
        return None
    inside, halo = ps.merge(applies), ps.merge(ps.spans(tr, "halo"))
    ns = sum(op.end - op.start for op in tr.device_ops
             if ps.inside(inside, op.launch) and not ps.inside(halo, op.launch))
    if not ns:
        return None
    least = roofline.least_seconds(run.cfg, roofline.sgs_flops(run.cfg, sweeps), run.share)
    return 100.0 * least / (1e-9 * ns / len(applies))
