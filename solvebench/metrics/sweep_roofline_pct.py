"""The preconditioner apply's share of its roofline: the least time of a
truncated SGS apply of the cell's sweeps (roofline.py), over the rank's
share of the rows, against the device time per apply.  Nothing where the
``precond_apply`` spans opened fewer times than the solves iterated."""

from solvebench import roofline


def read(run):
    us, calls = run.device_us("precond_apply"), run.span_calls("precond_apply")
    sweeps = run.traffic["solve"].get("preconditioner_options", {}).get("sweeps")
    if not us or not calls or calls < run.iterations() or not sweeps:
        return None
    least = roofline.least_seconds(run.cfg, roofline.sgs_flops(run.cfg, sweeps),
                                    run.share)
    return 100.0 * least / (1e-6 * us / calls)
