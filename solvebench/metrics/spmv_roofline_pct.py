"""The operator product's share of its roofline: the least time of
``y = A x`` (roofline.py), over the rank's share of the rows, against the
device time per product.  Nothing where the ``spmv`` spans opened fewer
times than the solves iterated."""

from solvebench import roofline


def read(run):
    us, calls = run.device_us("spmv"), run.span_calls("spmv")
    if not us or not calls or calls < run.iterations():
        return None
    least = roofline.least_seconds(run.cfg, roofline.product_flops(run.cfg), run.share)
    return 100.0 * least / (1e-6 * us / calls)
