"""Device microseconds per iteration of the operations launched inside the
``spmv`` spans (every operator product of the solve).  Nothing where the
spans opened fewer times than the solves iterated: the product then runs
outside the call the span wraps, and its time would count elsewhere."""


def read(run):
    us, its = run.device_us("spmv"), run.iterations()
    if not us or not its or run.span_calls("spmv") < its:
        return None
    return us / its
