"""Device microseconds per iteration of the operations launched inside the
``precond_apply`` spans (every preconditioner apply of the solve).  Nothing
where the spans opened fewer times than the solves iterated: the apply then
runs outside the call the span wraps."""


def read(run):
    us, its = run.device_us("precond_apply"), run.iterations()
    if not us or not its or run.span_calls("precond_apply") < its:
        return None
    return us / its
