"""Device microseconds per iteration of the operations a solve launches
outside its product, preconditioner-apply and preconditioner-build spans:
the solve loop's elementwise operations, dots and copies."""


def read(run):
    total = run.device_us("solve")
    its = run.iterations()
    if not total or not its:
        return None
    rest = total - sum(run.device_us(k) or 0.0
                       for k in ("spmv", "precond_apply", "precond_build"))
    return rest / its
