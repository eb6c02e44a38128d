"""Mean ``SolveResult.iterations`` over the window's solves."""


def read(run):
    its = [s.iterations for s in run.solves]
    return sum(its) / len(its) if its else None
