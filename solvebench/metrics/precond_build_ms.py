"""Host milliseconds per solve inside the preconditioner build that
``solve()`` runs (``PaddedSGS.from_dia`` for ``"sgs"`` on DIA): the
``precond_build`` span's host time over the traced solves.  Nothing where
the span opened fewer times than there were solves."""


def read(run):
    calls = run.span_calls("precond_build")
    if not run.solves or calls < len(run.solves):
        return None
    return 1e3 * run.spans.host_s["precond_build"] / len(run.solves)
