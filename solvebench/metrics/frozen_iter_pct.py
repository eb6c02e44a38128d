"""Share of the loop's executed iterations that ran after their solve had
converged: the chunked loop runs whole chunks of 32 iterations, and a
frozen iteration keeps its state by ``torch.where`` while every kernel of
it still runs.  100 x (``smm.iteration`` spans in the window - the solves'
``SolveResult.iterations``) / ``smm.iteration`` spans.  Nothing where the
program opens no iteration span."""

from solvebench import program_spans


def read(run):
    executed = len(program_spans.spans(run.trace, "iteration"))
    if not executed or not run.solves:
        return None
    return 100.0 * (executed - run.iterations()) / executed
