"""The port's own spans (``utils/profiling.py``): what a solve opens under
``torch.profiler``, and that nothing is opened, or changed, without one.

* ``smm.solve`` opens once per ``solve()`` call and holds every other span.
* ``smm.iteration`` opens once per executed iteration, frozen iterations
  included, as often as ``_loop.chunk_counts`` counts passes: at least the
  solve's ``iterations`` and at most one chunk more per round.
* ``smm.spmv`` on the padded and grid paths opens once per executed
  iteration, once for ``r0`` and twice per round (the restart residual and
  the verify); ``smm.verify`` once per round.
* ``smm.host_sync`` opens exactly as often as ``_loop.host_syncs`` grows.
* The answer, status and iteration count are bit for bit the same with and
  without a profiler, and without one ``record_function`` is never entered.
"""

import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.solvers import _loop
from sparse_matrix_math_tpu_torch.utils import profiling

NX = 10
SGS = dict(method="cg", preconditioner="sgs", preconditioner_options={"sweeps": 4})


def _system():
    csr = smm.poisson_3d(NX, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(19)
    b = torch.rand(csr.shape[0], dtype=torch.float64, generator=gen) + 0.5
    return csr, b


def _operator(kind, csr):
    if kind == "dia":
        op = smm.try_dia_from_csr(csr)
    elif kind == "grid":
        op = smm.best_format(csr)
        assert type(op).__name__ == "GridStencilMatrix"
    else:
        op = csr
    assert op is not None
    return op


# case -> (operator, solve() keywords)
CASES = {
    "padded_pcg_sgs": ("dia", SGS),
    "grid_cg": ("grid", dict(method="cg")),
    "padded_bicgstab": ("dia", dict(method="bicgstab")),
    "padded_cgs": ("dia", dict(method="cgs")),
    "padded_bicg_symmetric": ("dia", dict(method="bicg_symmetric")),
    "csr_gmres": ("csr", dict(method="gmres")),
}


def _traced(case):
    """Solve the case under a profiler: (result, {span: [(start, end)]},
    host syncs counted)."""
    kind, kw = CASES[case]
    csr, b = _system()
    op = _operator(kind, csr)
    eps = 1e-8 * float(torch.linalg.norm(b))
    before = _loop.host_syncs["count"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = smm.solve(op, b, epsilon=eps, **kw)
    syncs = _loop.host_syncs["count"] - before
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name.startswith(profiling.SPAN_PREFIX):
            spans.setdefault(name[len(profiling.SPAN_PREFIX):], []).append(
                (ev.start_ns(), ev.end_ns()))
    return res, spans, syncs


@pytest.mark.parametrize("case", list(CASES))
def test_one_solve_span_holds_every_other(case):
    res, spans, _ = _traced(case)
    assert int(res.status) == int(smm.SolverStatus.SUCCESS)
    assert len(spans["solve"]) == 1
    (s0, e0), = spans["solve"]
    for name, ranges in spans.items():
        for s, e in ranges:
            assert s0 <= s <= e <= e0, (name, s, e)


@pytest.mark.parametrize("case", [c for c in CASES if c != "csr_gmres"])
def test_iteration_spans_are_whole_chunks(case):
    """Each executed pass opens one ``smm.iteration`` and counts one pass in
    ``_loop.chunk_counts``; the chunks are sized from the residual's rate,
    so a round runs at most one chunk's frozen tail, and the reads are the
    whole-chunk loop's chunks plus at most ``SHORT_CHUNKS`` a round, and the
    fixed ones (the first residual, each round's first read and verify)."""
    counts0 = dict(_loop.chunk_counts)
    res, spans, syncs = _traced(case)
    counts = {key: _loop.chunk_counts[key] - counts0[key] for key in counts0}
    executed, rounds = len(spans["iteration"]), len(spans["verify"])
    assert int(res.status) == int(smm.SolverStatus.SUCCESS)
    assert rounds >= 1
    assert executed == counts["passes"]
    assert res.iterations <= executed <= res.iterations + _loop.CHUNK * rounds
    whole = -(-res.iterations // _loop.CHUNK) + rounds - 1
    fixed = 1 + 2 * rounds
    assert syncs == counts["chunks"] + fixed
    assert counts["chunks"] <= whole + _loop.SHORT_CHUNKS * rounds


@pytest.mark.parametrize("case", ["padded_pcg_sgs", "grid_cg"])
def test_products_are_iterations_plus_r0_plus_two_per_round(case):
    res, spans, _ = _traced(case)
    executed, rounds = len(spans["iteration"]), len(spans["verify"])
    assert len(spans["spmv"]) == executed + 1 + 2 * rounds
    if CASES[case][1].get("preconditioner"):
        # one apply per executed iteration and one to start each round
        assert len(spans["precond_apply"]) == executed + rounds
        assert len(spans["precond_build"]) == 1
    else:
        assert "precond_apply" not in spans and "precond_build" not in spans


@pytest.mark.parametrize("case", list(CASES))
def test_host_sync_spans_match_the_counter(case):
    _, spans, syncs = _traced(case)
    assert syncs > 0
    assert len(spans["host_sync"]) == syncs


@pytest.mark.parametrize("case", list(CASES))
def test_a_profiler_changes_nothing_in_the_result(case):
    kind, kw = CASES[case]
    csr, b = _system()
    op = _operator(kind, csr)
    eps = 1e-8 * float(torch.linalg.norm(b))
    plain = smm.solve(op, b, epsilon=eps, **kw)
    traced, _, _ = _traced(case)
    assert torch.equal(plain.x, traced.x)
    assert int(plain.status) == int(traced.status)
    assert int(plain.iterations) == int(traced.iterations)


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    csr, b = _system()
    dia, grid = _operator("dia", csr), _operator("grid", csr)
    eps = 1e-8 * float(torch.linalg.norm(b))
    smm.solve(dia, b, epsilon=eps, **SGS)
    smm.solve(grid, b, epsilon=eps, method="cg")
    assert entered == []
    assert profiling.span("solve") is profiling.span("iteration")
    assert isinstance(_loop.chunk(), range)
    # the same calls under a profiler do enter the patched class
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        smm.solve(dia, b, epsilon=eps, **SGS)
    assert "smm.solve" in entered and "smm.iteration" in entered


def test_spanned_passes_calls_and_none_through():
    assert profiling.spanned("spmv", None) is None
    f = profiling.spanned("spmv", lambda v, k=1: v * k)
    assert f(3, k=2) == 6
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        f(2)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert names.count("smm.spmv") == 1
