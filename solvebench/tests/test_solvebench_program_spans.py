"""The readers of the program's own spans (``smm.<name>``) on synthetic trace
records: known values, nothing where the program opens no span, clipping
to the window, and idle time counted by its overlap with a readback."""

import pytest

from solvebench import program_spans as ps
from solvebench import run
from solvebench import trace as tracing

NEW = ("frozen_iter_pct", "loop_vector_us_per_iter", "prep_ms", "sync_idle_pct")


def _run(solves, trace):
    r = run.Run({"operator": "stencil", "grid": [4, 4, 4], "dtype": "float32"},
                {"traffic": {"solve": {}}})
    r.solves = [run.Solve(1e-3, 0, k) for k in solves]
    r.trace = trace
    return r


def _iterations(n, start=1000, step=100):
    return [(start + i * step, start + i * step + 90, "smm.iteration") for i in range(n)]


def test_frozen_share_of_whole_chunks():
    # 6 chunks of 32 executed for 172 counted iterations
    host = [(0, 10 ** 6, "solvebench.solve"), (10, 10 ** 6 - 10, "smm.solve")]
    host += _iterations(192)
    tr = tracing.Trace([], {"solve": [(0, 10 ** 6)]}, host)
    assert run.read_metric("frozen_iter_pct", _run([172], tr)) == pytest.approx(
        100 * 20 / 192)
    assert run.read_metric("frozen_iter_pct", _run([172], tr)) == pytest.approx(10.4167,
                                                                               abs=1e-4)
    # two solves of one round each: 160 executed for 137, twice
    tr2 = tracing.Trace([], {"solve": [(0, 10 ** 6)]}, _iterations(320))
    assert run.read_metric("frozen_iter_pct", _run([137, 137], tr2)) == pytest.approx(14.375)


def _trace():
    """One solve in the window [0, 10000] ns: the build, two iterations
    (the second holding a product and an apply, an spmv nested inside the
    apply), a verify with its readback, and device work launched in each."""
    spans = {"solve": [(0, 10000)]}
    host = [(0, 10000, "solvebench.solve"),
            (100, 9900, "smm.solve"),
            (200, 600, "smm.precond_build"),
            (1000, 3000, "smm.iteration"),
            (3000, 6000, "smm.iteration"),
            (3100, 3300, "smm.spmv"),
            (3400, 3900, "smm.precond_apply"),
            (3500, 3600, "smm.spmv"),  # inside the apply: subtracted once
            (7000, 9000, "smm.verify"),
            (8000, 9000, "smm.host_sync")]
    ops = [tracing.DeviceOp("pad", 700, 900, 650),          # before the loop
           tracing.DeviceOp("axpy", 1500, 1800, 1100),      # iteration 1
           tracing.DeviceOp("dot", 1800, 1900, 1200),       # iteration 1
           tracing.DeviceOp("k3", 3200, 3500, 3150),        # in spmv
           tracing.DeviceOp("sweep", 3600, 4000, 3450),     # in the apply
           tracing.DeviceOp("inner", 4000, 4100, 3550),     # in the nested spmv
           tracing.DeviceOp("where", 4100, 4400, 5000),     # iteration 2, outside
           tracing.DeviceOp("verify", 7100, 8500, 7050),
           tracing.DeviceOp("copy", 8700, 8800, 8100)]
    return tracing.Trace(ops, spans, host)


def test_loop_vector_time_per_executed_iteration():
    # axpy 300 + dot 100 + where 300 over 2 iteration spans, in us
    r = _run([1], _trace())
    assert run.read_metric("loop_vector_us_per_iter", r) == pytest.approx(700e-3 / 2)


def test_prep_from_solve_start_to_the_first_loop_operation():
    # smm.solve opens at 100; the first iteration's first operation starts at 1500
    r = _run([1], _trace())
    assert run.read_metric("prep_ms", r) == pytest.approx(1400e-6)


def test_prep_averages_over_solves():
    tr = _trace()
    shift = 10000
    spans = {"solve": [(0, 10000), (shift, shift + 10000)]}
    host = tr.host_ops + [(s + shift, e + shift, n) for s, e, n in tr.host_ops]
    ops = tr.device_ops + [tracing.DeviceOp(op.name, op.start + shift + 500,
                                            op.end + shift + 500, op.launch + shift)
                           for op in tr.device_ops]
    r = _run([1, 1], tracing.Trace(ops, spans, host))
    # 1400 ns in the first solve, 1900 ns in the second (its device 500 ns late)
    assert run.read_metric("prep_ms", r) == pytest.approx(1650e-6)


def test_idle_counted_by_its_overlap_with_a_readback():
    # busy [700, 900] [1500, 1900] [3200, 4400] [7100, 8500] [8700, 8800]:
    # idle inside the host_sync span [8000, 9000] is [8500, 8700] and [8800, 9000]
    r = _run([1], _trace())
    assert run.read_metric("sync_idle_pct", r) == pytest.approx(100 * 400 / 10000)
    # a gap half inside the span: only its inside half counts
    tr = tracing.Trace([tracing.DeviceOp("a", 0, 1000, 0), tracing.DeviceOp("b", 3000,
                                                                            10000, 2900)],
                       {"solve": [(0, 10000)]},
                       [(0, 10000, "solvebench.solve"), (2000, 2500, "smm.host_sync")])
    assert run.read_metric("sync_idle_pct", _run([1], tr)) == pytest.approx(100 * 500 / 10000)


def test_spans_are_clipped_to_the_window():
    host = [(0, 1000, "solvebench.solve"), (-500, -100, "smm.iteration"),
            (100, 200, "smm.iteration"), (1500, 1600, "smm.iteration"),
            (900, 1400, "smm.host_sync")]
    tr = tracing.Trace([tracing.DeviceOp("a", 0, 100, 0)], {"solve": [(0, 1000)]}, host)
    assert ps.spans(tr, "iteration") == [(100, 200)]
    assert run.read_metric("frozen_iter_pct", _run([0], tr)) == pytest.approx(100.0)
    # the readback runs past the window's end: only [900, 1000] counts
    assert run.read_metric("sync_idle_pct", _run([0], tr)) == pytest.approx(100 * 100 / 1000)


def test_nothing_where_the_program_opens_no_span():
    tr = _trace()
    bare = tracing.Trace(tr.device_ops, tr.spans,
                         [h for h in tr.host_ops if not h[2].startswith("smm.")])
    for trace in (None, bare):
        r = _run([1], trace)
        for name in NEW:
            assert run.read_metric(name, r) is None, name


def test_nothing_from_an_unlinked_trace():
    import dataclasses

    tr = _trace()
    unlinked = tracing.Trace([dataclasses.replace(op, launch=None) for op in tr.device_ops],
                             tr.spans, tr.host_ops)
    r = _run([1], unlinked)
    assert run.read_metric("loop_vector_us_per_iter", r) is None
    assert run.read_metric("prep_ms", r) is None
    assert run.read_metric("frozen_iter_pct", r) == pytest.approx(50.0)


def test_interval_helpers():
    assert ps.merge([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    assert ps.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert ps.inside([(1, 4), (5, 8)], 6) and not ps.inside([(1, 4), (5, 8)], 4.5)
    assert not ps.inside([(1, 4)], None)
