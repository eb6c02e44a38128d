"""The Krylov cores' chunk schedule (``solvers/_loop.py``).

* ``next_length`` is a pure function of the last chunk's length, the
  convergence scalar before and after it and the target: a geometric
  decrease predicts the exact remainder; a rise, a flat value, NaN, inf or a
  zero gives a whole chunk; a remainder of zero or less gives 1.
* ``passes`` issues a whole first chunk, then ``next_length``'s, and after
  ``SHORT_CHUNKS`` short ones whole chunks to the round's end; no chunk runs
  past the most passes the round allows.
* The schedule moves only where frozen iterations fall: every adopting core
  returns the same x, iterations, status, residual trace, residual norm and
  ``floor_hit``, bit for bit, as with whole chunks only.
"""

import math

import numpy as np
import pytest
import torch
import torch_port_threads  # noqa: F401  (one intra-op thread per test process)

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.solvers import _loop

CHUNK = _loop.CHUNK


@pytest.mark.parametrize("length,remaining", [(32, 1), (32, 7), (32, 31), (5, 3), (1, 12)])
def test_geometric_decrease_predicts_the_remainder(length, remaining):
    rate = 0.8
    before, after = 1.0, rate ** length
    # the target lies half a step inside the remaining-th pass from here
    target = after * rate ** (remaining - 0.5)
    assert _loop.next_length(length, before, after, target) == remaining


def test_a_long_remainder_is_one_whole_chunk():
    assert _loop.next_length(32, 1.0, 0.5, 1e-30) == CHUNK


@pytest.mark.parametrize("before,after,target", [
    (1.0, 2.0, 1e-3),            # a rise
    (1.0, 1.0, 1e-3),            # flat
    (1.0, math.nextafter(1.0, 0), 1e-3),  # a fall too small to measure
    (math.nan, 0.5, 1e-3), (1.0, math.nan, 1e-3), (1.0, 0.5, math.nan),
    (math.inf, 0.5, 1e-3), (1.0, math.inf, 1e-3), (1.0, 0.5, math.inf),
    (1.0, 0.0, 1e-3),            # converged exactly
    (1.0, 0.5, 0.0),             # a target that is never met
])
def test_no_measurable_fall_gives_a_whole_chunk(before, after, target):
    assert _loop.next_length(32, before, after, target) == CHUNK


@pytest.mark.parametrize("after,target", [(0.5, 0.5), (0.5, 0.6), (1e-20, 1.0)])
def test_a_remainder_of_zero_or_less_gives_one(after, target):
    assert _loop.next_length(32, 1.0, after, target) == 1


def _lengths(values, target, most=math.inf):
    """The chunk lengths ``passes`` issues when its reads see ``values`` in
    turn (the loop runs while values are left), and the counts it adds."""
    seen = iter(values)
    lengths = []

    def probe():
        lengths.append(0)
        value = next(seen, None)
        return (torch.tensor(value is not None),
                torch.tensor(0.0 if value is None else value, dtype=torch.float64))

    counts0 = dict(_loop.chunk_counts)
    for _ in _loop.passes(probe, target, most):
        lengths[-1] += 1
    return lengths[:-1], {key: _loop.chunk_counts[key] - counts0[key] for key in counts0}


def test_passes_sizes_each_chunk_from_the_last():
    rate = 0.5
    lengths, counts = _lengths([1.0, rate ** 32, rate ** 40], target=rate ** 41.5)
    assert lengths == [32, 10, 2]
    assert counts == {"chunks": 3, "short": 2, "passes": 44}


def test_a_rise_after_a_short_chunk_gives_a_whole_chunk():
    lengths, _ = _lengths([1.0, 1e-3, 1e-2], target=1e-4)
    assert lengths == [32, 11, 32]


def test_no_chunk_runs_past_the_round():
    """A round that can run 40 iterations (BiCGStab's, or the cap) ends its
    chunks there, however long the prediction."""
    lengths, counts = _lengths([1.0, 0.9], target=1e-9, most=40)
    assert lengths == [32, 8]
    assert counts == {"chunks": 2, "short": 1, "passes": 40}
    lengths, _ = _lengths([1.0], target=1e-9, most=10)
    assert lengths == [10]


def test_passes_goes_back_to_whole_chunks_after_the_short_limit():
    # the scalar creeps down towards the target, so every prediction is 1
    target = 1e-6
    values = [1.0] + [target * (1 + 10.0 ** -e) for e in range(3, 9)]
    lengths, counts = _lengths(values, target)
    limit = _loop.SHORT_CHUNKS
    assert lengths == [CHUNK] + [1] * limit + [CHUNK] * (len(values) - 1 - limit)
    assert counts == {"chunks": len(values), "short": limit, "passes": sum(lengths)}


CORES = ["cg", "pcg", "cgs", "bicg_symmetric", "bicgstab"]


def _solve(name, matrix, b, **kw):
    if name == "pcg":
        return smm.cg(matrix, b, preconditioner=smm.IdentityPreconditioner(), **kw)
    return getattr(smm, name)(matrix, b, **kw)


@pytest.mark.parametrize("name", CORES)
def test_schedule_leaves_the_result_bit_for_bit(name, monkeypatch):
    """The adaptive schedule against whole chunks only, on a system whose
    solve runs short chunks: everything the result carries is the same."""
    a = smm.poisson_2d(12, dtype=torch.float64, device="cpu").to_dense()
    b = torch.as_tensor(np.random.default_rng(21).standard_normal(144))
    kw = dict(epsilon=1e-10, max_iterations=400, record_residuals=True)
    counts0 = dict(_loop.chunk_counts)
    adaptive = _solve(name, a, b, **kw)
    short = _loop.chunk_counts["short"] - counts0["short"]
    passes = _loop.chunk_counts["passes"] - counts0["passes"]
    monkeypatch.setattr(_loop, "next_length", lambda *args: CHUNK)
    counts0 = dict(_loop.chunk_counts)
    whole = _solve(name, a, b, **kw)
    assert _loop.chunk_counts["short"] == counts0["short"]
    assert short > 0 and passes < _loop.chunk_counts["passes"] - counts0["passes"]
    assert adaptive.status == whole.status == int(smm.SolverStatus.SUCCESS)
    assert adaptive.iterations == whole.iterations
    assert adaptive.floor_hit == whole.floor_hit
    for got, want in ((adaptive.x, whole.x), (adaptive.residual_trace, whole.residual_trace),
                      (adaptive.residual_norm, whole.residual_norm)):
        assert np.array_equal(got.numpy().view(np.int64), want.numpy().view(np.int64))
