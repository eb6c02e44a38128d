"""Host-driven loop plumbing shared by the solver cores.

torch has no ``lax.while_loop``.  The cores run their recurrence in chunks
of at most :data:`CHUNK` iterations with the loop condition kept as a
device tensor: an iteration whose condition is false is frozen (every state
tensor kept bit for bit by ``torch.where``, ``k`` not advanced), so the
iteration count and the state equal the JAX loop's exactly, whatever the
chunks' lengths, while the host reads the condition once per chunk.

The Krylov cores (CG/PCG, CGS, BiCG-symmetric, BiCGStab) run their rounds
through :func:`passes`, which sizes each chunk from the convergence
scalar's observed rate (:func:`next_length`), so a round's last chunk
ends near its convergence instead of a whole chunk's frozen tail later.
The other loops take whole chunks from :func:`chunk`.

Every host read goes through :func:`read`, :func:`running` or
:func:`to_host`, is counted in :data:`host_syncs` and, while a profiler
records, opens an ``smm.host_sync`` span; each executed pass opens an
``smm.iteration`` span (``utils/profiling.py``) and is counted in
:data:`chunk_counts`.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import recording, span

CHUNK = 32
# Chunks shorter than CHUNK that one round of passes() may issue; the rest
# of the round takes whole chunks, which bounds the reads a solve adds
# however its residual oscillates.
SHORT_CHUNKS = 4

# Host readbacks of device scalars since the last reset.
host_syncs = {"count": 0}
# Chunks run, those shorter than CHUNK, and executed passes (frozen ones
# included) since the last reset: passes minus iterations is the frozen count.
chunk_counts = {"chunks": 0, "short": 0, "passes": 0}


def read(*scalars: torch.Tensor) -> list:
    """Python values of 0-d device tensors, in one transfer."""
    host_syncs["count"] += 1
    with span("host_sync"):
        return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


def running(active: torch.Tensor) -> bool:
    host_syncs["count"] += 1
    with span("host_sync"):
        return bool(active)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host, in one transfer."""
    host_syncs["count"] += 1
    with span("host_sync"):
        return t.cpu()


def chunk():
    """The passes of one whole chunk: ``range(CHUNK)``, each pass inside an
    ``smm.iteration`` span while a profiler records."""
    return _counted(CHUNK)


def _counted(length: int):
    chunk_counts["chunks"] += 1
    chunk_counts["short"] += length < CHUNK
    chunk_counts["passes"] += length
    return _traced_chunk(length) if recording() else range(length)


def _traced_chunk(length: int):
    for i in range(length):
        with span("iteration"):
            yield i


def next_length(length: int, before: float, after: float, target: float) -> int:
    """The next chunk's length after a chunk of ``length`` passes took the
    convergence scalar from ``before`` to ``after``: the passes that the
    chunk's net rate of decrease needs to bring ``after`` down to
    ``target``, ``ceil(length * ln(after / target) / ln(before / after))``,
    at least 1 and at most :data:`CHUNK`.  A scalar that did not fall, or a
    value that is not finite and positive, gives a whole chunk."""
    if not (0 < after < before < math.inf and 0 < target < math.inf):
        return CHUNK
    rate = math.log(before / after)
    if rate <= 0:  # before / after rounded to 1
        return CHUNK
    need = length * math.log(after / target) / rate
    return max(1, math.ceil(need)) if need < CHUNK else CHUNK


def passes(probe, target: float, most: float = math.inf):
    """The passes of one round of a Krylov core's loop, chunk by chunk.

    Before each chunk one host read of ``probe()``, a pair of 0-d device
    tensors: the loop condition and the convergence scalar, whose value
    ``target`` (on the host) ends the round; a closure over the core's loop
    variables reads their values at each chunk's end.  The round ends when the
    condition reads false.  Its first chunk is :data:`CHUNK` long, each
    later one :func:`next_length` of the last, until :data:`SHORT_CHUNKS`
    short ones have run; whole chunks after that.  No chunk runs past
    ``most`` passes in the round, the iterations the round's condition
    allows at most (every pass before a read that finds the condition true
    was active).  The lengths depend only on values every rank of a
    distributed solve reads alike (the condition and an all-reduced
    scalar), so the ranks stay in step.
    """
    length, short, before, done = CHUNK, 0, None, 0
    while True:
        go, after = read(*probe())
        if not go:
            return
        if before is not None:
            length = next_length(length, before, after, target) if short < SHORT_CHUNKS else CHUNK
        length = min(length, most - done)
        short += length < CHUNK
        before = after
        done += length
        yield from _counted(length)


def new_trace(first: torch.Tensor, maxiter: int, record: bool):
    """The residual trace, NaN beyond the iterations run, or None."""
    if not record:
        return None
    trace = torch.full((maxiter + 1,), float("nan"), dtype=first.dtype,
                       device=first.device)
    trace[0] = first
    return trace


def record_step(trace, k: torch.Tensor, active: torch.Tensor, value: torch.Tensor,
                maxiter: int) -> None:
    """``trace[k + 1] = value`` where ``active``, without a host sync."""
    if trace is None:
        return
    idx = torch.clamp(k + 1, max=maxiter).reshape(1)
    trace.index_put_((idx,), torch.where(active, value, trace[idx]).reshape(1))
