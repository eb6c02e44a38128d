"""Host-driven loop plumbing shared by the solver cores.

torch has no ``lax.while_loop``.  The cores run their recurrence in chunks
of :data:`CHUNK` iterations with the loop condition kept as a device tensor:
an iteration whose condition is false is frozen (every state tensor kept
bit for bit by ``torch.where``, ``k`` not advanced), so the iteration count
and the state equal the JAX loop's exactly while the host reads the
condition once per chunk.  Every host read
goes through :func:`read`, :func:`running` or :func:`to_host`, is counted in
:data:`host_syncs` and, while a profiler records, opens an ``smm.host_sync``
span; each pass of :func:`chunk` opens an ``smm.iteration`` span
(``utils/profiling.py``).
"""

from __future__ import annotations

import torch

from ..utils.profiling import recording, span

CHUNK = 32

# Host readbacks of device scalars since the last reset.
host_syncs = {"count": 0}


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
    """The passes of one chunk: ``range(CHUNK)``, each pass inside an
    ``smm.iteration`` span while a profiler records."""
    return _traced_chunk() if recording() else range(CHUNK)


def _traced_chunk():
    for i in range(CHUNK):
        with span("iteration"):
            yield i


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
