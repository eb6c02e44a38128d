"""Host-driven loop plumbing shared by the solver cores.

torch has no ``lax.while_loop``.  The cores run their recurrence in chunks
of :data:`CHUNK` iterations with the loop condition kept as a device tensor:
an iteration whose condition is false is frozen (every state tensor kept
bit for bit by ``torch.where``, ``k`` not advanced), so the iteration count
and the state equal the JAX loop's exactly while the host reads the
condition once per chunk.  Every host read
goes through :func:`read` and is counted in :data:`host_syncs`.
"""

from __future__ import annotations

import torch

CHUNK = 32

# Host readbacks of device scalars since the last reset.
host_syncs = {"count": 0}


def read(*scalars: torch.Tensor) -> list:
    """Python values of 0-d device tensors, in one transfer."""
    host_syncs["count"] += 1
    return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


def running(active: torch.Tensor) -> bool:
    host_syncs["count"] += 1
    return bool(active)


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
