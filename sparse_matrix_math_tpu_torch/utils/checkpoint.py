"""Checkpoint / resume for long-running solves.

Port of ``sparse_matrix_math_tpu/utils/checkpoint.py``.  The reference's only
"resume" capability is the initial-guess argument ``x0`` (Krylov restart —
reference README.md:5, solver signature include/sparse_matrix_math.h:2319-2320)
and matrix persistence via ``saveDenseText`` (h:1930-1993).  Here solver state
(x, iteration count, residual) is snapshotted to disk at a fixed iteration
cadence and resumed after preemption.

The files are the JAX package's: a checkpoint is an ``.npz`` with ``x``,
``iterations_done`` (int64) and ``residual_norm`` (float64), and a CSR
snapshot (:func:`save_csr_npz` / :func:`load_csr_npz`) an ``.npz`` with
``data``, ``indices``, ``indptr`` and ``shape``, so either package loads what
the other wrote.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import numpy as np
import torch

from ..formats.csr import CSRMatrix, _csr_from_sorted
from ..solvers.types import SolveResult, SolverStatus

__all__ = [
    "SolverCheckpoint",
    "save_checkpoint",
    "load_checkpoint",
    "checkpointed_solve",
    "save_csr_npz",
    "load_csr_npz",
]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass(frozen=True)
class SolverCheckpoint:
    """Resumable solver state (``x`` on the host)."""

    x: np.ndarray
    iterations_done: int
    residual_norm: float


def save_checkpoint(path: str, ckpt: SolverCheckpoint) -> None:
    """Atomic snapshot (write-temp + rename, preemption-safe).

    The temp name is pid-unique so two processes checkpointing the same
    path cannot interleave savez/os.replace and corrupt each other's
    snapshot.
    """
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(
        tmp,
        x=_host(ckpt.x),
        iterations_done=np.int64(ckpt.iterations_done),
        residual_norm=np.float64(ckpt.residual_norm),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[SolverCheckpoint]:
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return SolverCheckpoint(
            x=z["x"],
            iterations_done=int(z["iterations_done"]),
            residual_norm=float(z["residual_norm"]),
        )


def checkpointed_solve(
    solver: Callable,
    a,
    b: torch.Tensor,
    *,
    checkpoint_path: str,
    chunk_iterations: int = 100,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    **solver_kwargs,
) -> SolveResult:
    """Run ``solver`` in restart chunks, checkpointing between chunks.

    Each chunk is a fresh Krylov solve warm-started from the checkpointed
    ``x`` (restarted-Krylov semantics — the subspace resets at chunk
    boundaries, so convergence can take somewhat more total iterations
    than a single uninterrupted run).  If ``checkpoint_path`` exists the
    solve resumes from it, with its ``x`` put on ``b``'s device.

    With a distributed operand (``parallel``'s, e.g. with
    ``solver=functools.partial(dist_solve, solver="cg")``) every rank runs
    this, through the operand's own ``gather_vector`` / ``scatter_vector`` /
    ``write_once``: the file holds the global x in the JAX package's padded
    layout, rank 0 alone writes it, and every rank resumes from the same
    file.  ``max_iterations=-1`` means the matrix's n.
    """
    if hasattr(a, "gather_vector"):
        n, to_host, to_device, write_once = (
            a.shape[0], a.gather_vector, a.scatter_vector, a.write_once)
    else:
        n, to_host, write_once = b.shape[0], _host, (lambda write: write())

        def to_device(x_host):
            return torch.from_numpy(x_host).to(b.device)

    total_cap = int(n) if max_iterations in (-1, None) else int(max_iterations)

    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is not None:
        x = to_device(ckpt.x)
        done = ckpt.iterations_done
        if ckpt.residual_norm <= epsilon:
            # The checkpointed run already converged — report it as such
            # rather than rerunning a 0-iteration solve (which would
            # mislabel the outcome MAX_ITERATIONS_REACHED).
            return SolveResult(
                x=x,
                status=int(SolverStatus.SUCCESS),
                iterations=done,
                residual_norm=torch.tensor(ckpt.residual_norm, dtype=x.dtype, device=x.device),
                residual_trace=None,
                floor_hit=False,
            )
    else:
        x = None
        done = 0

    res = None
    while done < total_cap:
        chunk = min(chunk_iterations, total_cap - done)
        res = solver(
            a, b, x0=x, max_iterations=chunk, epsilon=epsilon, **solver_kwargs
        )
        done += int(res.iterations)
        x = res.x
        snapshot = SolverCheckpoint(x=to_host(x), iterations_done=done,
                                    residual_norm=float(res.residual_norm))
        write_once(lambda: save_checkpoint(checkpoint_path, snapshot))
        if int(res.status) != SolverStatus.MAX_ITERATIONS_REACHED:
            break
    if res is None:  # checkpoint already past the cap
        res = solver(a, b, x0=x, max_iterations=0, epsilon=epsilon, **solver_kwargs)
    return dataclasses.replace(res, iterations=done)


def save_csr_npz(path: str, a: CSRMatrix) -> None:
    """Binary CSR snapshot (complement of the reference's dense-text
    persistence, h:1930-1993)."""
    np.savez_compressed(
        path,
        data=_host(a.data),
        indices=_host(a.indices),
        indptr=_host(a.indptr),
        shape=np.asarray(a.shape, dtype=np.int64),
    )


def load_csr_npz(path: str, *, device) -> CSRMatrix:
    """The :class:`CSRMatrix` of a :func:`save_csr_npz` snapshot, on ``device``."""
    with np.load(path) as z:
        indptr = torch.from_numpy(z["indptr"].astype(np.int64)).to(device)
        rows = torch.repeat_interleave(
            torch.arange(indptr.shape[0] - 1, device=device), torch.diff(indptr)
        )
        return _csr_from_sorted(
            rows, torch.from_numpy(z["indices"].astype(np.int64)).to(device),
            torch.from_numpy(z["data"]).to(device), tuple(int(s) for s in z["shape"]),
        )
