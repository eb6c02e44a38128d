"""Solver status and result types.

Port of ``sparse_matrix_math_tpu/solvers/types.py:23-115``.  The status enum
keeps the reference's values (include/sparse_matrix_math.h:2010-2014).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

__all__ = ["SolverStatus", "SolveResult", "RUNNING", "harmonize_dtypes",
           "resolve_max_iterations"]


class SolverStatus(enum.IntEnum):
    """Matches the reference enum values (sparse_matrix_math.h:2010-2014)."""

    SUCCESS = 0
    DIVERGED = 1
    MAX_ITERATIONS_REACHED = 2


# In-flight status inside a solve loop (never returned).
RUNNING = 3


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """Result of an iterative solve.

    ``x`` and ``residual_norm`` (the final true ``||b - A x||``, a 0-d
    tensor in x's dtype) stay on the device; ``status``, ``iterations`` and
    ``floor_hit`` are Python scalars.  ``floor_hit`` is True when a
    MAX_ITERATIONS_REACHED exit was a precision floor: a restart failed to
    shrink the true residual, so more iterations cannot help.
    """

    x: torch.Tensor
    status: int
    iterations: int
    residual_norm: torch.Tensor
    residual_trace: Optional[torch.Tensor] = None  # (max_iter+1,) or None
    floor_hit: Optional[bool] = None

    def status_enum(self) -> SolverStatus:
        return SolverStatus(int(self.status))

    @property
    def hit_precision_floor(self) -> bool:
        return bool(self.floor_hit)

    @property
    def success(self) -> bool:
        return int(self.status) == SolverStatus.SUCCESS

    def __repr__(self) -> str:
        return (
            f"SolveResult(status={self.status_enum().name}, "
            f"iterations={int(self.iterations)}, "
            f"residual_norm={float(self.residual_norm):.3e})"
        )


def harmonize_dtypes(a, b: torch.Tensor, x0: Optional[torch.Tensor]):
    """Promote ``b``/``x0`` to the solve dtype when the operator's value
    dtype differs (the reference is templated on one scalar type, h:2316)."""
    dt = getattr(a, "dtype", None)
    if isinstance(dt, torch.dtype) and dt.is_floating_point and b.dtype != dt:
        out = torch.promote_types(dt, b.dtype)
        b = b.to(out)
        if x0 is not None:
            x0 = x0.to(out)
    return b, x0


def resolve_max_iterations(max_iterations, n: int) -> int:
    """-1 (or None) means as many iterations as rows (h:2031-2033,
    2345-2347); a user cap is honoured as given, not clamped to n."""
    if max_iterations is None or max_iterations == -1:
        return int(n)
    if max_iterations < 0:
        raise ValueError(f"max_iterations must be -1 or >= 0, got {max_iterations}")
    return int(max_iterations)
