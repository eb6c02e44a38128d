"""Dense-vector primitives: dot, norms, axpy.

Port of ``sparse_matrix_math_tpu/ops/vector.py:31-64``, the reference's
``Vector<T>`` operations (include/sparse_matrix_math.h:42-381).  Tensors and
plain functions replace the reference's mutable vector class.
"""

from __future__ import annotations

import torch

__all__ = ["dot", "norm2", "norm2_squared", "axpy", "xpay", "fill"]


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product (reference operator*, h:305-328)."""
    return torch.dot(a, b)


def norm2_squared(a: torch.Tensor) -> torch.Tensor:
    """Squared L2 norm (reference secondNormSquared, h:296-303)."""
    return dot(a, a)


def norm2(a: torch.Tensor) -> torch.Tensor:
    """L2 norm (reference secondNorm, h:287-294)."""
    return torch.sqrt(norm2_squared(a))


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """alpha * x + y (h:2060-2072)."""
    return alpha * x + y


def xpay(x: torch.Tensor, alpha, y: torch.Tensor) -> torch.Tensor:
    """x + alpha * y, the search-direction update (h:2384-2394)."""
    return x + alpha * y


def fill(n: int, value, *, dtype=torch.float32, device) -> torch.Tensor:
    """Constant vector on ``device`` (reference Vector::fill, h:226-232)."""
    return torch.full((n,), value, dtype=dtype, device=device)
