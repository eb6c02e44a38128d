"""Solver front-door wrapper.

Port of the routing part of
``sparse_matrix_math_tpu/formats/reorder.py:209-235``: a CSR matrix handed to
a solver goes through :func:`~.auto_route_for_solve` first.  The JAX
wrapper's other branch, solving an RCM-reordered matrix in the permuted
domain, comes with the RCM port.
"""

from __future__ import annotations

import functools

from .csr import CSRMatrix

__all__ = ["reorder_hoisted"]


def reorder_hoisted(solver_fn):
    """Wrap a solver entry ``f(a, b, x0=None, **kw)`` so a large CSR matrix
    on a CUDA device is routed to a fast layout before the solve."""

    @functools.wraps(solver_fn)
    def wrapped(a, b, x0=None, *args, **kwargs):
        if isinstance(a, CSRMatrix):
            from . import auto_route_for_solve

            a = auto_route_for_solve(
                a, has_preconditioner=kwargs.get("preconditioner") is not None
            )
        return solver_fn(a, b, x0, *args, **kwargs)

    return wrapped
