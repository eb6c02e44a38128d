from .csr import CSRMatrix, csr_from_coo
from .dia import DIAMatrix, dia_from_csr, try_dia_from_csr
from .triplet import COOArrays, coo_from_arrays

# -- default-path safety at scale ---------------------------------------------
#
# Port of sparse_matrix_math_tpu/formats/__init__.py:89-154.  A large CSR
# matrix on the card would run every solver iteration through the gather and
# index_add_ path, so the solver front doors (formats/reorder.py) route it
# to DIA first when its pattern allows.  Routing is active for matrices on a
# CUDA device, the counterpart of the JAX package's TPU backend check.
# SMM_NO_AUTOROUTE=1 turns it off; SMM_FORCE_AUTOROUTE=1 turns it on for
# matrices on the CPU (tests).

_AUTOROUTE_MIN_ROWS = 2048
_AUTOROUTE_MIN_NNZ = 100_000


class PerformanceWarning(UserWarning):
    """A public API call is about to run far below hardware speed."""


def _autoroute_active(a: CSRMatrix) -> bool:
    import os

    if os.environ.get("SMM_NO_AUTOROUTE"):
        return False
    if os.environ.get("SMM_FORCE_AUTOROUTE"):
        return True
    return a.device.type == "cuda"


def auto_route_for_solve(a, *, has_preconditioner: bool = False):
    """Route a large CSR matrix to DIA before a solve.

    Returns ``a`` unchanged unless it is a CSRMatrix at scale with routing
    active.  A pattern DIA does not serve keeps CSR and raises a
    :class:`PerformanceWarning`.  The routed matrix is cached on ``a``, so
    repeated solves convert once.  ``has_preconditioner`` is accepted for
    the JAX signature; it only matters to the reordering routes, which are
    not ported yet.
    """
    del has_preconditioner
    if not isinstance(a, CSRMatrix):
        return a
    if a.shape[0] < _AUTOROUTE_MIN_ROWS or a.nnz < _AUTOROUTE_MIN_NNZ:
        return a
    if not _autoroute_active(a):
        return a
    cached = getattr(a, "_auto_routed", None)
    if cached is not None:
        return cached
    routed = try_dia_from_csr(a)
    if routed is None:
        import warnings

        warnings.warn(
            f"solving a {a.shape[0]}x{a.shape[1]} CSR matrix ({a.nnz} nnz) "
            "through the gather/index_add path, far slower than the DIA "
            "kernel; this pattern has too many or too sparse diagonals for DIA.",
            PerformanceWarning,
            stacklevel=4,
        )
        return a
    object.__setattr__(a, "_auto_routed", routed)
    return routed


__all__ = [
    "CSRMatrix", "csr_from_coo", "DIAMatrix", "dia_from_csr", "try_dia_from_csr",
    "COOArrays", "coo_from_arrays", "auto_route_for_solve", "PerformanceWarning",
]
