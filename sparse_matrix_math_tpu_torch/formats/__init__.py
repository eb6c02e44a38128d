from .csr import CSRMatrix, csr_from_coo
from .dia import DIAMatrix, dia_from_csr, try_dia_from_csr
from .ell import ELLMatrix, ell_from_csr
from .hyb import HYBMatrix, hyb_from_csr
from .reorder import ReorderedMatrix, permute_csr, rcm_permutation, reorder_to_wsell
from .triplet import COOArrays, coo_from_arrays
from .wsell import WSellMatrix, try_wsell_from_csr, wsell_from_csr

# -- default-path safety at scale ---------------------------------------------
#
# Port of sparse_matrix_math_tpu/formats/__init__.py:89-154.  A large CSR
# matrix on the card would run every solver iteration through the gather and
# index_add_ path, so the solver front doors (formats/reorder.py) route it
# to DIA, W-SELL or RCM+W-SELL first.  Routing is active for matrices on a
# CUDA device, the counterpart of the JAX package's TPU backend check.
# SMM_NO_AUTOROUTE=1 turns it off; SMM_FORCE_AUTOROUTE=1 turns it on for
# matrices on the CPU (tests).  ``best_format`` is not ported yet: it also
# chooses the grid-stencil and R-SELL layouts.

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
    """Route a large CSR matrix to a fast layout before a solve.

    Returns ``a`` unchanged unless it is a CSRMatrix at scale with routing
    active.  Tries DIA, then W-SELL (nway 4), then, only with no
    preconditioner bound (a factor built in the original ordering would be
    wrong in a permuted domain) and for a square matrix, RCM + W-SELL.  A
    pattern none of them serves keeps CSR and raises a
    :class:`PerformanceWarning` naming the layouts that refused it.  The
    route ``(kind, routed)`` is cached on ``a``; a cached ``"reorder"``
    route is not reused when a preconditioner is bound.
    """
    if not isinstance(a, CSRMatrix):
        return a
    if a.shape[0] < _AUTOROUTE_MIN_ROWS or a.nnz < _AUTOROUTE_MIN_NNZ:
        return a
    if not _autoroute_active(a):
        return a
    cached = getattr(a, "_auto_routed", None)
    if cached is not None:
        kind, routed = cached
        if kind != "reorder" or not has_preconditioner:
            return routed
    tried = ["DIA", "W-SELL"]
    routed, kind = try_dia_from_csr(a), "dia"
    if routed is None:
        routed, kind = try_wsell_from_csr(a, max_slot_ratio=8.0), "wsell"
    if routed is None and not has_preconditioner and a.shape[0] == a.shape[1]:
        tried.append("RCM + W-SELL")
        routed, kind = reorder_to_wsell(a, max_slot_ratio=8.0), "reorder"
    if routed is None:
        import warnings

        why = ("; the permuting route is off with a preconditioner bound"
               if has_preconditioner else "")
        warnings.warn(
            f"solving a {a.shape[0]}x{a.shape[1]} CSR matrix ({a.nnz} nnz) "
            "through the gather/index_add path, far slower than the sparse "
            f"kernels: {', '.join(tried)} refused this pattern{why}.",
            PerformanceWarning,
            stacklevel=4,
        )
        return a
    object.__setattr__(a, "_auto_routed", (kind, routed))
    return routed


__all__ = [
    "CSRMatrix", "csr_from_coo", "DIAMatrix", "dia_from_csr", "try_dia_from_csr",
    "ELLMatrix", "ell_from_csr", "HYBMatrix", "hyb_from_csr", "WSellMatrix",
    "wsell_from_csr", "try_wsell_from_csr", "ReorderedMatrix", "permute_csr",
    "rcm_permutation", "reorder_to_wsell", "COOArrays", "coo_from_arrays",
    "auto_route_for_solve", "PerformanceWarning",
]
