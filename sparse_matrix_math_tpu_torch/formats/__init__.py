from .csr import CSRMatrix, csr_from_coo, csr_from_dense, csr_from_triplet
from .dia import DIAMatrix, dia_from_csr, try_dia_from_csr
from .ell import ELLMatrix, ell_from_csr
from .hyb import HYBMatrix, hyb_from_csr
from .reorder import ReorderedMatrix, permute_csr, rcm_permutation, reorder_to_wsell
from .rsell import RoutedMatrix, routed_from_csr, try_routed_from_csr
from .stencil import GridStencilMatrix, try_grid_stencil_from_csr, try_grid_stencil_from_dia
from .triplet import COOArrays, TripletMatrix, coo_from_arrays
from .wsell import WSellMatrix, try_wsell_from_csr, wsell_from_csr


def best_format(csr, *, max_slot_ratio: float = 8.0, allow_reorder: bool = True):
    """Pick the layout for a CSR matrix's pattern, on the CSR's device.

    Port of ``sparse_matrix_math_tpu/formats/__init__.py:17-73``: the same
    order and the same thresholds (the JAX package's constants; they have not
    been derived again for the card).

    0. Grid stencil: constant-coefficient tensor-product-grid operators,
       verified entry for entry: matrix-free (formats/stencil.py);
    1. DIA: diagonal-structured patterns;
    2. W-SELL: general patterns with window locality;
    3. RCM + W-SELL: scattered patterns whose bandwidth a reverse
       Cuthill-McKee renumbering reduces; the solvers hoist the permutation
       out of their loops.  Skipped with ``allow_reorder=False`` and for
       rectangular matrices;
    4. R-SELL: patterns with no tile locality at scale, the routed chain
       (formats/rsell.py), tried only above 2048 rows and 100,000 nonzeros
       and when no windowed layout fits;
    5. the CSR itself: small matrices and what the routed chain cannot pack.

    The returned object goes into every solver and ``rmult``.
    """
    dia = try_dia_from_csr(csr)
    if dia is not None:
        st = try_grid_stencil_from_csr(csr, dia=dia)
        return st if st is not None else dia
    ws = try_wsell_from_csr(csr, max_slot_ratio=max_slot_ratio)
    if ws is not None and ws.slot_ratio <= 3.0:
        # tight enough that a renumbering cannot buy much
        return ws
    if allow_reorder and csr.shape[0] == csr.shape[1]:
        ro = reorder_to_wsell(csr, max_slot_ratio=max_slot_ratio)
        if ro is not None and (ws is None or ro.inner.slot_ratio < 0.7 * ws.slot_ratio):
            # the kernel's cost follows slot_ratio and the permutation is
            # hoisted out of solver loops, so a clearly lower reordered ratio
            # wins; otherwise keep the raw layout
            return ro
    if ws is not None:
        return ws
    if csr.shape[0] > 2048 and csr.nnz >= 100_000:
        ra = try_routed_from_csr(csr, max_slot_ratio=12.0)
        if ra is not None:
            return ra
    return csr


# -- default-path safety at scale ---------------------------------------------
#
# Port of sparse_matrix_math_tpu/formats/__init__.py:89-154.  A large CSR
# matrix on the card would run every solver iteration through the gather and
# row-sum path, so the solver front doors (formats/reorder.py) route it
# to DIA, W-SELL or RCM+W-SELL first.  Routing is active for matrices on a
# CUDA device, the counterpart of the JAX package's TPU backend check.
# SMM_NO_AUTOROUTE=1 turns it off; SMM_FORCE_AUTOROUTE=1 turns it on for
# matrices on the CPU (tests).  Routing never builds the routed (R-SELL)
# chain, a deliberate investment of host time: it warns and names
# ``best_format`` / ``solve(..., auto_format=True)`` instead.

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
            "through the gather/row-sum path, far slower than the sparse "
            f"kernels: {', '.join(tried)} refused this pattern{why}.  Consider "
            "best_format(a) or solve(..., auto_format=True), which may build "
            "the routed R-SELL chain.",
            PerformanceWarning,
            stacklevel=4,
        )
        return a
    object.__setattr__(a, "_auto_routed", (kind, routed))
    return routed


__all__ = [
    "CSRMatrix", "csr_from_coo", "csr_from_dense", "csr_from_triplet", "TripletMatrix",
    "DIAMatrix", "dia_from_csr", "try_dia_from_csr",
    "ELLMatrix", "ell_from_csr", "HYBMatrix", "hyb_from_csr", "WSellMatrix",
    "wsell_from_csr", "try_wsell_from_csr", "ReorderedMatrix", "permute_csr",
    "rcm_permutation", "reorder_to_wsell", "COOArrays", "coo_from_arrays",
    "RoutedMatrix", "routed_from_csr", "try_routed_from_csr", "GridStencilMatrix",
    "try_grid_stencil_from_csr", "try_grid_stencil_from_dia", "best_format",
    "auto_route_for_solve", "PerformanceWarning",
]
