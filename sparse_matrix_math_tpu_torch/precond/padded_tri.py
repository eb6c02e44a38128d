"""IC(0) and ILU(0) factor pairs in the padded DIA layout.

Port of ``sparse_matrix_math_tpu/precond/padded_tri.py:30-139``.  The
incomplete factors of a banded matrix are banded too (zero fill keeps them
inside A's pattern), so their strict parts convert to DIA, laid out with
the full matrix's offsets, and the two-solve apply is one call of the fused
sweep kernel K5 (:func:`~..ops.trisweep.tri_pair_apply_fused`).  The factor
values are those of :class:`~.preconditioners.IC0Preconditioner` or
:class:`~.preconditioners.ILU0Preconditioner`; this module only re-lays
them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..formats.dia import DIAMatrix
from ..ops.dia_spmv import PaddedDIA, pad_dia
from ..ops.trisweep import tri_pair_apply_fused
from .trisolve import TriangularMatrix

__all__ = ["PaddedTriPair", "strict_offsets"]


def strict_offsets(tri: TriangularMatrix) -> Tuple[int, ...]:
    """The diagonals (column - row, ascending) of a factor's strict part."""
    return tuple(int(o) for o in torch.unique(tri.indices - tri.row_ids).tolist())


def _strict_to_padded_dia(tri: TriangularMatrix, a: DIAMatrix) -> Optional[PaddedDIA]:
    """A factor's STRICT part as a PaddedDIA in ``a``'s dtype, laid out with
    ``a``'s offsets; None when the strict part is empty.  Raises ValueError
    when its offsets are not among ``a``'s."""
    if tri.data.numel() == 0:
        return None
    offs = tri.indices - tri.row_ids
    uniq = torch.unique(offs)
    if not set(int(o) for o in uniq.tolist()) <= set(a.offsets):
        raise ValueError("factor offsets escape the matrix geometry")
    diags = torch.zeros((uniq.numel(), a.shape[0]), dtype=a.dtype, device=a.device)
    diags[torch.searchsorted(uniq, offs), tri.row_ids] = tri.data.to(a.dtype)
    sub = DIAMatrix(diags=diags, offsets=tuple(int(o) for o in uniq.tolist()), shape=a.shape,
                    nnz=int(tri.data.numel()))
    return pad_dia(sub, geometry_offsets=a.offsets)


@dataclasses.dataclass(frozen=True)
class PaddedTriPair:
    """A factored preconditioner (L solve, then U solve) in the padded DIA
    layout.

    ``p_lower``/``p_upper`` hold the strict parts; ``inv_diag_l_p`` /
    ``inv_diag_u_p`` the inverse diagonal of each factor, padded with 0 on
    guard rows so that guard rows stay exactly 0.
    """

    p_lower: Optional[PaddedDIA]
    p_upper: Optional[PaddedDIA]
    inv_diag_l_p: torch.Tensor  # (n_total,)
    inv_diag_u_p: torch.Tensor  # (n_total,)
    shape: Tuple[int, int]
    sweeps: int
    lead: int
    n_total: int

    @property
    def dtype(self) -> torch.dtype:
        return self.inv_diag_l_p.dtype

    @classmethod
    def from_factors(cls, lower: TriangularMatrix, upper: TriangularMatrix,
                     a: DIAMatrix) -> "PaddedTriPair":
        """Re-lay two ``method='jacobi'`` factors against the geometry of the
        DIA matrix they precondition, in ``a``'s dtype."""
        if lower.method != "jacobi" or upper.method != "jacobi":
            raise ValueError("padded factor pairs need method='jacobi'")
        if lower.sweeps < 1:
            raise ValueError("sweeps must be >= 1")
        p_lower = _strict_to_padded_dia(lower, a)
        p_upper = _strict_to_padded_dia(upper, a)
        ref = p_lower or p_upper or pad_dia(a)
        inv_l = ref.to_padded(1.0 / lower.diag.to(a.dtype))
        inv_u = ref.to_padded(1.0 / upper.diag.to(a.dtype))
        return cls(p_lower=p_lower, p_upper=p_upper, inv_diag_l_p=inv_l, inv_diag_u_p=inv_u,
                   shape=a.shape, sweeps=int(lower.sweeps), lead=ref.lead,
                   n_total=ref.n_total)

    def astype(self, dtype: torch.dtype) -> "PaddedTriPair":
        def cast(p):
            return None if p is None else dataclasses.replace(p, diags_p=p.diags_p.to(dtype))

        return dataclasses.replace(self, p_lower=cast(self.p_lower), p_upper=cast(self.p_upper),
                                   inv_diag_l_p=self.inv_diag_l_p.to(dtype),
                                   inv_diag_u_p=self.inv_diag_u_p.to(dtype))

    def apply_padded(self, rp: torch.Tensor) -> torch.Tensor:
        """z = (L U)^{-1} r with r and z in the padded layout."""
        return tri_pair_apply_fused(self, rp)
