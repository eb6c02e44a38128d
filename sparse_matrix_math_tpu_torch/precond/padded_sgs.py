"""Symmetric Gauss-Seidel in the padded DIA layout.

Port of ``sparse_matrix_math_tpu/precond/padded_sgs.py:41-161``.  For a DIA
matrix the strict lower and upper parts are themselves DIA matrices, so
each Jacobi sweep of a truncated SGS apply is a banded product.  The factors
are laid out with the full matrix's offsets (``pad_dia``'s
``geometry_offsets``), so the whole preconditioned iteration stays in one
padded layout, and every apply is one call of the fused sweep kernel K4
(:func:`~..ops.trisweep.sgs_apply_fused`).  Where the stored values are
those of a constant-coefficient grid stencil
(:func:`~..ops.trisweep.constant_stencil`), the strict parts are held as
one value a diagonal (:class:`~..ops.trisweep.ScalarFactor`) and never
padded, and K4 reads them as scalars.

A truncated sweep count is a fixed linear operator, so it is a valid
preconditioner M ~= (D+L) D^{-1} (D+U); for constant-diagonal SPD stencils
it is also SPD, so PCG may use it.  SGS(4) is what makes f32 BiCGStab
converge on the 2M-row Poisson system in the JAX package's bench.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..formats.dia import DIAMatrix
from ..ops.dia_spmv import _BLOCK, PaddedDIA, _dia_layout_params, pad_dia
from ..ops.trisweep import ScalarFactor, constant_stencil, sgs_apply_fused
from ._factorize import FactorizationError
from .preconditioners import _SGS_MIN_DIAG

__all__ = ["PaddedSGS"]


@dataclasses.dataclass(frozen=True)
class PaddedSGS:
    """SGS preconditioner whose factors live in the padded DIA layout.

    ``p_lower``/``p_upper`` hold the STRICT triangular diagonals (None when
    that part is empty), as :class:`ScalarFactor` objects for a
    constant-coefficient stencil; ``inv_diag_p``/``diag_p`` are the padded
    diagonal vectors, 0 on guard rows, so guard rows stay exactly 0 through
    every sweep.
    """

    p_lower: Optional[Union[PaddedDIA, ScalarFactor]]
    p_upper: Optional[Union[PaddedDIA, ScalarFactor]]
    inv_diag_p: torch.Tensor  # (n_total,)
    diag_p: torch.Tensor      # (n_total,)
    shape: Tuple[int, int]
    sweeps: int
    lead: int
    n_total: int

    @property
    def dtype(self) -> torch.dtype:
        return self.diag_p.dtype

    @classmethod
    def from_dia(cls, a: DIAMatrix, *, sweeps: int = 2) -> "PaddedSGS":
        """Split a DIA matrix into padded D / strict-L / strict-U factors.

        Needs ``sweeps >= 1`` and a stored main diagonal with
        ``|d_i| >= 1e-5`` on every row (the reference's SGS check,
        h:1690-1693)."""
        if int(sweeps) < 1:
            raise ValueError("sweeps must be >= 1")
        offsets = a.offsets
        if 0 not in offsets:
            raise FactorizationError("SGS requires a stored main diagonal")
        diag = a.diags[offsets.index(0)]
        if bool((diag.abs() < _SGS_MIN_DIAG).any()):
            raise FactorizationError(f"SGS requires |diagonal| >= {_SGS_MIN_DIAG} on every row")

        # the layout of every factor is the full matrix's
        lblk, _, _, n_total = _dia_layout_params(offsets, a.shape)
        lead, n = lblk * _BLOCK, a.shape[0]
        inv = 1.0 / diag

        def padded(v):
            out = torch.zeros(n_total, dtype=v.dtype, device=v.device)
            out[lead:lead + n] = v
            return out

        found = constant_stencil(a.diags, offsets, inv, 0, n, 0, n, lead=lead, n_total=n_total)

        def strict_part(sign):
            if found is not None:
                return found[sign > 0]
            keep = [i for i, off in enumerate(offsets) if off * sign > 0]
            if not keep:
                return None
            sub = DIAMatrix(diags=a.diags[keep], offsets=tuple(offsets[i] for i in keep),
                            shape=a.shape, nnz=a.nnz)
            return pad_dia(sub, geometry_offsets=offsets)

        return cls(p_lower=strict_part(-1), p_upper=strict_part(1), inv_diag_p=padded(inv),
                   diag_p=padded(diag), shape=a.shape, sweeps=int(sweeps), lead=lead,
                   n_total=n_total)

    def astype(self, dtype: torch.dtype) -> "PaddedSGS":
        def cast(p):
            if p is None:
                return None
            if isinstance(p, ScalarFactor):
                return p.astype(dtype)
            return dataclasses.replace(p, diags_p=p.diags_p.to(dtype))

        return dataclasses.replace(self, p_lower=cast(self.p_lower), p_upper=cast(self.p_upper),
                                   inv_diag_p=self.inv_diag_p.to(dtype),
                                   diag_p=self.diag_p.to(dtype))

    def apply_padded(self, rp: torch.Tensor) -> torch.Tensor:
        """z = M^{-1} r with r and z in the padded layout: forward
        (D+L) y = r, then backward (D+U) z = D y (h:1672-1711)."""
        return sgs_apply_fused(self, rp)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """The apply on a logical (n,) vector: pad, apply, unpad; lets the
        same object serve the solvers' generic path."""
        rp = torch.zeros(self.n_total, dtype=r.dtype, device=r.device)
        rp[self.lead:self.lead + self.shape[0]] = r
        return self.apply_padded(rp)[self.lead:self.lead + self.shape[0]]
