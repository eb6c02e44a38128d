"""Double-word DIA SpMV: the padded layout, the Hopper kernel and its plain version.

Port of ``sparse_matrix_math_tpu/ops/pallas_spmv.py:455-700``.  The kernel is
``csrc/dia_spmv_df.cu`` (its header says what bounds it on the card):

* :func:`dia_spmv_padded_df` (K9, TPU ``_dia_padded_df_kernel``) —
  ``(yh, yl) = A @ (xh, xl)`` with the words of both vectors in the padded
  layout, the matvec of every double-word DIA solve;
* :func:`dia_spmv_streamed_df` (K10, TPU ``_dia_streamed_df_kernel``) — the
  same kernel: the card reads both x words through its L2 at every size.

The layout is :class:`~.dia_spmv.PaddedDIA`'s, for the hi and the lo planes
alike (at least one leading guard block; guard rows write exact zeros).  The
TPU's ``default_rows_blk`` and ``_DF_RESIDENT_X_BYTES`` size its VMEM and are
not ported.

A wrapper given CPU tensors runs the kernel's plain version; given CUDA
tensors it launches the kernel or raises.  Each launch adds one to
:data:`launches`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..formats.dia import DIAMatrix
from . import dia_spmv as _dia
from .df32 import _fast_two_sum, df_add, two_prod

__all__ = ["PaddedDfDia", "pad_dia_df", "dia_spmv_padded_df", "dia_spmv_streamed_df",
           "dia_spmv_padded_df_plain", "launches", "reset_launch_counts"]

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"dia_spmv_padded_df": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class PaddedDfDia:
    """A double-word DIA matrix laid out for the padded kernel: its hi and
    lo planes as two :class:`~.dia_spmv.PaddedDIA` of one geometry."""

    hi: _dia.PaddedDIA
    lo: _dia.PaddedDIA

    @property
    def offsets(self) -> Tuple[int, ...]:
        return self.hi.offsets

    @property
    def shape(self) -> Tuple[int, int]:
        return self.hi.shape

    @property
    def n_total(self) -> int:
        return self.hi.n_total

    @property
    def lead(self) -> int:
        return self.hi.lead

    def to_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Lift one word of a logical vector into the padded layout."""
        return self.hi.to_padded(x)

    def from_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """The logical length-``n_rows`` word of a padded one."""
        return self.hi.from_padded(xp)


def pad_dia_df(dfa) -> PaddedDfDia:
    """One-time layout transform of a :class:`~.df32.DfDiaMatrix` into
    :class:`PaddedDfDia`, on its device."""

    def lay(diags: torch.Tensor) -> _dia.PaddedDIA:
        return _dia.pad_dia(DIAMatrix(diags=diags, offsets=dfa.offsets, shape=dfa.shape,
                                      nnz=dfa.nnz))

    return PaddedDfDia(hi=lay(dfa.diags_hi), lo=lay(dfa.diags_lo))


def dia_spmv_padded_df_plain(diags_hi_p: torch.Tensor, diags_lo_p: torch.Tensor, offsets,
                             lead: int, n_rows: int, xhp: torch.Tensor,
                             xlp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K9/K10: rows in ``[lead, lead + n_rows)`` accumulate, from
    (0, 0) and in ascending-offset order, ``two_prod`` of the hi words plus
    the f32 cross terms, normalised and added in double-word
    (pallas_spmv.py:537-545); every other row is an exact (0, 0)."""
    rows = slice(lead, lead + n_rows)
    acc = (xhp.new_zeros(n_rows), xhp.new_zeros(n_rows))
    for d, off in enumerate(offsets):
        a_hi, a_lo = diags_hi_p[d, rows], diags_lo_p[d, rows]
        wh = xhp[lead + off:lead + off + n_rows]
        wl = xlp[lead + off:lead + off + n_rows]
        p, e = two_prod(a_hi, wh)
        e = e + (a_hi * wl + a_lo * wh)
        acc = df_add(acc, _fast_two_sum(p, e))
    yh, yl = torch.zeros_like(xhp), torch.zeros_like(xlp)
    yh[rows], yl[rows] = acc
    return yh, yl


def dia_spmv_padded_df(a: PaddedDfDia, xhp: torch.Tensor,
                       xlp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: (yh, yl) = A @ (xh, xl) with every word in the padded layout;
    guard rows of both output words are exactly 0."""
    for planes, x in ((a.hi, xhp), (a.lo, xlp)):
        _dia._check(planes.diags_p, x, a.n_total, a.offsets)
        if x.dtype != torch.float32:
            raise TypeError(f"double-word planes and vectors are float32, got {x.dtype}")
    if xhp.device != xlp.device:
        raise ValueError(f"x words on {xhp.device} and {xlp.device}")
    if xhp.device.type == "cpu":
        return dia_spmv_padded_df_plain(a.hi.diags_p, a.lo.diags_p, a.offsets, a.lead,
                                        a.shape[0], xhp, xlp)
    from . import _build

    lib = _build.library()
    yh = torch.empty(a.n_total, dtype=torch.float32, device=xhp.device)
    yl = torch.empty_like(yh)
    offs = np.asarray(a.offsets, dtype=np.int32)
    with torch.cuda.device(xhp.device):
        code = lib.smm_dia_spmv_padded_df(
            a.hi.diags_p.data_ptr(), a.lo.diags_p.data_ptr(), xhp.data_ptr(), xlp.data_ptr(),
            yh.data_ptr(), yl.data_ptr(), offs.ctypes.data, len(a.offsets), a.n_total, a.lead,
            a.shape[0], torch.cuda.current_stream().cuda_stream)
    _build.check(code, "dia_spmv_padded_df")
    launches["dia_spmv_padded_df"] += 1
    return yh, yl


def dia_spmv_streamed_df(a: PaddedDfDia, xhp: torch.Tensor,
                         xlp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: the TPU's variant with both x words in HBM.  On the card it is
    K9's kernel: x is read through the 50 MB L2 at every size."""
    return dia_spmv_padded_df(a, xhp, xlp)
