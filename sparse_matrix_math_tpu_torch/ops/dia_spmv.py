"""DIA SpMV: the padded layout, the Hopper kernels and their plain versions.

Port of ``sparse_matrix_math_tpu/ops/pallas_spmv.py:44-386``.  The kernels
are ``csrc/dia_spmv.cu`` (its header says what bounds them on the card):

* :func:`dia_spmv` (K1, TPU ``_dia_kernel``) — one-shot ``y = A @ x`` on an
  unpadded ``x``, for ``rmult`` on a :class:`DIAMatrix`;
* :func:`dia_spmv_padded` (K2, TPU ``_dia_padded_kernel``) — ``y = A @ x``
  with both vectors in the :class:`PaddedDIA` layout, the matvec of every
  DIA solve;
* :func:`dia_spmv_streamed` (K3, TPU ``_dia_streamed_kernel``) — the same
  kernel as K2: the card reads x through its L2 at every size.

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

__all__ = [
    "PaddedDIA", "pad_dia", "dia_spmv", "dia_spmv_padded", "dia_spmv_streamed",
    "dia_spmv_plain", "dia_spmv_padded_plain", "launches", "reset_launch_counts",
]

_BLOCK = 128  # guard granularity, as the TPU layout's lane width
_MAX_DIAGS = 64  # kMaxDiags in csrc/dia_spmv.cu; DIA's own max_diags
_DTYPES = (torch.float32, torch.float64)

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"dia_spmv": 0, "dia_spmv_padded": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


@dataclasses.dataclass(frozen=True)
class PaddedDIA:
    """A DIA matrix laid out for the padded kernel.

    Solver vectors live in a flat layout of ``n_total`` elements: ``lblk``
    leading guard blocks of 128, the data from ``lead = lblk * 128``, then
    trailing guard blocks.  The leading guard is at least ``-min(offsets)``
    and never empty; the trailing one covers ``max(offsets)``; guard
    elements stay exactly zero through the kernel, axpys and dots.
    ``diags_p[d, e]`` is the coefficient of row ``e - lead``.
    """

    diags_p: torch.Tensor  # (ndiags, n_total)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    n_total: int
    lblk: int  # leading guard blocks
    nblk: int  # data blocks

    @property
    def lead(self) -> int:
        return self.lblk * _BLOCK

    @property
    def dtype(self) -> torch.dtype:
        return self.diags_p.dtype

    @property
    def device(self) -> torch.device:
        return self.diags_p.device

    def to_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Lift a logical vector into the padded layout."""
        out = torch.zeros(self.n_total, dtype=x.dtype, device=x.device)
        out[self.lead:self.lead + x.shape[0]] = x
        return out

    def from_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """The logical length-``n_rows`` vector of a padded one."""
        return xp[self.lead:self.lead + self.shape[0]]


def _dia_layout_params(offsets, shape) -> Tuple[int, int, int, int]:
    """Layout geometry in 128-element blocks: (lblk, nblk, rblk, n_total).
    At least one leading guard block always exists (pallas_spmv.py:198-215):
    later kernels rely on the first rows of the layout being zero."""
    n_rows, n_cols = shape
    lblk = max(-(min(offsets) // _BLOCK), 1)
    nblk = -(-max(n_rows, n_cols) // _BLOCK)
    rblk = -(-max(max(offsets), 0) // _BLOCK)
    return lblk, nblk, rblk, (lblk + nblk + rblk) * _BLOCK


def pad_dia(a: DIAMatrix, geometry_offsets=None) -> PaddedDIA:
    """One-time layout transform of ``a`` into :class:`PaddedDIA`, on
    ``a``'s device.

    ``geometry_offsets`` sizes the guards from this superset of
    ``a.offsets`` instead of ``a.offsets`` (pallas_spmv.py:218-250): the
    strict factors of a preconditioner are laid out so, with the full
    matrix's offsets, and share its ``lblk``, ``nblk`` and ``n_total``, so
    the solver vectors pass between them unchanged.
    """
    if not a.offsets:
        raise ValueError("a DIA matrix with no stored diagonals has no padded layout")
    geo = a.offsets if geometry_offsets is None else tuple(geometry_offsets)
    if not set(a.offsets) <= set(geo):
        raise ValueError("geometry_offsets must be a superset of a.offsets")
    lblk, nblk, _, n_total = _dia_layout_params(geo, a.shape)
    lead = lblk * _BLOCK
    diags_p = torch.zeros((len(a.offsets), n_total), dtype=a.dtype, device=a.device)
    diags_p[:, lead:lead + a.shape[0]] = a.diags
    return PaddedDIA(diags_p=diags_p, offsets=a.offsets, shape=a.shape, nnz=a.nnz,
                     n_total=n_total, lblk=lblk, nblk=nblk)


# -- plain versions: the kernels' index math and summation order -------------


def dia_spmv_plain(diags: torch.Tensor, offsets, shape, x: torch.Tensor) -> torch.Tensor:
    """Plain K1: terms whose column ``i + off`` is outside ``[0, n_cols)``
    are skipped; the rest add in ascending-offset order from 0."""
    n_rows, n_cols = shape
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    for d, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n_rows, n_cols - off)
        if lo < hi:
            y[lo:hi] += diags[d, lo:hi] * x[lo + off:hi + off]
    return y


def dia_spmv_padded_plain(diags_p: torch.Tensor, offsets, lead: int, n_rows: int,
                          xp: torch.Tensor) -> torch.Tensor:
    """Plain K2/K3: rows in ``[lead, lead + n_rows)`` sum their terms in
    ascending-offset order; every other row is an exact 0."""
    y = torch.zeros_like(xp)
    rows = slice(lead, lead + n_rows)
    acc = None
    for d, off in enumerate(offsets):
        term = diags_p[d, rows] * xp[lead + off:lead + off + n_rows]
        acc = term if acc is None else acc + term
    y[rows] = acc
    return y


# -- wrappers ------------------------------------------------------------------


def _check(diags: torch.Tensor, x: torch.Tensor, x_len: int, offsets) -> None:
    if diags.device != x.device:
        raise ValueError(f"diagonals on {diags.device} but x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if diags.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(
            f"diagonals ({diags.dtype}) and x ({x.dtype}) must both be float32 "
            "or both float64"
        )
    if x.shape != (x_len,):
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({x_len},)")
    if not (diags.is_contiguous() and x.is_contiguous()):
        raise ValueError("diagonals and x must be contiguous")
    if not 1 <= len(offsets) <= _MAX_DIAGS:
        raise ValueError(f"{len(offsets)} diagonals; the kernel takes 1..{_MAX_DIAGS}")


def dia_spmv(a: DIAMatrix, x: torch.Tensor) -> torch.Tensor:
    """K1: y = A @ x for a DIA matrix and an unpadded length-``n_cols`` x."""
    n_rows, n_cols = a.shape
    _check(a.diags, x, n_cols, a.offsets)
    if x.device.type == "cpu":
        return dia_spmv_plain(a.diags, a.offsets, a.shape, x)
    from . import _build

    lib = _build.library()
    fn = lib.smm_dia_spmv_f32 if x.dtype == torch.float32 else lib.smm_dia_spmv_f64
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    offs = np.asarray(a.offsets, dtype=np.int32)
    with torch.cuda.device(x.device):
        code = fn(a.diags.data_ptr(), x.data_ptr(), y.data_ptr(), offs.ctypes.data,
                  len(a.offsets), n_rows, n_cols, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "dia_spmv")
    launches["dia_spmv"] += 1
    return y


def dia_spmv_padded(a: PaddedDIA, xp: torch.Tensor) -> torch.Tensor:
    """K2: y = A @ x with x and y in the padded layout; guard rows of y are
    exactly 0."""
    _check(a.diags_p, xp, a.n_total, a.offsets)
    if xp.device.type == "cpu":
        return dia_spmv_padded_plain(a.diags_p, a.offsets, a.lead, a.shape[0], xp)
    from . import _build

    lib = _build.library()
    fn = (lib.smm_dia_spmv_padded_f32 if xp.dtype == torch.float32
          else lib.smm_dia_spmv_padded_f64)
    y = torch.empty(a.n_total, dtype=xp.dtype, device=xp.device)
    offs = np.asarray(a.offsets, dtype=np.int32)
    with torch.cuda.device(xp.device):
        code = fn(a.diags_p.data_ptr(), xp.data_ptr(), y.data_ptr(), offs.ctypes.data,
                  len(a.offsets), a.n_total, a.lead, a.shape[0],
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "dia_spmv_padded")
    launches["dia_spmv_padded"] += 1
    return y


def dia_spmv_streamed(a: PaddedDIA, xp: torch.Tensor) -> torch.Tensor:
    """K3: the TPU's large-n variant.  On the card it is the padded kernel:
    x is read through the 50 MB L2 at every size, so there is no
    resident/streamed split."""
    return dia_spmv_padded(a, xp)
