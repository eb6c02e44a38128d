"""ELL SpMV: the Hopper kernel and its plain versions.

Port of ``sparse_matrix_math_tpu/ops/pallas_spmv.py:389-452``.
:func:`ell_spmv` (K6, TPU ``_ell_kernel``) computes ``y[i] = sum_k vals[i, k]
* x[cols[i, k]]`` for ``i < n_rows``, summing k in ascending order.  On the
card it launches ``csrc/sell_spmv.cu`` (``ops/sell_spmv.py``) over the
matrix's slab-sorted SELL-32 layout (``ELLMatrix.sell``), which holds each
row's live slots in that order and skips the padding; the planes are not
read.  :func:`ell_spmv_plain` is the planes' product, the JAX order with
the padding slots' ``0 * x[0]`` added; the layout's plain version
(``sell_spmv_plain``) equals it bit for bit for finite x, up to the sign of
a zero sum.  :func:`ell_spmm` computes ``Y = A @ X`` for an ``(n_cols, k)``
panel with the same kernel's panel instantiations (K8's), one launch per 8
columns, column j equal to :func:`ell_spmv` of column j bit for bit.

A recorded deviation: the JAX package's ``rmult`` on an ``ELLMatrix`` runs
XLA (ops/spmv.py:156-161), because Mosaic cannot compile the kernel's 1-D
gather (pallas_spmv.py:435-449); the card gathers natively, so the port's
``rmult`` on a CUDA ``ELLMatrix`` launches K6.

A wrapper given CPU tensors runs the layout's plain version; given CUDA
tensors it launches the kernel or raises.  Each launch adds one to
:data:`launches`.
"""

from __future__ import annotations

import torch

from ..formats.ell import ELLMatrix
from . import sell_spmv as _sell

__all__ = ["ell_spmv", "ell_spmm", "ell_spmv_plain", "launches", "reset_launch_counts"]

_DTYPES = (torch.float32, torch.float64)

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"ell_spmv": 0, "ell_spmm": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def ell_spmv_plain(a: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """The planes' product: the first slot's product, then each later slot's
    product added in slot order, over the first ``n_rows`` rows."""
    n = a.shape[0]
    cols = a.cols[:n].long()
    acc = a.vals[:n, 0] * x[cols[:, 0]]
    for k in range(1, a.slots):
        acc = acc + a.vals[:n, k] * x[cols[:, k]]
    return acc


def _check(a: ELLMatrix, x: torch.Tensor, ndim: int) -> None:
    if a.vals.device != x.device:
        raise ValueError(f"ELL planes on {a.vals.device} but x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if a.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"planes ({a.dtype}) and x ({x.dtype}) must both be float32 "
                        "or both float64")
    if x.ndim != ndim or x.shape[0] != a.shape[1]:
        want = "(n_cols,)" if ndim == 1 else "(n_cols, k)"
        raise ValueError(f"x has shape {tuple(x.shape)}, expected {want} with "
                         f"n_cols={a.shape[1]}")
    if a.cols.dtype != torch.int32 or not (a.vals.is_contiguous() and a.cols.is_contiguous()
                                           and x.is_contiguous()):
        raise ValueError("the planes must be contiguous, cols int32, and x contiguous")


def ell_spmv(a: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """K6: y = A @ x for an ELL matrix and a length-``n_cols`` x."""
    _check(a, x, 1)
    if x.device.type == "cpu":
        return _sell.sell_spmv_plain(a.sell, x)
    y = _sell.launch(a.sell, x, "ell_spmv")
    launches["ell_spmv"] += 1
    return y


def ell_spmm(a: ELLMatrix, xs: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X of shape ``(n_cols, k)``: the panel kernel over the
    same layout (K8's), one launch per ``SPMM_COLUMNS`` columns."""
    _check(a, xs, 2)
    if xs.device.type == "cpu":
        return _sell.sell_spmm_plain(a.sell, xs)
    return _sell.spmm(a.sell, xs, "ell_spmm", launches)
