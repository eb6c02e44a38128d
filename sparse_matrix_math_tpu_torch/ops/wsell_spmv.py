"""W-SELL SpMV and SpMM: the Hopper kernels and the planes' plain version.

Port of ``sparse_matrix_math_tpu/ops/pallas_wsell.py``.  Both products
launch ``csrc/sell_spmv.cu`` (``ops/sell_spmv.py``; its header gives the
bytes model and design) over the matrix's slab-sorted SELL-32 layout
(``WSellMatrix.sell``), which holds the planes' live products in the order
below and skips their padding:

* :func:`wsell_spmv` (K7, TPU ``_wsell_kernel`` and ``_wsell_kernel_hbm``)
  — ``y = A @ x``, the kernel's K = 1 instantiation;
* :func:`wsell_spmm` (K8, TPU ``_wsell_spmm_kernel``) — ``Y = A @ X`` for
  ``X`` of shape ``(n_cols, k)``, one launch per :data:`SPMM_COLUMNS`
  columns, each slot read once per launch and applied to every column of
  the launch; column j equals K7's product of column j bit for bit.

* :func:`routed_spmv` and :func:`routed_spmm` — a ``RoutedMatrix``'s
  product: the same kernel over the routed chain folded into its final
  pass's layout (``RoutedMatrix.sell``, formats/rsell.py:fold_chain), one
  launch on x for a vector (in place of one K11 launch per routing pass,
  then K7), one per :data:`SPMM_COLUMNS` columns for a panel; counted
  under their own names.

Of the products, only :func:`wsell_spmm_plain` (and :func:`wsell_spmv_plain`)
reads the W-SELL planes: the planes' product, the tests' oracle.

Per vreg ``v`` and slot ``(p, L)`` (row ``8v + p`` and lane ``L`` of the
planes), with ``sw_bits = max(3, bitlen(8F - 1))``:

    m     = meta[8v + p, L]
    lsrc  = (m >> sw_bits) & 127
    sw    = meta[8v + p, lsrc] & (2**sw_bits - 1)
    prod  = vals[8v + p, L] * x[(base[v] + sw) * 128 + lsrc]   (x zero-padded)

With ``nway > 1`` the product of position ``p`` lands on sublane
``(p + shift) % 8``, ``shift = (m >> (sw_bits + 7)) & 7``: each output
sublane sums its own shift-0 product, then the rotated ones in rotation
order, exactly as ``_gather_products`` (pallas_wsell.py:75-86).  The slab's
rows then add the routed products of its vregs in ascending vreg order; the
planes' plain version follows that order.  The layout's plain version
(``sell_spmv_plain``, ``sell_spmm_plain``) sums the same products in the same
order without the padding, so it equals :func:`wsell_spmv_plain` and
:func:`wsell_spmm_plain` bit for bit for finite x, up to the sign of a zero
sum.

The TPU's VMEM-resident and HBM-streamed variants (``_VMEM_TABLE_BYTES``,
``force_hbm``, :202-262) are one kernel here: x is read through the 50 MB L2.
A wrapper given CPU tensors runs its kernel's plain version; given CUDA
tensors it launches the kernel or raises.  Each launch adds one to :data:`launches`.
"""

from __future__ import annotations

import torch

from ..formats.rsell import RoutedMatrix
from ..formats.sell import SellMatrix
from ..formats.wsell import LANE, SLAB, WSellMatrix
from . import sell_spmv as _sell

__all__ = ["wsell_spmv", "wsell_spmm", "wsell_spmv_plain", "wsell_spmm_plain", "routed_spmv",
           "routed_spmm", "launches", "reset_launch_counts", "SPMM_COLUMNS"]

SPMM_COLUMNS = _sell.SPMM_COLUMNS  # columns per K8 launch
_DTYPES = (torch.float32, torch.float64)

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"wsell_spmv": 0, "wsell_spmm": 0, "routed_spmv": 0, "routed_spmm": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sw_bits(a: WSellMatrix) -> int:
    return max(3, (8 * a.window_f - 1).bit_length())


# -- plain version -------------------------------------------------------------


def wsell_spmm_plain(a: WSellMatrix, xs: torch.Tensor) -> torch.Tensor:
    """Plain K8 (and the planes' K7 order) for ``xs`` of shape ``(n_cols,
    k)``: the kernel's index math and summation order, in PyTorch ops;
    returns ``(n_rows, k)``."""
    n_rows, n_cols = a.shape
    k = xs.shape[1]
    v = a.n_vregs
    sw_bits = _sw_bits(a)
    xt = torch.zeros((a.x_rows * LANE, k), dtype=xs.dtype, device=xs.device)
    xt[:n_cols] = xs
    meta = a.meta.reshape(v, 8, LANE).to(torch.int64)
    lsrc = (meta >> sw_bits) & (LANE - 1)
    sw = torch.gather(meta, 2, lsrc) & ((1 << sw_bits) - 1)
    col = (a.base.to(torch.int64).reshape(v, 1, 1) + sw) * LANE + lsrc
    prod = a.vals.reshape(v, 8, LANE, 1) * xt[col]  # (v, 8, 128, k)
    if a.nway > 1:
        shift = ((meta >> (sw_bits + 7)) & 7).unsqueeze(-1)
        step = 8 // a.nway
        out = torch.where(shift == 0, prod, 0)
        for j in range(1, a.nway):
            masked = torch.where(shift == j * step, prod, 0)
            out = out + torch.roll(masked, j * step, dims=1)  # p -> (p + s) % 8
        prod = out
    # each slab adds its vregs' contributions in ascending vreg order
    ptr = a.slab_ptr.to(torch.int64)
    counts = ptr[1:] - ptr[:-1]
    y = torch.zeros((a.n_slabs, 8, LANE, k), dtype=prod.dtype, device=prod.device)
    for i in range(int(counts.max()) if a.n_slabs else 0):
        slabs = torch.nonzero(counts > i).squeeze(1)
        y[slabs] = y[slabs] + prod[ptr[slabs] + i]
    return y.reshape(a.n_slabs * SLAB, k)[:n_rows]


def wsell_spmv_plain(a: WSellMatrix, x: torch.Tensor) -> torch.Tensor:
    """The planes' product of one column: :func:`wsell_spmm_plain`."""
    return wsell_spmm_plain(a, x.unsqueeze(1)).squeeze(1)


# -- wrappers ------------------------------------------------------------------


def _check(a, x: torch.Tensor, ndim: int, what: str = "W-SELL planes") -> None:
    """``a``: a WSellMatrix, or the SellMatrix a routed product reads."""
    if a.vals.device != x.device:
        raise ValueError(f"{what} on {a.vals.device} but x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if a.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"planes ({a.dtype}) and x ({x.dtype}) must both be float32 "
                        "or both float64")
    if x.ndim != ndim or x.shape[0] != a.shape[1]:
        want = "(n_cols,)" if ndim == 1 else "(n_cols, k)"
        raise ValueError(f"x has shape {tuple(x.shape)}, expected {want} with "
                         f"n_cols={a.shape[1]}")
    planes = (a.vals, a.cols) if isinstance(a, SellMatrix) else (a.vals, a.meta)
    if not all(t.is_contiguous() for t in (*planes, x)):
        raise ValueError("planes and x must be contiguous")


def _spmv(s: SellMatrix, x: torch.Tensor, what: str) -> torch.Tensor:
    if x.device.type == "cpu":
        return _sell.sell_spmv_plain(s, x)
    y = _sell.launch(s, x, what)
    launches[what] += 1
    return y


def _spmm(s: SellMatrix, xs: torch.Tensor, what: str) -> torch.Tensor:
    if xs.device.type == "cpu":
        return _sell.sell_spmm_plain(s, xs)
    return _sell.spmm(s, xs, what, launches)


def wsell_spmv(a: WSellMatrix, x: torch.Tensor) -> torch.Tensor:
    """K7: y = A @ x for a W-SELL matrix and a length-``n_cols`` x."""
    _check(a, x, 1)
    return _spmv(a.sell, x, "wsell_spmv")


def wsell_spmm(a: WSellMatrix, xs: torch.Tensor) -> torch.Tensor:
    """K8: Y = A @ X for X of shape ``(n_cols, k)``; one launch per
    :data:`SPMM_COLUMNS` columns."""
    _check(a, xs, 2)
    return _spmm(a.sell, xs, "wsell_spmm")


def routed_spmv(a: RoutedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a routed matrix: one launch over its folded layout."""
    _check(a.sell, x, 1, "routed layout")
    return _spmv(a.sell, x, "routed_spmv")


def routed_spmm(a: RoutedMatrix, xs: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for a routed matrix and X of shape ``(n_cols, k)``: one
    launch over its folded layout per :data:`SPMM_COLUMNS` columns."""
    _check(a.sell, xs, 2, "routed layout")
    return _spmm(a.sell, xs, "routed_spmm")
