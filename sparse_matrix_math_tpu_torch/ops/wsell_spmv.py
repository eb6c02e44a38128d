"""W-SELL SpMV and SpMM: the Hopper kernels and their plain versions.

Port of ``sparse_matrix_math_tpu/ops/pallas_wsell.py``.  Two kernels (each
header gives its bytes model and design):

* :func:`wsell_spmv` (K7, TPU ``_wsell_kernel`` and ``_wsell_kernel_hbm``)
  — ``y = A @ x``, ``csrc/sell_spmv.cu`` (``ops/sell_spmv.py``) over the
  matrix's slab-sorted SELL-32 layout (``WSellMatrix.sell``), which holds
  the planes' live products in the order below and skips their padding;
* :func:`wsell_spmm` (K8, TPU ``_wsell_spmm_kernel``) — ``Y = A @ X`` for
  ``X`` of shape ``(n_cols, k)``, ``csrc/wsell_spmv.cu`` over the planes,
  each slot read once per launch and applied to up to
  :data:`SPMM_COLUMNS` columns.

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
rows then add the routed products of its vregs in ascending vreg order.  The
plain versions follow that order, and the kernels round each product and sum
alone, so the two agree bit for bit.  The layout's plain version
(``sell_spmv_plain``) sums the same products in the same order without the
padding, so it equals :func:`wsell_spmv_plain` bit for bit for finite x, up
to the sign of a zero sum.

The TPU's VMEM-resident and HBM-streamed variants (``_VMEM_TABLE_BYTES``,
``force_hbm``, :202-262) are one kernel here: x is read through the 50 MB L2.
A wrapper given CPU tensors runs its kernel's plain version; given CUDA
tensors it launches the kernel or raises.  Each launch adds one to :data:`launches`.
"""

from __future__ import annotations

import torch

from ..formats.wsell import LANE, SLAB, WSellMatrix
from . import sell_spmv as _sell

__all__ = ["wsell_spmv", "wsell_spmm", "wsell_spmv_plain", "wsell_spmm_plain",
           "launches", "reset_launch_counts", "SPMM_COLUMNS"]

# Columns per K8 launch.  Each thread keeps two output rows' sums of every
# column of the launch in registers; eight columns of float64 stay inside
# the register budget of a 512-thread block (the TPU's 8-column cap came
# from its VMEM budget instead, pallas_wsell.py:278-283).
SPMM_COLUMNS = 8
_DTYPES = (torch.float32, torch.float64)

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"wsell_spmv": 0, "wsell_spmm": 0}


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


def _check(a: WSellMatrix, x: torch.Tensor, ndim: int) -> None:
    if a.vals.device != x.device:
        raise ValueError(f"W-SELL planes on {a.vals.device} but x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if a.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"planes ({a.dtype}) and x ({x.dtype}) must both be float32 "
                        "or both float64")
    if x.ndim != ndim or x.shape[0] != a.shape[1]:
        want = "(n_cols,)" if ndim == 1 else "(n_cols, k)"
        raise ValueError(f"x has shape {tuple(x.shape)}, expected {want} with "
                         f"n_cols={a.shape[1]}")
    if not (a.vals.is_contiguous() and a.meta.is_contiguous() and x.is_contiguous()):
        raise ValueError("planes and x must be contiguous")


def _launch(a: WSellMatrix, x: torch.Tensor, y: torch.Tensor, k: int) -> None:
    """One K8 launch over row-major x (n_cols, k) into y (n_rows, k)."""
    from . import _build

    lib = _build.library()
    fn = lib.smm_wsell_spmm_f32 if x.dtype == torch.float32 else lib.smm_wsell_spmm_f64
    with torch.cuda.device(x.device):
        code = fn(a.vals.data_ptr(), a.meta.data_ptr(), a.base.data_ptr(),
                  a.slab_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), a.n_slabs,
                  a.shape[0], a.shape[1], k, _sw_bits(a), a.nway,
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "wsell_spmm")
    launches["wsell_spmm"] += 1


def wsell_spmv(a: WSellMatrix, x: torch.Tensor) -> torch.Tensor:
    """K7: y = A @ x for a W-SELL matrix and a length-``n_cols`` x."""
    _check(a, x, 1)
    if x.device.type == "cpu":
        return _sell.sell_spmv_plain(a.sell, x)
    y = _sell.launch(a.sell, x, "wsell_spmv")
    launches["wsell_spmv"] += 1
    return y


def wsell_spmm(a: WSellMatrix, xs: torch.Tensor) -> torch.Tensor:
    """K8: Y = A @ X for X of shape ``(n_cols, k)``; one launch per
    :data:`SPMM_COLUMNS` columns."""
    _check(a, xs, 2)
    if xs.device.type == "cpu":
        return wsell_spmm_plain(a, xs)
    k = xs.shape[1]
    ys = torch.empty((a.shape[0], k), dtype=xs.dtype, device=xs.device)
    for j0 in range(0, k, SPMM_COLUMNS):
        kc = min(SPMM_COLUMNS, k - j0)
        x_part = xs[:, j0:j0 + kc].contiguous()
        y_part = ys if kc == k else torch.empty((a.shape[0], kc), dtype=xs.dtype,
                                                device=xs.device)
        _launch(a, x_part, y_part, kc)
        if y_part is not ys:
            ys[:, j0:j0 + kc] = y_part
    return ys
