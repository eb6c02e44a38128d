"""The slab-sorted SELL-32 products: the Hopper kernel behind K6, K7 and K8.

``csrc/sell_spmv.cu`` (its header gives the bytes model and the design)
computes ``y = A @ x`` and, for 2..8 columns per launch, ``Y = A @ X`` over
a :class:`~..formats.sell.SellMatrix`, the layout an ``ELLMatrix`` or a
``WSellMatrix`` carries beside its planes.  It replaces TPU ``_ell_kernel``
(``ops/pallas_spmv.py:392``), ``_wsell_kernel``/``_wsell_kernel_hbm``
(``ops/pallas_wsell.py:89/119``) and ``_wsell_spmm_kernel``
(``ops/pallas_wsell.py:165``).  The wrappers ``ell_spmv`` (K6),
``wsell_spmv`` (K7), ``wsell_spmm`` (K8) and ``ell_spmm`` launch it through
:func:`launch` and :func:`spmm` and count their launches; on the CPU they
run :func:`sell_spmv_plain` and :func:`sell_spmm_plain`.
"""

from __future__ import annotations

import torch

from ..formats.sell import CHUNK, SLAB, SellMatrix, column_words

__all__ = ["sell_spmv_plain", "sell_spmm_plain", "launch", "spmm", "SPMM_COLUMNS"]

# Columns per panel launch: the kernel is instantiated for 1..8 (the TPU's
# 8-column cap came from its VMEM budget, pallas_wsell.py:278-283).  Eight
# columns keep each thread's 16 running values inside the register bound
# the panel build asks for (csrc/sell_spmv.cu, PanelShape).
SPMM_COLUMNS = 8
# the kernel reads and writes a row of X and Y as 16 B vectors
_ALIGN = 16


def sell_spmm_plain(s: SellMatrix, xs: torch.Tensor) -> torch.Tensor:
    """Plain version for ``xs`` of shape ``(n_cols, k)``: per row and column
    ``acc = 0``, then ``acc + term`` for each term, a term its first product
    plus each continuing product, in slot order, with the kernel's index
    math; returns ``(n_rows, k)``."""
    k = xs.shape[1]
    ptr = s.chunk_ptr
    widths = ptr[1:] - ptr[:-1]
    vals = s.vals.view(-1, CHUNK)
    cols = s.cols.view(-1, CHUNK)
    n_chunks = widths.shape[0]
    acc = torch.zeros((n_chunks, CHUNK, k), dtype=s.dtype, device=s.device)
    term = torch.zeros_like(acc)
    for t in range(int(widths.max()) if s.n_slots else 0):
        ch = torch.nonzero(widths > t).squeeze(1)
        at = ptr[ch] + t
        col, cont = column_words(cols[at])
        prod = vals[at].unsqueeze(-1) * xs[col]
        cont = cont.unsqueeze(-1)
        a, tm = acc[ch], term[ch]
        acc[ch] = torch.where(cont, a, a + tm)
        term[ch] = torch.where(cont, tm + prod, prod)
    placed = (acc + term).view(-1, k)
    y = torch.empty((s.n_slabs * SLAB, k), dtype=s.dtype, device=s.device)
    slab0 = torch.arange(s.n_slabs, device=s.device).repeat_interleave(SLAB) * SLAB
    y[slab0 + s.row_of.to(torch.int64)] = placed
    return y[:s.shape[0]]


def sell_spmv_plain(s: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain version of one column: :func:`sell_spmm_plain` of ``x`` as a
    one-column panel (every product and sum is the same elementwise op)."""
    return sell_spmm_plain(s, x.unsqueeze(1)).squeeze(1)


def launch(s: SellMatrix, x: torch.Tensor, what: str) -> torch.Tensor:
    """One launch of the kernel on ``x``'s card for ``x`` of shape
    ``(n_cols,)`` (K = 1) or ``(n_cols, k <= 8)``; ``what`` names the wrapper
    in an error.  The caller has checked device, shape and contiguity, and
    for k > 1 16 B alignment."""
    from . import _build

    if s.dtype != x.dtype:
        raise TypeError(f"{what}: layout ({s.dtype}) and x ({x.dtype}) differ in type")
    lib = _build.library()
    fn = lib.smm_sell_spmm_f32 if x.dtype == torch.float32 else lib.smm_sell_spmm_f64
    y = torch.empty((s.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(s.vals.data_ptr(), s.cols.data_ptr(), s.chunk_ptr.data_ptr(),
                  s.row_of.data_ptr(), x.data_ptr(), y.data_ptr(), s.n_slabs, s.shape[0],
                  1 if x.ndim == 1 else x.shape[1], torch.cuda.current_stream().cuda_stream)
    _build.check(code, what)
    return y


def spmm(s: SellMatrix, xs: torch.Tensor, what: str, counts: dict) -> torch.Tensor:
    """``Y = A @ X`` on ``xs``'s card for ``xs`` of shape ``(n_cols, k)``:
    one launch per :data:`SPMM_COLUMNS` columns, each adding one to
    ``counts[what]``.  The caller has checked device, shape and contiguity."""
    k = xs.shape[1]
    # past 8 columns each launch writes a fresh part, copied into its place
    ys = xs.new_empty((s.shape[0], k)) if k == 0 or k > SPMM_COLUMNS else None
    for j0 in range(0, k, SPMM_COLUMNS):
        part = xs[:, j0:j0 + SPMM_COLUMNS]
        if not part.is_contiguous() or part.data_ptr() % _ALIGN:
            # a fresh allocation: contiguous and aligned
            part = part.clone(memory_format=torch.contiguous_format)
        y = launch(s, part, what)
        counts[what] += 1
        if ys is None:
            return y
        ys[:, j0:j0 + part.shape[1]] = y
    return ys
