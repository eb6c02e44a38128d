"""The slab-sorted SELL-32 product: the Hopper kernel behind K6 and K7 (k = 1).

``csrc/sell_spmv.cu`` (its header gives the bytes model and the design)
computes ``y = A @ x`` over a :class:`~..formats.sell.SellMatrix`, the layout
an ``ELLMatrix`` or a ``WSellMatrix`` carries beside its planes.  It replaces
TPU ``_ell_kernel`` (``ops/pallas_spmv.py:392``) and the k = 1 use of
``_wsell_kernel``/``_wsell_kernel_hbm`` (``ops/pallas_wsell.py:89/119``).
The wrappers ``ell_spmv`` (K6) and ``wsell_spmv`` (K7) launch it through
:func:`launch` and count their launches; on the CPU they run
:func:`sell_spmv_plain`.
"""

from __future__ import annotations

import torch

from ..formats.sell import CHUNK, SLAB, SellMatrix, column_words

__all__ = ["sell_spmv_plain", "launch"]


def sell_spmv_plain(s: SellMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain version: per row ``acc = 0``, then ``acc + term`` for each term,
    a term its first product plus each continuing product, in slot order,
    with the kernel's index math."""
    ptr = s.chunk_ptr
    widths = ptr[1:] - ptr[:-1]
    vals = s.vals.view(-1, CHUNK)
    cols = s.cols.view(-1, CHUNK)
    n_chunks = widths.shape[0]
    acc = torch.zeros((n_chunks, CHUNK), dtype=s.dtype, device=s.device)
    term = torch.zeros_like(acc)
    for t in range(int(widths.max()) if s.n_slots else 0):
        ch = torch.nonzero(widths > t).squeeze(1)
        at = ptr[ch] + t
        col, cont = column_words(cols[at])
        prod = vals[at] * x[col]
        a, tm = acc[ch], term[ch]
        acc[ch] = torch.where(cont, a, a + tm)
        term[ch] = torch.where(cont, tm + prod, prod)
    placed = (acc + term).view(-1)
    y = torch.empty(s.n_slabs * SLAB, dtype=s.dtype, device=s.device)
    slab0 = torch.arange(s.n_slabs, device=s.device).repeat_interleave(SLAB) * SLAB
    y[slab0 + s.row_of.to(torch.int64)] = placed
    return y[:s.shape[0]]


def launch(s: SellMatrix, x: torch.Tensor, what: str) -> torch.Tensor:
    """One launch of the kernel on ``x``'s card; ``what`` names the wrapper
    in an error.  The caller has checked device, type, shape and contiguity."""
    from . import _build

    if s.dtype != x.dtype:
        raise TypeError(f"{what}: layout ({s.dtype}) and x ({x.dtype}) differ in type")
    lib = _build.library()
    fn = lib.smm_sell_spmv_f32 if x.dtype == torch.float32 else lib.smm_sell_spmv_f64
    y = torch.empty(s.shape[0], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        code = fn(s.vals.data_ptr(), s.cols.data_ptr(), s.chunk_ptr.data_ptr(),
                  s.row_of.data_ptr(), x.data_ptr(), y.data_ptr(), s.n_slabs, s.shape[0],
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, what)
    return y
