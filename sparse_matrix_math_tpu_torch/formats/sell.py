"""Slab-sorted SELL-32: the card-native layout that K6 and K7 read.

Derived once, with the matrix, from an ELL or W-SELL matrix's own planes and
carried beside them (``ELLMatrix.sell``, ``WSellMatrix.sell``); the planes
stay as the JAX package builds them, and K8 and the double-word paths go on
reading those.  The layout holds only a row's **terms**, in the order the
planes' kernels sum them:

* ELL: the live slots ``k < row_nnz`` of the row, in ascending ``k``;
* W-SELL: per vreg of the row's slab, in ascending vreg order, the routed
  products that reach the row's (sublane, lane) from that vreg.  With
  ``nway > 1`` one vreg can route up to ``nway`` products to a row, the
  shift-0 product first, then the rotated ones in rotation order
  (JAX ``pallas_wsell.py:_gather_products``); they stay one term, summed
  first, and every product after the first of a term carries :data:`CONT`
  in its column word.

Padding is what the builder placed as padding (ELL's slots past
``row_nnz``, W-SELL's slots that hold no nonzero), not every value 0: a
stored zero stays a term.

Rows are cut into 1024-row slabs (W-SELL's slab; for ELL, 1024-row
windows).  Inside a slab, rows are sorted by term count, longest first
(stable), and cut into 32-row chunks, one warp each.  A chunk is stored
slot-major: slot ``t`` of the chunk's 32 rows is 32 consecutive values and
32 consecutive int32 column words, at ``(chunk_ptr[c] + t) * 32``.  A chunk
is as wide as its longest row; padding slots hold value 0 and column 0.
``row_of`` maps each sorted place back to its row within the slab.

The product (``ops/sell_spmv.py``, kernel ``csrc/sell_spmv.cu``) sums, per
row, ``acc = 0``, then ``acc + term`` for each term in order, a term being
its first product plus each continuing product in order.  That is the
planes' order, so it equals the planes' product bit for bit for finite x.
The deviations: the sign of a zero sum (ELL's planes add the padding's
``0 * x[0]`` after a row's sum), and a non-finite x at a column that only
padding reads, since the planes' padding slots read other columns than this
layout's, which read ``x[0]`` (``0 * inf`` is NaN in both).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["SellMatrix", "CONT", "SLAB", "CHUNK", "sell_from_ell", "sell_from_wsell",
           "wsell_products", "column_words"]

SLAB = 1024       # rows per slab: one block of the kernel
CHUNK = 32        # rows per chunk: one warp
CONT = 1 << 31    # column-word bit: this product continues the previous term
_COL_MASK = CONT - 1


@dataclasses.dataclass(frozen=True)
class SellMatrix:
    """Slab-sorted SELL-32 (see the module docstring for the layout)."""

    vals: torch.Tensor       # (slots,) chunk after chunk, slot-major inside one
    cols: torch.Tensor       # (slots,) int32 column | CONT
    chunk_ptr: torch.Tensor  # (n_slabs * 32 + 1,) int64, in 32-slot rows
    row_of: torch.Tensor     # (n_slabs * 1024,) int16: sorted place -> row in slab
    shape: Tuple[int, int]
    n_slabs: int
    nnz: int                 # the matrix's stored entries

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_slots(self) -> int:
        return int(self.vals.shape[0])

    @property
    def slots_per_nonzero(self) -> float:
        """Slots read per stored entry (W-SELL's ``slot_ratio`` beside it)."""
        return self.n_slots / max(self.nnz, 1)

    @property
    def device_bytes(self) -> int:
        """Bytes this layout adds on the device beside the planes."""
        return sum(t.numel() * t.element_size()
                   for t in (self.vals, self.cols, self.chunk_ptr, self.row_of))

    def astype(self, dtype: torch.dtype) -> "SellMatrix":
        return dataclasses.replace(self, vals=self.vals.to(dtype))


def _from_terms(out_row: torch.Tensor, val: torch.Tensor, col: torch.Tensor,
                cont: Optional[torch.Tensor], shape: Tuple[int, int], nnz: int) -> SellMatrix:
    """The layout of products given in row order (``out_row`` nondecreasing,
    a row's products in summation order); ``cont`` marks the products that
    continue the previous one's term (None: none does)."""
    dev = val.device
    n_rows = int(shape[0])
    n_slabs = max(-(-n_rows // SLAB), 1)
    counts = torch.bincount(out_row, minlength=n_slabs * SLAB)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(out_row.shape[0], device=dev) - starts[out_row]
    # each slab's rows by count, longest first; equal counts keep row order
    order = torch.sort(-counts.view(n_slabs, SLAB), dim=1, stable=True).indices
    place = torch.empty_like(order)
    place.scatter_(1, order, torch.arange(SLAB, device=dev).expand(n_slabs, SLAB))
    widths = counts.view(n_slabs, SLAB).gather(1, order)[:, ::CHUNK].reshape(-1)
    chunk_ptr = torch.zeros(n_slabs * (SLAB // CHUNK) + 1, dtype=torch.int64, device=dev)
    chunk_ptr[1:] = torch.cumsum(widths, 0)
    n_slots = int(chunk_ptr[-1]) * CHUNK  # the one host read: the planes' size
    at = place.view(-1)[out_row]  # sorted place within the slab
    chunk = (out_row // SLAB) * (SLAB // CHUNK) + at // CHUNK
    dest = (chunk_ptr[chunk] + rank) * CHUNK + at % CHUNK
    vals = torch.zeros(n_slots, dtype=val.dtype, device=dev)
    vals[dest] = val
    word = col.to(torch.int64)
    if cont is not None:
        word = word - cont.to(torch.int64) * CONT  # bit 31 of the int32 word
    cols = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    cols[dest] = word.to(torch.int32)
    return SellMatrix(vals=vals, cols=cols, chunk_ptr=chunk_ptr,
                      row_of=order.to(torch.int16).reshape(-1), shape=(n_rows, int(shape[1])),
                      n_slabs=n_slabs, nnz=int(nnz))


def sell_from_ell(vals: torch.Tensor, cols: torch.Tensor, shape: Tuple[int, int], nnz: int,
                  row_nnz: Optional[torch.Tensor] = None) -> SellMatrix:
    """The layout of ELL planes ``(rows_padded, K)``.  ``row_nnz`` gives each
    row's live slots; without it, a row's live slots end before its trailing
    run of slots holding value 0 and column 0."""
    n_rows = int(shape[0])
    v, c = vals[:n_rows], cols[:n_rows]
    k = v.shape[1]
    if row_nnz is None:
        pad = ((v == 0) & (c == 0)).flip(1).to(torch.int32)
        row_nnz = k - torch.cumprod(pad, dim=1).sum(1)
    live = torch.arange(k, device=v.device) < row_nnz[:n_rows].to(v.device).unsqueeze(1)
    i, slot = torch.nonzero(live, as_tuple=True)  # row-major: rows, then ascending k
    return _from_terms(i, v[i, slot], c[i, slot], None, shape, nnz)


def wsell_products(vals: torch.Tensor, meta: torch.Tensor, base: torch.Tensor,
                   slab: torch.Tensor, sw_bits: int, nway: int,
                   live: Optional[torch.Tensor] = None):
    """The live products of W-SELL planes in summation order: (row, column,
    value, continues-the-term) per product, rows nondecreasing.  ``live``
    (``vals``' shape, bool) marks the slots that hold a nonzero, as the
    builder placed them; without it a slot is live when its value, LSRC or
    SHIFT is not 0 (padding slots hold all three 0, so only a stored zero
    read through lane 0 of its window with shift 0 is then taken for
    padding)."""
    if live is None:
        live = (vals != 0) | ((meta >> sw_bits) != 0)
    flat_meta = meta.reshape(-1)
    idx = torch.nonzero(live.reshape(-1)).squeeze(1)  # (8v + p) * 128 + lane
    lane = idx % 128
    row8 = idx // 128
    v, p = row8 // 8, row8 % 8
    m = flat_meta[idx].to(torch.int64)
    lsrc = (m >> sw_bits) & 127
    sw = flat_meta[row8 * 128 + lsrc].to(torch.int64) & ((1 << sw_bits) - 1)
    col = (base.to(torch.int64)[v] + sw) * 128 + lsrc
    shift = (m >> (sw_bits + 7)) & 7 if nway > 1 else torch.zeros_like(m)
    out_row = slab.to(torch.int64)[v] * SLAB + ((p + shift) % 8) * 128 + lane
    turn = shift // (8 // nway)  # rotation order inside the vreg
    order = torch.sort((out_row * int(base.shape[0]) + v) * 8 + turn).indices
    out_row, v = out_row[order], v[order]
    cont = torch.zeros_like(out_row, dtype=torch.bool)
    cont[1:] = (out_row[1:] == out_row[:-1]) & (v[1:] == v[:-1])
    return out_row, col[order], vals.reshape(-1)[idx[order]], cont


def sell_from_wsell(vals: torch.Tensor, meta: torch.Tensor, base: torch.Tensor,
                    slab: torch.Tensor, shape: Tuple[int, int], nnz: int, sw_bits: int,
                    nway: int, live: Optional[torch.Tensor] = None) -> SellMatrix:
    """The layout of W-SELL planes (``live`` as :func:`wsell_products`)."""
    out_row, col, val, cont = wsell_products(vals, meta, base, slab, sw_bits, nway, live)
    return _from_terms(out_row, val, col, cont, shape, nnz)


def column_words(cols: torch.Tensor):
    """(column, continues-the-term) of the int32 column words."""
    return (cols & _COL_MASK).to(torch.int64), cols < 0
