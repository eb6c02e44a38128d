"""R-SELL: the routed sliced-ELL layout for patterns with no tile locality.

Port of ``sparse_matrix_math_tpu/formats/rsell.py`` (the whole file).  W-SELL
(formats/wsell.py) serves a pattern whose (row slab x column window) tiles
are reasonably dense.  Uniform-random columns at low density leave about one
nonzero per tile under any renumbering, so every windowed layout pads by the
bucket fan-out.  R-SELL reaches such a pattern by routing: the product runs a
chain of gather passes, each refining the destination by one mixed-radix
digit of the row slab,

    stream_0 = x
    stream_i = gather(stream_{i-1})       routing pass i (ops/stream_gather.py, K11)
    y        = W-SELL(final, stream_K)    multiply and slab-accumulate (K7)

Each pass emits the entries' source values reordered by one more digit of
their DESTINATION row, sorted by current position within each bucket, so the
1024 sources of every output vreg span one contiguous aligned window stack of
``8 * window_f`` rows of the input.  Every routing index is computed at build
time on the host, by the same NumPy code as the JAX package or the same
native routines (``smm_native.cpp``, bound by ``native.py``), so a matrix gets
the JAX package's planes bit for bit; the planes then live on the CSR's
device.

The slot assignment of a pass meets the W-SELL constraints per vreg: one
element per (row, out lane), one window row per (row, source lane).  The
closed-form packer :func:`_pack_pass` meets both and keeps the next pass's
per-lane histograms flat.

The chain exists because a TPU cannot gather anywhere in HBM; a card reads
x through its 50 MB L2.  Every routing pass only moves values (its slots
hold 1.0, or 0 in padding), so slot j of the last stream holds exactly
``x[c(j)]``, c the composition of the passes' source maps.  ``RoutedMatrix.sell``
(not a JAX field) is the chain folded once per matrix (:func:`fold_chain`):
the final pass's slab-sorted SELL-32 layout with each column word j
rewritten to c(j), so a product is one launch of the SELL kernel over x
(ops/spmv.py), with the chain's terms in the chain's order.  The passes and
the final planes stay as the JAX package builds them;
``ops/spmv.py:routed_chain_rmult`` still runs the chain itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .csr import CSRMatrix
from .sell import CONT, SellMatrix, column_words
from .wsell import (
    LANE,
    SLAB,
    WSellMatrix,
    _distinct_rank,
    _group_rank,
    _pack_keys,
    _round_up,
    _wsell_from_coo,
    chunk_for,
)

__all__ = ["StreamPass", "RoutedMatrix", "fold_chain", "routed_from_csr", "try_routed_from_csr"]


@dataclasses.dataclass(frozen=True)
class StreamPass:
    """One routing pass: the planes :func:`~..ops.stream_gather.stream_gather`
    takes."""

    vals: torch.Tensor   # (V*8, 128) 1.0 at real slots, 0 in padding
    meta: torch.Tensor   # (V*8, 128) int32 packed SW | LSRC (the W-SELL packing)
    base: torch.Tensor   # (V,) int32 window-stack base row into the input table
    x_rows: int          # rows of 128 the input table pads to
    window_f: int

    @property
    def n_vregs(self) -> int:
        return int(self.base.shape[0])

    @property
    def out_len(self) -> int:
        return self.n_vregs * SLAB

    def astype(self, dtype: torch.dtype) -> "StreamPass":
        return dataclasses.replace(self, vals=self.vals.to(dtype))


@dataclasses.dataclass(frozen=True)
class RoutedMatrix:
    """Routed sliced-ELL sparse matrix (see the module docstring)."""

    passes: Tuple[StreamPass, ...]
    final: WSellMatrix
    shape: Tuple[int, int]
    nnz: int
    slot_ratio: float  # slots the chain moves per product (routing streams + final layout) / nnz
    # the product's layout: the chain folded into ``final.sell`` (fold_chain),
    # derived here when not given
    sell: Optional[SellMatrix] = None

    def __post_init__(self):
        if self.sell is None:
            object.__setattr__(self, "sell", fold_chain(self.passes, self.final, self.shape))

    @property
    def dtype(self) -> torch.dtype:
        return self.final.dtype

    @property
    def device(self) -> torch.device:
        return self.final.device

    def astype(self, dtype: torch.dtype) -> "RoutedMatrix":
        # the fold's column words stay; its values are the cast final layout's
        final = self.final.astype(dtype)
        sell = dataclasses.replace(final.sell, cols=self.sell.cols, shape=self.sell.shape)
        return dataclasses.replace(self, passes=tuple(p.astype(dtype) for p in self.passes),
                                   final=final, sell=sell)

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        """Densify by probing with the identity (test and debug sizes only)."""
        eye = torch.eye(self.shape[1], dtype=self.dtype, device=self.device)
        return self.rmult(eye)


def fold_chain(passes: Tuple[StreamPass, ...], final: WSellMatrix,
               shape: Tuple[int, int]) -> SellMatrix:
    """The routed product's layout: ``final.sell`` (its values, chunk pointers
    and row map shared) with each column word j, an index into the last
    stream, rewritten to c(j), the column of x that stream slot carries
    (``ops/stream_gather.py:stream_sources``, the chain run once over an
    index table), the ``CONT`` bit kept; shape ``shape``, A's.

    A product over it sums the chain's terms in the chain's order, each
    ``v * x[c(j)]`` where the chain forms ``v * (1.0 * ... * 1.0 * x[c(j)])``:
    bit for bit the chain's product.  What the fold changes is what no live
    term reads: a slot the chain left as padding in its last stream reads
    as column 0, so a padding slot of the layout (value 0) reads ``x[0]`` or
    ``x[c(0)]`` where the chain read a padding 0, which differs only for a
    non-finite x there (``0 * inf`` is NaN), as ``formats/sell.py`` says of
    its own padding.  Raises ValueError when a pass holds a value other than
    1 or 0 (it would not only move values), or when a live term, a slot
    with a value or a column word not 0, reads a padding slot of the stream
    (a sound chain never does: the chain would give 0 there)."""
    from ..ops.stream_gather import stream_sources

    for i, p in enumerate(passes):
        if not bool(((p.vals == 0) | (p.vals == 1)).all()):
            raise ValueError(f"routing pass {i} holds values other than 1 and 0: it does not "
                             "only move values, so the chain cannot be folded")
    s = final.sell
    source = stream_sources(passes, int(shape[1]), s.device)
    col, cont = column_words(s.cols)
    c = source[col]
    if bool(((c < 0) & ((s.vals != 0) | (s.cols != 0))).any()):
        raise ValueError("a live term of the routed chain's final pass reads a padding slot "
                         "of the last stream")
    word = c.clamp_min(0) - cont.to(torch.int64) * CONT  # bit 31 of the int32 word
    return dataclasses.replace(s, cols=word.to(torch.int32),
                               shape=(int(shape[0]), int(shape[1])))


# -- stream-pass packer ----------------------------------------------------------


def _pack_pass(group, sigma, lam, nd, pos, wrows):
    """Closed-form packing of one routing pass.

    Within a (bucket, window stack) group, element (sigma, lam) gets

      row  = rank of its sigma among the DISTINCT sigmas at its source lane
             lam (duplicated sources share the rank),
      lane = (rank * 67 + (row + group) * 53) % 128, with rank counted within
             the (group, row) in (next digit, position) order.

    Each (row, source lane) then carries one window row, and the stride 67,
    coprime to 128, makes the ranks of a row a lane bijection.  A next-level
    bucket's elements hold a consecutive rank range per row, which the stride
    spreads over all 128 lanes, so the next pass packs at ~count/128 rows.
    A row holds at most 128 elements unless duplicated sources share a rank;
    the loop re-ranks that excess into fresh rows.

    The native packer (``smm_stream_pack_cf``) computes the same layout in
    linear time; this NumPy version is the fallback and the specification.

    Returns (row_in_group, out_lane, rows_per_group)."""
    if group.size:
        packed = native.stream_pack_cf(group, sigma, lam, nd, wrows)
        if packed is not None:
            return packed
    n_groups = int(group[-1]) + 1 if group.size else 0
    key_gl = _pack_keys((group, lam), (0, 7))
    row = _distinct_rank(key_gl, sigma, val_bits=7)
    out_lane = np.zeros_like(row)
    rows_per_group = np.zeros(n_groups, np.int64)
    live = np.ones(row.shape[0], bool)
    for _ in range(64):
        # lane = rank within (group, row) in (next-digit, pos) order
        order = np.argsort(_pack_keys((group, row, nd, pos), (0, 10, 7, 26)), kind="stable")
        kr = _pack_keys((group, row), (0, 10))
        lane_sorted = _group_rank(kr[order])
        rank = np.empty_like(lane_sorted)
        rank[order] = lane_sorted
        fits = rank < LANE
        lane = (rank * 67 + (row + group) * 53) % LANE
        out_lane = np.where(live & fits, lane, out_lane)
        done = live & fits
        if rows_per_group.size:
            np.maximum.at(rows_per_group, group[done], row[done] + 1)
        live = live & ~fits
        if not live.any():
            break
        # overflow (duplicate-heavy rows): re-rank the excess into rows past
        # the group's current maximum
        base = rows_per_group[group[live]]
        sub = _distinct_rank(key_gl[live], sigma[live], val_bits=7)
        row = row.copy()
        row[live] = base + sub
    else:
        raise ValueError("R-SELL packer did not converge (duplicate flood)")
    return row, out_lane, rows_per_group


def _build_stream_pass(pos, bucket, nd, table_len, window_f, dtype, device, grouped=None):
    """Lay out one routing pass (slot values are 1.0: a routing pass only
    moves data; the final W-SELL pass multiplies).

    pos:     current position of each element in the input table, ascending
             within each bucket; bucket-major order overall
    bucket:  dense nondecreasing bucket id per element
    nd:      next-level refinement digit per element (lane-run ordering)
    grouped: (group, sigma, lam, group_stack) from the fused native level
             (``smm_stream_level``), which skips the grouping here
    Returns (StreamPass on ``device``, new position per element).

    Grouping, packing and plane emission run in the native library when it is
    available; the NumPy expressions are the fallback and the specification.
    """
    wrows = 8 * window_f
    if grouped is None and pos.size:
        grouped = native.stream_group(wrows, bucket, pos)
    if grouped is not None:
        group, sigma, lam, group_stack = grouped
    else:
        xrow = pos // LANE
        lam = pos % LANE
        stack = xrow // wrows
        # dense group id per (bucket, window stack): the inputs are sorted by
        # (bucket, pos), so the pair key is nondecreasing
        key = bucket * ((-(-table_len // LANE)) // wrows + 2) + stack
        new_group = np.zeros(key.shape[0], bool)
        if key.size:
            new_group[0] = True
            new_group[1:] = key[1:] != key[:-1]
        group = np.cumsum(new_group) - 1
        sigma = xrow - stack * wrows
        n_groups = int(group[-1]) + 1 if group.size else 0
        group_stack = np.zeros(n_groups, np.int64)
        if group.size:
            group_stack[group] = stack

    row_in_group, out_lane, rows_per_group = _pack_pass(group, sigma, lam, nd, pos, wrows)

    # per-group vreg-aligned row offsets
    rows_padded = _round_up(np.maximum(rows_per_group, 1), 8)
    row_off = np.cumsum(rows_padded) - rows_padded
    total_rows = int(rows_padded.sum()) if rows_padded.size else 8
    n_vregs = max(total_rows // 8, 1)
    n_vregs_padded = _round_up(n_vregs, chunk_for(n_vregs, window_f))
    total_rows_padded = n_vregs_padded * 8

    sw_bits = max(3, (wrows - 1).bit_length())
    vals_plane = np.zeros((total_rows_padded, LANE), dtype=dtype)
    meta = np.zeros((total_rows_padded, LANE), np.int32)
    out_pos = None
    if group.size:
        out_pos = native.stream_emit(sw_bits, group, row_off, row_in_group, out_lane, lam,
                                     sigma, vals_plane, meta)
    if out_pos is None:
        row_global = row_off[group] + row_in_group if group.size else group
        out_pos = row_global * LANE + out_lane
        sw_plane = np.zeros((total_rows_padded, LANE), np.int32)
        lsrc_plane = np.zeros((total_rows_padded, LANE), np.int32)
        if group.size:
            vals_plane[row_global, out_lane] = 1.0
            lsrc_plane[row_global, out_lane] = lam.astype(np.int32)
            sw_plane[row_global, lam] = sigma.astype(np.int32)
        meta = (sw_plane | (lsrc_plane << sw_bits)).astype(np.int32)

    # per-vreg window-stack base rows; the table pads to a whole number of
    # stacks, so no base needs clamping (which would shift the window against
    # the precomputed sw)
    x_rows = _round_up(max(-(-table_len // LANE), wrows), wrows)
    if rows_padded.size:
        base_rows = np.repeat(group_stack * wrows, rows_padded // 8)
    else:
        base_rows = np.zeros(0, np.int64)
    base = np.zeros(n_vregs_padded, np.int32)
    base[: base_rows.shape[0]] = np.minimum(base_rows, max(x_rows - wrows, 0)).astype(np.int32)

    sp = StreamPass(vals=torch.from_numpy(vals_plane).to(device),
                    meta=torch.from_numpy(meta).to(device),
                    base=torch.from_numpy(base).to(device),
                    x_rows=int(x_rows), window_f=int(window_f))
    return sp, out_pos


# -- bucket-tree planner and chain construction -----------------------------------


def _plan_digits(n, nnz, n_leaves, window_f, fill_target=4096):
    """Mixed-radix branching per routing pass.

    The first pass reads x, whose source lanes ``c % 128`` are effectively
    random, so its per-(group, lane) histogram is Poisson and the pack pads by
    max/mean; groups of ~``fill_target`` elements keep that low.  Later passes
    read the previous stream, whose lane runs the packer balanced on purpose:
    their fan-out is limited only by the window span.  The constants are the
    JAX package's (rsell.py:302-331), chosen there on total slots moved."""
    span = 8 * window_f * LANE
    digits = []
    remaining = n_leaves
    # first pass: elements per stack = span * nnz / n
    per_stack = span * max(nnz, 1) / max(n, 1)
    e1 = max(int(per_stack / fill_target), 2)
    digits.append(min(e1, remaining))
    remaining = -(-remaining // digits[-1])
    # later passes: span-limited, with a pad margin of ~1.6
    e_mid = max(int(span / (1024 * 1.6)), 2)
    while remaining > 1:
        digits.append(min(e_mid, remaining))
        remaining = -(-remaining // digits[-1])
    return digits


def routed_from_csr(
    csr: CSRMatrix,
    *,
    window_f: int = 16,
    max_slot_ratio: float = 16.0,
    leaf_slabs: Optional[int] = None,
    _digits: Optional[Tuple[int, ...]] = None,
    final_nway: int = 4,
    _final_nway_min_gain: float = 0.1,
) -> RoutedMatrix:
    """Build the routed chain of a CSR matrix of any pattern, on its device;
    the layout is built on the host from one read of the CSR's arrays.

    ``window_f`` sets the window-stack width of every pass (a span of
    1024 * F positions).  ``leaf_slabs`` overrides how many 1024-row output
    slabs form one leaf bucket (default: as many as keep the final pass's
    windows within one leaf segment).  ``_digits`` overrides the mixed-radix
    plan.  Raises ValueError when the chain moves more than ``max_slot_ratio``
    slots per nonzero."""
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    n_rows, n_cols = csr.shape
    nnz = int(csr.nnz)
    r = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    c = csr.indices.cpu().numpy().astype(np.int64)
    v = csr.data.cpu().numpy()
    dtype = v.dtype
    device = csr.device

    n_slabs = max(-(-n_rows // SLAB), 1)
    span = 8 * window_f * LANE
    if leaf_slabs is None:
        # final pass: a slab's sources spread over its whole leaf segment
        # (~nnz/slab * pad); keep that within ~60% of the span
        per_slab = max(nnz / n_slabs, 1.0)
        leaf_slabs = max(int(0.6 * span / (per_slab * 1.35)), 1)
    n_leaves = -(-n_slabs // leaf_slabs)
    leaf = np.minimum(r // SLAB // leaf_slabs, n_leaves - 1)

    digits = (list(_digits) if _digits is not None
              else _plan_digits(n_cols, nnz, n_leaves, window_f))

    # mixed-radix digit path of each element's leaf id
    weights = []
    w = 1
    for d in reversed(digits):
        weights.append(w)
        w *= d
    weights = weights[::-1]

    passes = []
    pos = c.copy()
    prefix = np.zeros(nnz, np.int64)
    table_len = int(n_cols)
    order = np.arange(nnz, dtype=np.int64)
    slab_in_leaf = ((r // SLAB) % max(leaf_slabs, 1)).astype(np.int64)
    total_slots = 0
    prefix_card = 1  # number of distinct prefix values after the update
    for level, (d, wt) in enumerate(zip(digits, weights)):
        if level + 1 < len(digits):
            d_next, wt_next = digits[level + 1], weights[level + 1]
        else:
            d_next, wt_next = 1, -1
        prefix_card *= d
        # the fused native level: prefix update, stable (prefix, pos) sort of
        # all carried arrays, nd and grouping in one call, with the tight key
        # width (pos < table_len) that keeps the radix sort to few passes
        pos_bits = max(int(table_len - 1).bit_length(), 1)
        key_bits = pos_bits + max(int(prefix_card - 1).bit_length(), 1)
        fused = None
        if nnz and key_bits <= 64:
            fused = native.stream_level(8 * window_f, d, wt, d_next, wt_next, pos_bits,
                                        key_bits, prefix, pos, order, leaf, slab_in_leaf)
        if fused is not None:
            nd, *grouped = fused
            sp, pos = _build_stream_pass(pos, prefix, nd, table_len, window_f, dtype, device,
                                         grouped=tuple(grouped))
        else:
            digit = (leaf // wt) % d
            prefix = prefix * d + digit
            sort_key = _pack_keys((prefix, pos), (0, 38))
            perm = native.sort_perm(sort_key) if nnz else None
            if perm is None:
                perm = np.argsort(sort_key, kind="stable")
            prefix, pos, order, leaf, slab_in_leaf = (
                prefix[perm], pos[perm], order[perm], leaf[perm], slab_in_leaf[perm])
            # the next-level digit orders each slot row's lanes (contiguous
            # lane runs per next bucket), see _pack_pass
            if level + 1 < len(digits):
                nd = (leaf // weights[level + 1]) % digits[level + 1]
            else:
                nd = slab_in_leaf
            sp, pos = _build_stream_pass(pos, prefix, nd, table_len, window_f, dtype, device)
        passes.append(sp)
        table_len = sp.out_len
        total_slots += sp.out_len

    # final pass: W-SELL over (row, stream position) with the matrix values;
    # a slab's windows stay inside one leaf segment.  The bounded reduction
    # (nway) is offered and bails to nway 1 where it gains too little.
    inv = np.empty(nnz, np.int64)
    inv[order] = np.arange(nnz)
    final = _wsell_from_coo(r, pos[inv], v, (int(n_rows), int(table_len)), nnz, device=device,
                            max_slot_ratio=1e9, window_f=window_f, nway=final_nway,
                            nway_min_gain=_final_nway_min_gain)
    total_slots += final.n_vregs * SLAB
    slot_ratio = float(total_slots / max(nnz, 1))
    if slot_ratio > max_slot_ratio:
        raise ValueError(f"R-SELL routing pads too high for this pattern: "
                         f"{slot_ratio:.1f} slots/nnz (> {max_slot_ratio})")
    return RoutedMatrix(passes=tuple(passes), final=final, shape=(int(n_rows), int(n_cols)),
                        nnz=nnz, slot_ratio=slot_ratio)


def try_routed_from_csr(csr: CSRMatrix, *, max_slot_ratio: float = 16.0,
                        **kwargs) -> Optional[RoutedMatrix]:
    """:func:`routed_from_csr`, or None when the chain would pad beyond the
    cap (the contract of ``try_wsell_from_csr``)."""
    try:
        return routed_from_csr(csr, max_slot_ratio=max_slot_ratio, **kwargs)
    except ValueError:
        return None
