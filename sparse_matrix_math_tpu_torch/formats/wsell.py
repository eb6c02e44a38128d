"""W-SELL: the windowed sliced-ELL layout for general sparsity patterns.

Port of ``sparse_matrix_math_tpu/formats/wsell.py`` (the whole file).  The
layout code is the same host NumPy code, or the same native plan, colouring and
scatter (``smm_native.cpp``, bound by ``native.py``), so a matrix gets the
same planes, the same ``slot_ratio``, the same refusal above
``max_slot_ratio`` and the same nway auto-bail as in the JAX package; the
planes then live on the CSR's device.  Layout, in short:

* nonzeros group into **jobs**: one 1024-row output slab times one aligned
  window of ``8 * window_f`` rows of the ``(x_rows, 128)`` x table;
* a job's slots fill whole vregs, 8 rows by 128 lanes of the planes; the
  slot for entry ``(r, c, v)`` sits at lane ``r % 128``;
* ``meta`` packs, per plane position, the window sublane (SW) of the column
  read through that lane at the SOURCE lane, the source lane (LSRC, 7 bits)
  of the slot at that lane, and with ``nway > 1`` a 3-bit SHIFT above LSRC;
* ``base[v]`` is vreg v's window base in x-table rows, ``slab[v]`` its
  output slab (nondecreasing).  ``slab_ptr`` (not a JAX field) gives each
  slab's vreg range, K8's work list.
* ``sell`` (not a JAX field) is the slab-sorted SELL-32 layout of the
  planes' live slots (``formats/sell.py``), derived on the planes' device
  when the matrix is made; K7 reads it.

``ops/wsell_spmv.py`` holds the products (kernels K7, K8).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .csr import CSRMatrix
from .sell import SellMatrix, sell_from_wsell

__all__ = ["WSellMatrix", "wsell_from_csr", "try_wsell_from_csr"]

SLAB = 1024      # rows per output slab (8 sublanes x 128 lanes)
LANE = 128
# vregs per TPU grid step; the layout pads the vreg count to a multiple of
# chunk_for(), which changes the planes and slot_ratio, so it is kept
CHUNK_VREGS = 256


def _lsrc_shift(window_f: int) -> int:
    """Bit position of LSRC in the packed meta of an F-window matrix."""
    return max(3, (8 * window_f - 1).bit_length())


def chunk_for(n_vregs: int, window_f: int) -> int:
    """The vreg-count alignment of an F-window matrix (wsell.py:83-89)."""
    c = max(CHUNK_VREGS >> max(0, (window_f - 1).bit_length()), 1)
    return n_vregs if n_vregs <= c else c


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class WSellMatrix:
    """Windowed sliced-ELL matrix (see the module docstring for the layout)."""

    vals: torch.Tensor      # (V*8, 128) slot values (0 in padding)
    meta: torch.Tensor      # (V*8, 128) int32 packed SW | LSRC [| SHIFT]
    base: torch.Tensor      # (V,) int32 x-table row base per vreg
    slab: torch.Tensor      # (V,) int32 nondecreasing output slab per vreg
    slab_ptr: torch.Tensor  # (n_slabs + 1,) int32: slab s owns vregs [ptr[s], ptr[s+1])
    shape: Tuple[int, int]
    nnz: int
    n_slabs: int
    x_rows: int
    slot_ratio: float
    window_f: int = 1
    nway: int = 1
    # K7's layout; derived here when not given, taking a slot for padding
    # when its value, LSRC and SHIFT are all 0 (formats/sell.py)
    sell: Optional[SellMatrix] = None

    def __post_init__(self):
        if self.sell is None:
            object.__setattr__(self, "sell", sell_from_wsell(
                self.vals, self.meta, self.base, self.slab, self.shape, self.nnz,
                _lsrc_shift(self.window_f), self.nway))

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def n_vregs(self) -> int:
        return int(self.base.shape[0])

    def astype(self, dtype: torch.dtype) -> "WSellMatrix":
        return dataclasses.replace(self, vals=self.vals.to(dtype), sell=self.sell.astype(dtype))

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        """Densify by probing with the identity (test and debug sizes only)."""
        eye = torch.eye(self.shape[1], dtype=self.dtype, device=self.device)
        return self.rmult(eye)


def slab_pointers(slab: np.ndarray, n_slabs: int) -> np.ndarray:
    """Each slab's vreg range from the nondecreasing per-vreg slab ids."""
    return np.searchsorted(slab, np.arange(n_slabs + 1)).astype(np.int32)


def _pack_keys(keys: Tuple[np.ndarray, ...], bits: Tuple[int, ...]) -> np.ndarray:
    """Pack non-negative int keys into one int64 sort key."""
    out = keys[0].astype(np.int64)
    for k, b in zip(keys[1:], bits[1:]):
        out = (out << b) | k.astype(np.int64)
    return out


def _group_rank(key: np.ndarray) -> np.ndarray:
    """Occurrence index of each element within its key group."""
    n = key.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    change = np.zeros(n, bool)
    change[0] = True
    change[1:] = ks[1:] != ks[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(change, idx, 0))
    out = np.empty(n, np.int64)
    out[order] = idx - start
    return out


def _distinct_rank(key: np.ndarray, val: np.ndarray, val_bits: int = 3) -> np.ndarray:
    """Rank of ``val`` among the distinct values of its key group (equal
    values share a rank)."""
    n = val.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort((key << val_bits) | val.astype(np.int64), kind="stable")
    ks = key[order]
    change = np.zeros(n, bool)
    change[0] = True
    change[1:] = ks[1:] != ks[:-1]
    vs = val[order]
    newval = change.copy()
    newval[1:] |= vs[1:] != vs[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(change, idx, 0))
    cs = np.cumsum(newval)
    out = np.empty(n, np.int64)
    out[order] = cs - cs[start]
    return out


def _repair_conflicts(row, job, t_of, lane_out, lsrc, sw3, max_repair_rounds: int,
                      sw_bits: int = 3):
    """Bump-repair rounds of the NumPy colouring: resolve slots that land on
    one (job, t, row, lane), or that read two window sublanes through one
    source lane of a slot row."""
    row_bits = 14  # repair bumps stay far below 2^14 rows
    for _ in range(max_repair_rounds):
        dup_a = _group_rank(_pack_keys((job, t_of, row, lane_out), (0, 3, row_bits, 7)))
        dup_b = _distinct_rank(_pack_keys((job, t_of, row, lsrc), (0, 3, row_bits, 7)),
                               sw3, val_bits=sw_bits)
        conflict = (dup_a > 0) | (dup_b > 0)
        if not conflict.any():
            return row
        row[conflict] += np.maximum(dup_a, dup_b)[conflict]
        if row.max() >= (1 << row_bits):
            raise ValueError("W-SELL colouring blew past the row budget "
                             "(pattern too adversarial)")
    raise ValueError("W-SELL colouring did not converge "
                     f"(pattern too adversarial after {max_repair_rounds} rounds)")


def _window_jobs(slab_of: np.ndarray, xrow: np.ndarray, x_rows: int, window_f: int = 1):
    """Group nnz into (slab, aligned 8F-row window) jobs: (job id per nnz,
    window base per job, slab per job), jobs in slab order."""
    n = slab_of.shape[0]
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    wrows = 8 * window_f
    wdim = np.int64((x_rows + wrows - 1) // wrows + 1)
    aligned = slab_of * wdim + xrow // wrows
    key_span = int(slab_of.max() + 1) * int(wdim)
    if key_span <= max(4 * n, 1 << 26):
        flags = np.zeros(key_span, bool)
        flags[aligned] = True
        ujobs = np.flatnonzero(flags)
        pos = np.cumsum(flags, dtype=np.int64) - 1
        jinv = pos[aligned]
    else:
        ujobs, jinv = np.unique(aligned, return_inverse=True)
        jinv = jinv.astype(np.int64)
    base = np.minimum((ujobs % wdim) * wrows, x_rows - wrows)
    return jinv, base.astype(np.int64), (ujobs // wdim).astype(np.int64)


def wsell_from_csr(csr: CSRMatrix, *, max_slot_ratio: float = 8.0,
                   max_repair_rounds: int = 200, window_f: int = 1, nway: int = 1,
                   nway_min_gain: float = 0.1) -> WSellMatrix:
    """CSR -> W-SELL on the CSR's device; the layout is built on the host
    from one read of the CSR's arrays.

    Raises ValueError when the pattern pads worse than ``max_slot_ratio``
    slots per nnz.  ``window_f`` widens each vreg's x window to F aligned
    8-row slices; ``nway`` (1/2/4/8) lets a vreg position serve that many
    target sublanes, trading a per-slot shift for less padding.
    """
    indptr = csr.indptr.cpu().numpy().astype(np.int64)
    n_rows, n_cols = csr.shape
    r = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
    return _wsell_from_coo(
        r, csr.indices.cpu().numpy().astype(np.int64), csr.data.cpu().numpy(),
        (int(n_rows), int(n_cols)), csr.nnz, device=csr.device,
        max_slot_ratio=max_slot_ratio, max_repair_rounds=max_repair_rounds,
        window_f=window_f, nway=nway, nway_min_gain=nway_min_gain,
    )


def _wsell_from_coo(r: np.ndarray, c: np.ndarray, v: np.ndarray, shape: Tuple[int, int],
                    nnz: int, *, device, max_slot_ratio: float = 8.0,
                    max_repair_rounds: int = 200, window_f: int = 1, nway: int = 1,
                    nway_min_gain: float = 0.1) -> WSellMatrix:
    """The W-SELL layout build over host COO arrays (rows need not be sorted),
    with the planes placed on ``device``.  An nway > 1 request falls back to
    nway = 1 unless it cuts the vreg count by at least ``nway_min_gain``."""
    if window_f < 1 or window_f > 16:
        raise ValueError(f"window_f must be in [1, 16], got {window_f}")
    if nway not in (1, 2, 4, 8):
        raise ValueError(f"nway must be 1, 2, 4 or 8, got {nway}")
    n_rows, n_cols = shape
    wrows = 8 * window_f
    n_slabs = max(-(-n_rows // SLAB), 1)
    # a whole number of 8F-row windows, so aligned job bases never clamp
    x_rows = max(_round_up(-(-n_cols // LANE), wrows), wrows)
    sw_bits = max(3, (wrows - 1).bit_length())

    plan = native.wsell_plan(r, c, n_rows, x_rows, window_f) if r.size else None
    if plan is not None:
        job, row, job_rows, job_base, job_slab = plan  # row: int32 colour
        n_jobs = job_base.shape[0]
    else:
        slab_of = r // SLAB
        t_of = (r % SLAB) // LANE
        lane_out = r % LANE
        lsrc = c % LANE
        job, job_base, job_slab = _window_jobs(slab_of, c // LANE, x_rows, window_f)
        n_jobs = job_base.shape[0]
        # distinct columns of one (job, t, source lane) group differ exactly
        # in the window sublane
        sw3 = ((c // LANE) % wrows).astype(np.int64)
        row = None
        if r.size:
            row_native = native.wsell_color(job, t_of, lane_out, lsrc, sw3, n_jobs)
            if row_native is not None:
                row = row_native.astype(np.int64)
        if row is None:
            # independent ranks over-approximate the colouring, then repair
            rank1 = _group_rank(_pack_keys((job, r), (0, 27)))
            rank2 = _distinct_rank(_pack_keys((job, t_of, lsrc), (0, 3, 7)), sw3,
                                   val_bits=sw_bits)
            row = np.maximum(rank1, rank2)
            if r.size:
                row = _repair_conflicts(row, job, t_of, lane_out, lsrc, sw3,
                                        max_repair_rounds, sw_bits=sw_bits)
        # static-target layout: vreg position i holds only rows of target
        # sublane i, so a job needs K = max_t rows_t vregs
        job_rows = np.zeros(n_jobs, np.int64)
        if r.size:
            np.maximum.at(job_rows, job, (row + 1) * 8)

    # bounded-reduction placement (nway > 1): group g of 8/nway owns
    # positions {g + j*8/nway}; rows place freely within their group
    row_in_job_nway = None
    shift_of = None
    if nway > 1 and r.size:
        row = np.asarray(row, dtype=np.int64)
        t_all = ((r % SLAB) // LANE).astype(np.int64)
        rt = np.zeros((n_jobs, 8), np.int64)
        np.maximum.at(rt, (job, t_all), row + 1)
        gsz = 8 // nway
        offs = np.zeros((n_jobs, 8), np.int64)
        job_rows = np.zeros(n_jobs, np.int64)
        for g in range(gsz):
            cum = np.zeros(n_jobs, np.int64)
            for i in range(nway):
                t = g + i * gsz
                offs[:, t] = cum
                cum = cum + rt[:, t]
            job_rows = np.maximum(job_rows, -(-cum // nway) * 8)
        job_rows = np.maximum(job_rows, 8)
        k1 = np.maximum(rt.max(axis=1), 1)
        if job_rows.sum() > (1.0 - nway_min_gain) * 8 * k1.sum():
            nway = 1  # the gain does not pay for the rotations
            job_rows = k1 * 8
        else:
            m_in_group = offs[job, t_all] + row
            p_of = (t_all % gsz) + (m_in_group % nway) * gsz
            shift_of = ((t_all - p_of) % 8).astype(np.int32)
            row_in_job_nway = (m_in_group // nway) * 8 + p_of

    kv = np.maximum(job_rows // 8, 1)  # vregs per job

    # a dummy job for every slab without one, so each slab has a vreg
    have = np.zeros(n_slabs, bool)
    have[job_slab] = True
    dummy_slabs = np.nonzero(~have)[0]
    all_slab = np.concatenate([job_slab, dummy_slabs])
    all_base = np.concatenate([job_base, np.zeros(dummy_slabs.shape[0], np.int64)])
    all_kv = np.concatenate([kv, np.ones(dummy_slabs.shape[0], np.int64)])
    order_jobs = np.argsort(all_slab, kind="stable")
    all_slab, all_base, all_kv = all_slab[order_jobs], all_base[order_jobs], all_kv[order_jobs]
    vreg_start = np.cumsum(all_kv) - all_kv
    n_vregs = int(all_kv.sum())
    chunk_unit = chunk_for(n_vregs, window_f)
    n_vregs_padded = -(-n_vregs // chunk_unit) * chunk_unit if n_vregs > chunk_unit else n_vregs

    job_pos = np.empty(all_slab.shape[0], np.int64)
    job_pos[order_jobs] = np.arange(all_slab.shape[0])
    vreg_start_of_job = vreg_start[job_pos[:n_jobs]]

    total_rows = n_vregs_padded * 8
    # refuse before the planes exist: a pattern far beyond the cap (one nonzero
    # per tile) would otherwise allocate and fill hundreds of slots per nonzero
    slot_ratio = float(total_rows * LANE / max(nnz, 1))
    if slot_ratio > max_slot_ratio:
        raise ValueError(
            f"W-SELL padding too high for this pattern: {slot_ratio:.1f} "
            f"slots/nnz (> {max_slot_ratio}); keep the CSR/ELL path"
        )
    vals_plane = np.zeros((total_rows, LANE), dtype=v.dtype)
    # chunk-pad vregs carry zero values, base 0 and the last slab
    pad_v = n_vregs_padded - n_vregs
    base_vreg = np.concatenate([np.repeat(all_base.astype(np.int32), all_kv),
                                np.zeros(pad_v, np.int32)])
    slab_vreg = np.concatenate([np.repeat(all_slab.astype(np.int32), all_kv),
                                np.full(pad_v, n_slabs - 1, np.int32)])

    meta = None
    row_global = None
    if plan is not None and r.size and nway == 1:
        meta_plane = np.zeros((total_rows, LANE), np.int32)
        if native.wsell_emit(_lsrc_shift(window_f), wrows, r, c, v, job, row,
                             vreg_start_of_job, base_vreg, vals_plane, meta_plane):
            meta = meta_plane
    if meta is None:
        if plan is not None:
            t_of = (r % SLAB) // LANE
            lane_out = r % LANE
            lsrc = c % LANE
        if r.size:
            row_in_job = (row_in_job_nway if row_in_job_nway is not None
                          else row.astype(np.int64) * 8 + t_of)
            row_global = vreg_start_of_job[job] * 8 + row_in_job
        else:
            row_global = np.zeros(0, np.int64)
        vals_plane[row_global, lane_out] = v
        lsrc_plane = np.zeros((total_rows, LANE), np.int32)
        lsrc_plane[row_global, lane_out] = lsrc.astype(np.int32)
        sw_plane = np.zeros((total_rows, LANE), np.int32)
        if r.size:
            sw = (c // LANE - base_vreg[row_global // 8].astype(np.int64)).astype(np.int32)
            if sw.min(initial=0) < 0 or sw.max(initial=0) > wrows - 1:
                raise AssertionError(f"window base math violated sw in [0, {wrows})")
            sw_plane[row_global, lsrc] = sw
        meta = (sw_plane | (lsrc_plane << _lsrc_shift(window_f))).astype(np.int32)
        if shift_of is not None:
            shift_plane = np.zeros((total_rows, LANE), np.int32)
            shift_plane[row_global, lane_out] = shift_of
            meta = meta | (shift_plane << (_lsrc_shift(window_f) + 7)).astype(np.int32)

    # the slots that hold a nonzero, for the derived layout
    live = np.zeros(total_rows * LANE, bool)
    if r.size:
        if row_global is None:  # the native emit placed them (nway 1)
            row_global = (vreg_start_of_job[job] * 8 + np.asarray(row, np.int64) * 8
                          + (r % SLAB) // LANE)
        live[row_global * LANE + r % LANE] = True

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    planes = dict(vals=put(vals_plane), meta=put(meta), base=put(base_vreg), slab=put(slab_vreg))
    shape = (int(n_rows), int(n_cols))
    sell = sell_from_wsell(*planes.values(), shape, int(nnz), _lsrc_shift(window_f), int(nway),
                           live=put(live).view(total_rows, LANE))
    return WSellMatrix(
        **planes, slab_ptr=put(slab_pointers(slab_vreg, n_slabs)),
        shape=shape, nnz=int(nnz), n_slabs=int(n_slabs),
        x_rows=int(x_rows), slot_ratio=slot_ratio, window_f=int(window_f), nway=int(nway),
        sell=sell,
    )


def try_wsell_from_csr(csr: CSRMatrix, *, max_slot_ratio: float = 8.0,
                       nway: int = 4) -> Optional[WSellMatrix]:
    """:func:`wsell_from_csr`, or None when the pattern pads beyond the
    ratio cap.  The solver-facing default is ``nway=4`` (wsell.py:568-583)."""
    try:
        return wsell_from_csr(csr, max_slot_ratio=max_slot_ratio, nway=nway)
    except ValueError:
        return None
