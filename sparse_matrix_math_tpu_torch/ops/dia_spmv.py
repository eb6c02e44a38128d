"""DIA SpMV: the padded layout, the Hopper kernels and their plain versions.

Port of ``sparse_matrix_math_tpu/ops/pallas_spmv.py:44-386``.  The kernels
are ``csrc/dia_spmv.cu`` (its header says what bounds them on the card):

* :func:`dia_spmv` (K1, TPU ``_dia_kernel``) — one-shot ``y = A @ x`` on an
  unpadded ``x``, for ``rmult`` on a :class:`DIAMatrix`;
* :func:`dia_spmv_padded` (K2, TPU ``_dia_padded_kernel``) — ``y = A @ x``
  with both vectors in the :class:`PaddedDIA` layout, the matvec of every
  DIA solve;
* :func:`dia_spmv_streamed` (K3, TPU ``_dia_streamed_kernel``) — the same
  kernels as K2: the card reads x through its L2 at every size.

K2/K3 run one of two kernels, by the rule of :func:`staged_plan` (a pure
function of the offsets, ``n_total``, the dtypes and the card's SM count;
:func:`variant` names the choice): the staged kernel, whose CTAs copy each
tile's diagonals and one x segment per cluster of offsets
(:func:`x_clusters`) into shared memory by TMA bulk copies, or the kernel
with one thread per row.  :func:`dia_spmv_padded_staged_plain` replays the
staged kernel's decomposition in PyTorch.

K2/K3 also take a :class:`PaddedDIA` whose diagonals are stored in bfloat16
(or float16) with a float32 ``xp``, the call shape of the mixed-precision
solve (``solvers/mixed.py``; JAX ``mixed.py:207-219``): each value is widened
exactly, the sum runs in float32 and ``y`` takes ``xp``'s dtype.  Those
launches count under their own keys (``dia_spmv_padded_bf16``,
``dia_spmv_padded_f16``).

A wrapper given CPU tensors runs the kernel's plain version; given CUDA
tensors it launches the kernel or raises.  Each launch adds one to
:data:`launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..formats.dia import DIAMatrix

__all__ = [
    "PaddedDIA", "pad_dia", "dia_spmv", "dia_spmv_padded", "dia_spmv_streamed",
    "dia_spmv_plain", "dia_spmv_padded_plain", "variant", "launches",
    "reset_launch_counts",
]

_BLOCK = 128  # guard granularity, as the TPU layout's lane width
_MAX_DIAGS = 64  # kMaxDiags in csrc/dia_spmv.cu; DIA's own max_diags
_DTYPES = (torch.float32, torch.float64)
# narrow diagonal dtypes of the padded kernel (float32 x and y)
_NARROW = (torch.bfloat16, torch.float16)
# per diagonals' dtype: the padded C entry, its launch counter and its kind
# in smm_dia_staged_blocks_per_sm
_PADDED_ENTRY = {
    torch.float32: ("smm_dia_spmv_padded_f32", "dia_spmv_padded", 0),
    torch.float64: ("smm_dia_spmv_padded_f64", "dia_spmv_padded", 1),
    torch.bfloat16: ("smm_dia_spmv_padded_bf16_f32", "dia_spmv_padded_bf16", 2),
    torch.float16: ("smm_dia_spmv_padded_f16_f32", "dia_spmv_padded_f16", 3),
}

# The staged kernel (csrc/dia_spmv.cu dia_staged_kernel): threads per CTA,
# the tiles it is built for (256 * J rows), its ring of two stages, the
# mbarriers' and clusters' bytes ahead of the stages (kHeaderBytes) and the
# dynamic shared memory a block may use on an H100.  This module owns the
# layout of a stage and the grid; the C entry checks them and launches.
STAGED_THREADS = 256
STAGED_TILES = (512, 1024)
_STAGES = 2
_HEADER_BYTES = 1024
_SMEM_BYTES = 232448

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"dia_spmv": 0, "dia_spmv_padded": 0, "dia_spmv_padded_bf16": 0,
            "dia_spmv_padded_f16": 0}


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
    ``diags_p[d, e]`` is the coefficient of row ``e - lead``.  ``dtype`` is
    the diagonals' (bfloat16 for the mixed solve's low operator, whose
    vectors stay float32): vectors follow the right-hand side, never it.
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

    @functools.cached_property
    def _k2(self) -> "_K2Launch":
        """What every K2 launch on this layout shares, worked out at its
        first launch on the card."""
        return _k2_launch(self)


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
    ascending-offset order; every other row is an exact 0.  Narrow
    diagonals are widened exactly to ``xp``'s dtype first."""
    y = torch.zeros_like(xp)
    rows = slice(lead, lead + n_rows)
    acc = None
    for d, off in enumerate(offsets):
        term = diags_p[d, rows].to(xp.dtype) * xp[lead + off:lead + off + n_rows]
        acc = term if acc is None else acc + term
    y[rows] = acc
    return y


# -- the staged kernel's decomposition and the rule that picks it ------------


@dataclasses.dataclass(frozen=True)
class StagedPlan:
    """What the staged kernel is launched with: ``tile`` rows per tile (512
    or 1024) and the x segment of each cluster as ``(lo, length,
    first_diagonal)``: the tile starting at row t0 copies its diagonals'
    values and ``xp[t0 + lo, t0 + lo + length)``, clamped to ``[0,
    n_total)``, into one stage of the kernel's ring."""

    tile: int
    clusters: Tuple[Tuple[int, int, int], ...]

    def x_elems(self) -> int:
        return sum(length for _, length, _ in self.clusters)

    def stage_bytes(self, ndiags: int, diag_itemsize: int, x_itemsize: int) -> int:
        """One stage: the tile's diagonals, then the x segments, rounded up
        to 128 bytes."""
        diag = ndiags * self.tile * diag_itemsize
        return -(-(diag + self.x_elems() * x_itemsize) // 128) * 128

    def smem_bytes(self, ndiags: int, diag_itemsize: int, x_itemsize: int) -> int:
        """Dynamic shared memory of one CTA: the header and two stages."""
        return _HEADER_BYTES + _STAGES * self.stage_bytes(ndiags, diag_itemsize, x_itemsize)

    @functools.cached_property
    def segs(self) -> np.ndarray:
        """The C entry's ``segs``: the count, then (lo, length, first) each."""
        return np.asarray([len(self.clusters)] + [v for c in self.clusters for v in c],
                          dtype=np.int32)

    @functools.cached_property
    def segs_ptr(self) -> int:
        """The address of :attr:`segs`, which the plan keeps alive."""
        return self.segs.ctypes.data


def x_clusters(offsets, tile: int, x_itemsize: int) -> Tuple[Tuple[int, int, int], ...]:
    """The offsets (in diagonal order) grouped into clusters, each with the x
    segment a tile of ``tile`` rows reads: a diagonal joins the cluster
    before it when its offset is not below that cluster's last and the gap
    is under ``tile`` (one segment costs ``tile`` rows more than bridging
    such a gap).  The segment ``[lo, lo + length)`` covers ``[min, tile +
    max)`` of the cluster's offsets, rounded out to 16 bytes."""
    align = 16 // x_itemsize
    groups = []
    for d, off in enumerate(offsets):
        if groups and off >= groups[-1][2] and off - groups[-1][2] < tile:
            groups[-1][2] = off
        else:
            groups.append([d, off, off])
    out = []
    for first, lo_off, hi_off in groups:
        lo = (lo_off // align) * align
        hi = -(-(tile + hi_off) // align) * align
        out.append((int(lo), int(hi - lo), int(first)))
    return tuple(out)


@functools.lru_cache(maxsize=256)
def staged_plan(offsets, n_total: int, diag_dtype: torch.dtype, x_dtype: torch.dtype,
                num_sms: int) -> Optional[StagedPlan]:
    """The rule that picks K2/K3's kernel on the card: a :class:`StagedPlan`
    for the staged kernel, or None for the kernel with one thread per row.

    float64 x keeps the row kernel.  Otherwise the tile is the largest of
    :data:`STAGED_TILES` whose two stages (each the tile's diagonals and the
    clusters' x segments) fit the block's shared memory, and the staged
    kernel runs when the layout holds at least ``_MIN_TILES`` such tiles
    per SM (with fewer, each CTA's first copies go unhidden).  Where no tile
    fits (many scattered diagonals, each its own segment), the row kernel.
    PERF.md §6 (K2/K3) has the timings that set each threshold."""
    offsets = tuple(int(o) for o in offsets)
    d_size, x_size = diag_dtype.itemsize, x_dtype.itemsize
    if x_size == 8:
        return None
    for tile in sorted(STAGED_TILES, reverse=True):
        plan = StagedPlan(tile, x_clusters(offsets, tile, x_size))
        if plan.smem_bytes(len(offsets), d_size, x_size) <= _SMEM_BYTES:
            return plan if n_total >= _MIN_TILES * tile * num_sms else None
    return None


# the rule's threshold (PERF.md §6, H100 timings): the tiles per SM below
# which the row kernel runs
_MIN_TILES = 7


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _x_dtype(diag_dtype: torch.dtype) -> torch.dtype:
    """K2's x and y dtype for diagonals of ``diag_dtype``."""
    return torch.float32 if diag_dtype in _NARROW else diag_dtype


def variant(a: PaddedDIA, device) -> str:
    """``"staged (tile T)"`` or ``"rows"``: the kernel a product of ``a``
    takes on the CUDA ``device`` (the rule of :func:`staged_plan`)."""
    device = torch.device(device)
    plan = staged_plan(a.offsets, a.n_total, a.dtype, _x_dtype(a.dtype),
                       _num_sms(device.index or 0))
    return "rows" if plan is None else f"staged (tile {plan.tile})"


def dia_spmv_padded_staged_plain(diags_p: torch.Tensor, offsets, lead: int, n_rows: int,
                                 xp: torch.Tensor, plan: StagedPlan) -> torch.Tensor:
    """The staged kernel replayed in PyTorch: tile by tile, the clusters'
    x segments and the tile's diagonals copied, clamped to ``[0, n_total)``,
    into buffers that start as NaN (as shared memory holds what an earlier
    tile left), and row ``r = t + threads * j`` of the tile computed from
    them in the kernel's order.  Equal to :func:`dia_spmv_padded_plain` bit
    for bit: a read outside what was copied shows as NaN in an active row.
    ``plan.tile`` may be any multiple of 128 here (the kernel builds 512
    and 1024)."""
    n_total = xp.shape[0]
    tile = plan.tile
    if tile < 128 or tile % 128:
        raise ValueError(f"tile {tile} must be a positive multiple of 128")
    threads = math.gcd(tile, STAGED_THREADS)
    base, xoff = 0, [0] * len(offsets)
    bounds = [first for _, _, first in plan.clusters[1:]] + [len(offsets)]
    bases = []
    for (lo, length, first), end in zip(plan.clusters, bounds):
        bases.append(base)
        for d in range(first, end):
            if not 0 <= offsets[d] - lo <= length - tile:
                raise ValueError(f"diagonal {d} reads outside its cluster's segment")
            xoff[d] = base + offsets[d] - lo
        base += length
    nan = float("nan")
    r = (torch.arange(tile // threads)[:, None] * threads
         + torch.arange(threads)[None, :]).reshape(-1)
    y = torch.zeros_like(xp)
    xs = torch.full((base,), nan, dtype=xp.dtype)
    ds = torch.full((len(offsets), tile), nan, dtype=diags_p.dtype)
    for t0 in range(0, n_total, tile):
        rows = min(tile, n_total - t0)
        for (lo, length, _), b in zip(plan.clusters, bases):
            g0, g1 = max(t0 + lo, 0), min(t0 + lo + length, n_total)
            if g1 > g0:
                xs[b + g0 - (t0 + lo):b + g1 - (t0 + lo)] = xp[g0:g1]
        ds[:, :rows] = diags_p[:, t0:t0 + rows]
        acc = None
        for d in range(len(offsets)):
            term = ds[d, r].to(xp.dtype) * xs[xoff[d] + r]
            acc = term if acc is None else acc + term
        e = t0 + r
        keep = e < n_total
        active = (e >= lead) & (e < lead + n_rows)
        y[e[keep]] = torch.where(active, acc, torch.zeros((), dtype=xp.dtype))[keep]
    return y


# -- wrappers ------------------------------------------------------------------


def _check(diags: torch.Tensor, x: torch.Tensor, x_len: int, offsets,
           narrow: bool = False) -> None:
    """Refuse what the kernels do not take; ``narrow`` admits the padded
    kernel's bfloat16/float16 diagonals with a float32 x."""
    if diags.device != x.device:
        raise ValueError(f"diagonals on {diags.device} but x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    mixed = narrow and diags.dtype in _NARROW and x.dtype == torch.float32
    if not mixed and (diags.dtype != x.dtype or x.dtype not in _DTYPES):
        raise TypeError(
            f"diagonals ({diags.dtype}) and x ({x.dtype}) must both be float32 or both "
            "float64" + (", or bfloat16/float16 diagonals with a float32 x" if narrow else "")
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


_ROW_ARGS = (0, None, 0, 0)  # the padded entry's tile, segs, stage bytes, grid: rows


@functools.lru_cache(maxsize=64)
def _blocks_per_sm(kind: int, tile: int, smem: int, index: int) -> int:
    """CTAs of the staged kernel one SM of card ``index`` holds at ``smem``
    bytes each (the C entry opts the kernel in to the card's shared memory
    first); a plan that fits no CTA raises."""
    from . import _build

    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library().smm_dia_staged_blocks_per_sm(kind, tile, smem,
                                                               ctypes.byref(blocks))
    _build.check(code, "dia_spmv_padded (staged kernel's occupancy)")
    return blocks.value


def _launch_args(a: PaddedDIA, plan: Optional[StagedPlan], index: int) -> tuple:
    """The padded C entry's tile, segments, stage bytes and grid for
    ``plan`` (None: the row kernel) on card ``index``: persistent CTAs, as
    many as the card holds, at most one per tile."""
    if plan is None:
        return _ROW_ARGS
    stage = plan.stage_bytes(len(a.offsets), a.dtype.itemsize, _x_dtype(a.dtype).itemsize)
    per_sm = _blocks_per_sm(_PADDED_ENTRY[a.dtype][2], plan.tile, _HEADER_BYTES + _STAGES * stage,
                            index)
    grid = min(-(-a.n_total // plan.tile), per_sm * _num_sms(index))
    return plan.tile, plan.segs_ptr, stage, grid


@dataclasses.dataclass(frozen=True)
class _K2Launch:
    """K2 on one layout: the bound C entry, its launch counter, the offsets
    as the entry takes them and their address, the rule's plan and the
    entry's plan arguments (:func:`_launch_args`).  The record keeps the
    arrays whose addresses it passes alive."""

    fn: object
    counter: str
    offsets: np.ndarray
    offsets_ptr: int
    plan: Optional[StagedPlan]
    args: tuple


def _k2_launch(a: PaddedDIA) -> _K2Launch:
    from . import _build

    entry, counter, _ = _PADDED_ENTRY[a.dtype]
    index = a.device.index
    plan = staged_plan(a.offsets, a.n_total, a.dtype, _x_dtype(a.dtype), _num_sms(index))
    if a.diags_p.data_ptr() % 16:  # the staged kernel's bulk copies need 16 bytes
        plan = None
    offsets = np.asarray(a.offsets, dtype=np.int32)
    return _K2Launch(getattr(_build.library(), entry), counter, offsets, offsets.ctypes.data,
                     plan, _launch_args(a, plan, index))


def _launch(a: PaddedDIA, xp: torch.Tensor, k2: _K2Launch, args: tuple) -> torch.Tensor:
    from . import _build

    y = torch.empty(a.n_total, dtype=xp.dtype, device=xp.device)
    with torch.cuda.device(xp.device):
        code = k2.fn(a.diags_p.data_ptr(), xp.data_ptr(), y.data_ptr(), k2.offsets_ptr,
                     len(a.offsets), a.n_total, a.lead, a.shape[0], *args,
                     torch.cuda.current_stream().cuda_stream)
    _build.check(code, k2.counter)
    launches[k2.counter] += 1
    return y


def launch_padded(a: PaddedDIA, xp: torch.Tensor, plan: Optional[StagedPlan]) -> torch.Tensor:
    """Launch K2 on CUDA tensors that :func:`dia_spmv_padded` has checked,
    with ``plan`` instead of the rule's (None: the row kernel); count the
    launch and return y.  A refused launch raises."""
    return _launch(a, xp, a._k2, _launch_args(a, plan, xp.device.index))


def dia_spmv_padded(a: PaddedDIA, xp: torch.Tensor) -> torch.Tensor:
    """K2: y = A @ x with x and y in the padded layout; guard rows of y are
    exactly 0.  Diagonals in bfloat16 or float16 take a float32 ``xp``.  On
    the card the kernel is the one :func:`staged_plan` picks (the row kernel
    too where ``diags_p`` or ``xp`` does not start on 16 bytes, which the
    staged kernel's bulk copies need)."""
    _check(a.diags_p, xp, a.n_total, a.offsets, narrow=True)
    if xp.device.type == "cpu":
        return dia_spmv_padded_plain(a.diags_p, a.offsets, a.lead, a.shape[0], xp)
    k2 = a._k2
    return _launch(a, xp, k2, _ROW_ARGS if xp.data_ptr() % 16 else k2.args)


def dia_spmv_streamed(a: PaddedDIA, xp: torch.Tensor) -> torch.Tensor:
    """K3: the TPU's large-n variant.  On the card it is the padded kernel:
    x is read through the 50 MB L2 at every size, so there is no
    resident/streamed split."""
    return dia_spmv_padded(a, xp)
