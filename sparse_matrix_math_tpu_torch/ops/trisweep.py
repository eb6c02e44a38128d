"""Fused triangular-sweep applies: the Hopper kernels and their plain versions.

Port of ``sparse_matrix_math_tpu/ops/pallas_trisweep.py``.  The kernels are
``csrc/trisweep.cu`` (its header says what bounds them on the card):

* :func:`sgs_apply_fused` (K4, TPU ``_make_kernel(use_mid=True)``) —
  ``z = M^{-1} r`` for a :class:`~..precond.padded_sgs.PaddedSGS`: forward
  sweeps with the strict lower part, the middle scale by D, backward sweeps
  with the strict upper part, one inverse diagonal for both directions;
* :func:`tri_pair_apply_fused` (K5, TPU ``_make_kernel(use_mid=False)``) —
  ``z = (L U)^{-1} r`` for a :class:`~..precond.padded_tri.PaddedTriPair`
  (IC0 or ILU0 factors), an inverse diagonal for each direction and no
  middle scale.

Every direction is ``x_0 = rhs * invd``, then ``sweeps - 1`` times
``x = (rhs - N x) * invd`` with ``N`` the strict part; an empty strict part
is the diagonal scale alone.  Vectors live in the flat padded layout of
:class:`~.dia_spmv.PaddedDIA`, and the factors share the full matrix's
geometry.  A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises.  Each apply on the card adds one
to :data:`launches`.

On the card an apply takes one of three variants, by the rule of
:func:`variant_of` (:func:`window_tile` gives the window kernels' tile):
``"window"``, the halo-window kernels (one launch per direction, each CTA
walking its tile's one-sided window in chunks of :data:`CHUNK` rows with
the levels' rings in shared memory); where the rings do not fit or the
halo reaches two tiles of a larger system, ``"ring"``, the large-reach
kernel (one launch per direction, persistent CTAs taking chunks in the
dependences' order and keeping every level but the last in a global ring of
:func:`ring_chunks` chunks that stays in L2) on systems of enough chunks to
keep every SM busy; and ``"per-sweep"`` (one launch per step,
``2 * sweeps`` per apply) on the smaller ones, where the ring kernel's
chain of levels measured slower, and for strict offsets of the wrong sign
for their direction.  :func:`sgs_apply_windowed_plain` /
:func:`tri_pair_apply_windowed_plain` and :func:`sgs_apply_ring_plain` /
:func:`tri_pair_apply_ring_plain` replay the window and ring kernels'
decompositions (tiles or chunk tickets, cones, rings and their index math)
in PyTorch; the tests and ``chip_smoke.py`` hold them against the plain
versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .dia_spmv import _DTYPES, _MAX_DIAGS, dia_spmv_padded_plain

__all__ = [
    "sgs_apply_fused", "tri_pair_apply_fused", "sgs_apply_plain", "tri_pair_apply_plain",
    "sgs_apply_ring_plain", "tri_pair_apply_ring_plain", "RingPlan", "ring_plan", "ring_chunk",
    "variant_of", "launches", "reset_launch_counts",
]

# csrc/trisweep.cu's window and ring kernels: rows per chunk; the window
# kernels' chunks of operands in flight, and the dynamic shared memory of a
# CTA (the 227 KB one block may use, less the kernel's static copy of the
# 64 offsets)
CHUNK = 1024
_STAGES = 3
_SMEM_BYTES = 232448 - 4 * _MAX_DIAGS
# The window kernels run while the halo is shorter than this many tiles.
# On an H100, 3-D 7- and 27-point systems of 14 K-1 M rows at sweeps 2 and
# 4: up to 1.76 tiles the window kernels were 6-22% faster than the
# per-sweep ones or equal; from 2 tiles on they were 1-44% slower, except
# the smallest system (64 K rows, 4.7 tiles) in float32
# (tools/trisweep_ab.py).
_HALO_TILES = 2
# ... or where the layout is one chunk an SM and a CTA's window, its tile and
# its halo, holds at most this many bytes of a vector: there the per-sweep
# kernels' 2 * sweeps launches cost more than the window's repeated halo
# rows.  On an H100 at sweeps 4 (tools/trisweep_ab.py): poisson_3d(40)
# float32 (23 KB) 0.0122-0.0125 ms against the per-sweep kernels'
# 0.0155-0.0156 and the ring kernel's 0.0295; float64 (46 KB) 0.0161-0.0171
# against 0.0162-0.0163; poisson_3d(64) float32 (two chunks an SM) 0.0241
# against 0.0197.
_SMALL_WINDOW_BYTES = 32768
# The ring kernel takes a large-reach shape where, in each direction with a
# sweep, its chunks are at least this many per SM, and the general
# instantiation keeps its diagonals in shared memory; else the per-sweep
# kernels do.  On an H100, SGS(4) on poisson_3d (tools/trisweep_ab.py),
# the ring kernel against the per-sweep kernels by chunks an SM: 0.5 (m =
# 64 float32) 0.65x, 0.7 (72) 0.79x, 1.0 (64 float64) 0.71x, 1.3 (88)
# 0.97x, 1.4 (72 float64) 0.89x; 1.7 (96) 1.13x, 1.9 (100) 1.16x, 2.6 (88
# float64) 1.03x, 3.3 (96 float64) 1.39x, 3.8 (100 float64) 1.51x; 1.80x at
# poisson_3d(243) float32, 1.35x at poisson_3d_27pt(128) float32, and 0.78x
# at poisson_3d_27pt(128) float64 (its diagonals read at every level).
_RING_CHUNKS_PER_SM = 1.5

# Kernel applies per wrapper, counted where the kernels are launched.
launches = {"sgs_apply": 0, "tri_pair_apply": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


# -- plain versions: the kernels' operations in the kernels' order -------------


def _sweeps_plain(pfac, invd: torch.Tensor, rhs: torch.Tensor, sweeps: int) -> torch.Tensor:
    x = rhs * invd
    if pfac is None:
        return x
    for _ in range(sweeps - 1):
        nx = dia_spmv_padded_plain(pfac.diags_p, pfac.offsets, pfac.lead, pfac.shape[0], x)
        x = (rhs - nx) * invd
    return x


def sgs_apply_plain(psgs, rp: torch.Tensor) -> torch.Tensor:
    """Plain K4: forward sweeps, ``diag * x``, backward sweeps."""
    y = _sweeps_plain(psgs.p_lower, psgs.inv_diag_p, rp, psgs.sweeps)
    return _sweeps_plain(psgs.p_upper, psgs.inv_diag_p, psgs.diag_p * y, psgs.sweeps)


def tri_pair_apply_plain(pair, rp: torch.Tensor) -> torch.Tensor:
    """Plain K5: forward sweeps with ``invd_l``, backward with ``invd_u``."""
    y = _sweeps_plain(pair.p_lower, pair.inv_diag_l_p, rp, pair.sweeps)
    return _sweeps_plain(pair.p_upper, pair.inv_diag_u_p, y, pair.sweeps)


# -- the window kernels' decomposition ----------------------------------------


def ring_rows(reach: int, chunk: int = CHUNK) -> int:
    """Rows of one level's ring: ``reach`` rounded up to whole chunks, plus
    the chunk itself (csrc/trisweep.cu ``ring_rows``)."""
    return (-(-reach // chunk) + 1) * chunk


def _offsets(p) -> tuple:
    return () if p is None else tuple(map(int, p.offsets))


def _reach(offsets: tuple) -> int:
    return max((abs(o) for o in offsets), default=0)


def _levels(offsets: tuple, sweeps: int) -> int:
    return int(sweeps) if offsets else 1


def _window_smem(offsets: tuple, sweeps: int, fixed: int, itemsize: int) -> int:
    """Shared memory of one direction's window kernel: the rings of every
    level but the last, and the staging of ``_STAGES`` chunks of operands
    (``fixed`` vectors, and the strict diagonals when there is a sweep)."""
    levels = _levels(offsets, sweeps)
    if levels == 1:  # a scale: no ring, and no diagonals to stage
        return itemsize * _STAGES * fixed * CHUNK
    rings = (levels - 1) * ring_rows(_reach(offsets))
    return itemsize * (rings + _STAGES * (fixed + len(offsets)) * CHUNK)


def window_tile(pre, num_sms: int, itemsize: int) -> int:
    """The window kernels' tile (rows per CTA) for an apply of ``pre`` on a
    card of ``num_sms`` SMs, or 0 where :func:`variant_of` picks another
    variant."""
    return _rule_of(pre, num_sms, itemsize)[1]


def variant_of(pre, num_sms: int, itemsize: int) -> str:
    """The rule that picks an apply's variant on the card: ``"window"``,
    ``"ring"`` or ``"per-sweep"``.

    The window kernels' tile is the layout's chunks split evenly over
    ``num_sms`` CTAs, one per SM.  They run when, in both directions, the
    rings of ``levels - 1`` levels of ``ring_rows(reach)`` and the operand
    staging fit the block's shared memory, and the halo ``(levels - 1) *
    reach`` is shorter than ``_HALO_TILES`` tiles (every CTA sweeps its halo
    again) or, with a tile of one chunk, the tile and the halo hold at most
    ``_SMALL_WINDOW_BYTES`` of a vector.  ``levels`` is ``sweeps``, or 1 for
    an empty strict part; ``reach`` is the direction's largest ``|offset|``.
    Of the other shapes the ring kernel takes those where, in each direction
    with a sweep, its chunks (:func:`ring_chunk`) are at least
    ``_RING_CHUNKS_PER_SM`` an SM, and the general instantiation keeps its
    diagonals in shared memory (:func:`_ring_resident`); the per-sweep
    kernels take the rest, and strict offsets of the wrong sign for their
    direction (L's must be negative, U's positive), which neither ordered
    walk can take."""
    return _rule_of(pre, num_sms, itemsize)[0]


def ring_chunk(nd: int, sweeps: int, itemsize: int) -> int:
    """Rows per chunk of one direction of the ring kernel with ``nd``
    strict diagonals (csrc/trisweep.cu ``ring_threads`` times
    ``ring_rows_per_thread``): 16 KB of each operand with 1-4 diagonals
    under a sweep, else 1,024 rows."""
    if 1 <= nd <= 4 and sweeps > 1:
        return 256 * (64 // itemsize)
    return 1024


def _ring_resident(nd: int, itemsize: int) -> bool:
    """Whether the ring kernel keeps a chunk's diagonals in shared memory:
    always with 1-4, the general instantiation's while a chunk's operands
    and level copies take at most half the block's shared memory
    (csrc/trisweep.cu ``ring_smem``)."""
    return nd <= 4 or (4 + nd) * ring_chunk(nd, 2, itemsize) * itemsize <= _SMEM_BYTES // 2


def _rule_of(pre, num_sms: int, itemsize: int) -> tuple:
    return _rule(_offsets(pre.p_lower), _offsets(pre.p_upper), pre.n_total, int(pre.sweeps),
                 hasattr(pre, "diag_p"), num_sms, itemsize)


@functools.lru_cache(maxsize=256)
def _rule(lower: tuple, upper: tuple, n_total: int, sweeps: int, sgs: bool,
          num_sms: int, itemsize: int) -> tuple:
    """``(variant, tile)`` of :func:`variant_of` on plain values, worked out
    once per layout; the tile is 0 but for the window kernels."""
    sides = ((lower, 2, -1), (upper, 3 if sgs else 2, 1))
    if any(o * sign <= 0 for offsets, _, sign in sides for o in offsets):
        return "per-sweep", 0
    tile = -(-n_total // (CHUNK * num_sms)) * CHUNK

    def halo_fits(halo: int) -> bool:
        return halo < _HALO_TILES * tile or (
            tile == CHUNK and (tile + halo) * itemsize <= _SMALL_WINDOW_BYTES)

    if all(_window_smem(offsets, sweeps, fixed, itemsize) <= _SMEM_BYTES
           and halo_fits((_levels(offsets, sweeps) - 1) * _reach(offsets))
           for offsets, fixed, _ in sides):
        return "window", int(tile)
    swept = [o for o, _, _ in sides if _levels(o, sweeps) > 1]
    if all(_ring_resident(len(o), itemsize)
           and -(-n_total // ring_chunk(len(o), sweeps, itemsize))
           >= _RING_CHUNKS_PER_SM * num_sms for o in swept):
        return "ring", 0
    return "per-sweep", 0


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def variant(pre, device) -> str:
    """``"window"``, ``"ring"`` or ``"per-sweep"``: the variant an apply of
    ``pre`` takes on the CUDA ``device`` (the rule of :func:`variant_of`)."""
    device = torch.device(device)
    itemsize = torch.empty((), dtype=pre.dtype).element_size()
    return variant_of(pre, _num_sms(device.index or 0), itemsize)


def _direction_windowed(pfac, invd, src, mid, pre, tile: int, chunk: int,
                        forward: bool) -> torch.Tensor:
    """One direction of csrc/trisweep.cu's window kernel, tile by tile and
    chunk by chunk: each level of a chunk computes its cone's rows at once,
    reading the previous level from a ring of ``ring_rows(reach, chunk)``
    rows that starts as NaN.  The kernel also computes a chunk's rows
    outside the cone, into ring slots that no row of the cone may read; here
    they stay NaN, so a cone row that read one, or a slot the kernel has not
    written, shows in the result."""
    n_total, lead, n_rows = pre.n_total, pre.lead, pre.shape[0]
    offsets = _offsets(pfac)
    levels = _levels(offsets, pre.sweeps)
    reach = _reach(offsets)
    rows = ring_rows(reach, chunk) if levels > 1 else chunk
    out = torch.empty_like(src)
    for seg0 in range(0, n_total, tile):
        seg1 = min(seg0 + tile, n_total)

        def lo(k):
            return max(seg0 - (levels - 1 - k) * reach, 0) if forward else seg0

        def hi(k):
            return seg1 if forward else min(seg1 + (levels - 1 - k) * reach, n_total)

        chunks = range(lo(0) // chunk, -(-hi(0) // chunk))
        ring = torch.full((max(levels - 1, 1), rows), float("nan"), dtype=src.dtype,
                          device=src.device)
        for cidx in (chunks if forward else reversed(chunks)):
            c0 = cidx * chunk
            e = torch.arange(c0, min(c0 + chunk, n_total), device=src.device)
            data = (e >= lead) & (e < lead + n_rows) & (e >= lo(0)) & (e < hi(0))
            rhs = src[e] if mid is None else mid[e] * src[e]
            pos = (cidx % (rows // chunk)) * chunk + (e - c0)
            for k in range(levels):
                sel = (e >= lo(k)) & (e < hi(k))
                if not bool(sel.any()):
                    continue
                if k == 0:
                    v = rhs * invd[e]
                else:
                    acc = None
                    for d, off in enumerate(offsets):
                        t = pfac.diags_p[d, e] * ring[k - 1, (pos + off) % rows]
                        acc = t if acc is None else acc + t
                    v = (rhs - acc) * invd[e]
                v = torch.where(data, v, torch.zeros((), dtype=v.dtype, device=v.device))
                if k == levels - 1:
                    out[e[sel]] = v[sel]
                else:
                    ring[k, pos[sel]] = v[sel]
    return out


def _check_tile(tile: int, chunk: int) -> None:
    if chunk < 1 or tile < chunk or tile % chunk:
        raise ValueError(f"tile {tile} must be a positive multiple of the chunk {chunk}: the "
                         "window kernel refuses any other")


def sgs_apply_windowed_plain(psgs, rp: torch.Tensor, tile: int,
                             chunk: int = CHUNK) -> torch.Tensor:
    """K4's window kernels replayed in PyTorch on tiles of ``tile`` rows and
    chunks of ``chunk``: equal to :func:`sgs_apply_plain` bit for bit."""
    _check_tile(tile, chunk)
    y = _direction_windowed(psgs.p_lower, psgs.inv_diag_p, rp, None, psgs, tile, chunk, True)
    return _direction_windowed(psgs.p_upper, psgs.inv_diag_p, y, psgs.diag_p, psgs, tile,
                               chunk, False)


def tri_pair_apply_windowed_plain(pair, rp: torch.Tensor, tile: int,
                                  chunk: int = CHUNK) -> torch.Tensor:
    """K5's window kernels replayed in PyTorch (as
    :func:`sgs_apply_windowed_plain`): equal to :func:`tri_pair_apply_plain`."""
    _check_tile(tile, chunk)
    y = _direction_windowed(pair.p_lower, pair.inv_diag_l_p, rp, None, pair, tile, chunk, True)
    return _direction_windowed(pair.p_upper, pair.inv_diag_u_p, y, None, pair, tile, chunk,
                               False)


# -- the ring kernel's decomposition -------------------------------------------


def ring_chunks(reach: int, grid: int, chunk: int = CHUNK) -> int:
    """Chunks of one level's ring in the ring kernel: the reach in whole
    chunks and the chunk itself (the least the C entry takes), and one per
    CTA in flight, so that a chunk seldom waits for the readers of the slot
    it overwrites."""
    return -(-reach // chunk) + 1 + grid


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """What the ring kernel is launched with: at most ``grid`` CTAs a
    direction, chunks of ``chunk_l`` rows forward and ``chunk_u`` backward,
    and rings of ``ring_rows`` rows for ``ring_levels`` levels (the deeper
    direction's but its last), shared by the two directions."""

    grid: int
    chunk_l: int
    chunk_u: int
    ring_rows: int
    ring_levels: int


def ring_plan(pre, grid: int, chunk_l: int = CHUNK, chunk_u: int = CHUNK) -> RingPlan:
    """The ring kernel's plan for ``pre`` at ``grid`` CTAs and the given
    chunks: each direction's ring holds ``ring_chunks(reach, grid, chunk)``
    of its chunks, and the shared ring the larger, in whole chunks of both."""
    return _ring_layout(_offsets(pre.p_lower), _offsets(pre.p_upper), int(pre.sweeps), grid,
                        chunk_l, chunk_u)


def _ring_layout(lower: tuple, upper: tuple, sweeps: int, grid: int, chunk_l: int,
                 chunk_u: int) -> RingPlan:
    rows, levels = 0, 1
    for offsets, chunk in ((lower, chunk_l), (upper, chunk_u)):
        if _levels(offsets, sweeps) > 1:
            rows = max(rows, ring_chunks(_reach(offsets), grid, chunk) * chunk)
            levels = max(levels, _levels(offsets, sweeps))
    whole = max(chunk_l, chunk_u)
    return RingPlan(grid, chunk_l, chunk_u, -(-rows // whole) * whole, levels - 1)


def _direction_ring(pfac, invd, src, mid, pre, chunk: int, ring_rows: int,
                    forward: bool) -> torch.Tensor:
    """One direction of csrc/trisweep.cu's ring kernel, chunk by chunk in
    ticket order (ascending forward, descending backward; one valid order of
    the CTAs' work): every level of a chunk at once, the previous level read
    from the chunk's own copy for its own rows and from the level's ring of
    ``ring_rows`` rows (chunk c in slot ``c % (ring_rows // chunk)``) for
    the rows behind it, with the kernel's wrap-around index math.  The rings
    start as NaN, and each slot remembers the chunk that wrote it: a row read
    from a slot that now holds another chunk (a ring too short, a slot
    reused too soon) reads NaN, as does an unwritten one, so either shows in
    the result."""
    n_total, lead, n_rows = pre.n_total, pre.lead, pre.shape[0]
    offsets = _offsets(pfac)
    levels = _levels(offsets, pre.sweeps)
    nchunks = -(-n_total // chunk)
    rows = ring_rows if levels > 1 else chunk
    rc = rows // chunk
    dev, dtype = src.device, src.dtype
    ring = torch.full((max(levels - 1, 1), rows), float("nan"), dtype=dtype, device=dev)
    owner = torch.full((max(levels - 1, 1), rc), torch.iinfo(torch.long).min, dtype=torch.long,
                       device=dev)
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    out = torch.empty_like(src)
    r = torch.arange(chunk, device=dev)
    for t in range(nchunks):
        c = t if forward else nchunks - 1 - t
        c0, p0 = c * chunk, (c % rc) * chunk
        e = c0 + r
        inside = e < n_total
        ec = e.clamp(max=n_total - 1)
        data = (e >= lead) & (e < lead + n_rows)
        rhs = src[ec] if mid is None else mid[ec] * src[ec]
        prev = None
        for k in range(levels):
            if k == 0:
                v = rhs * invd[ec]
            else:
                acc = None
                for d, off in enumerate(offsets):
                    rel = r + off
                    own = rel >= 0 if forward else rel < chunk
                    q = (p0 + rel) % rows
                    held = owner[k - 1, q // chunk] == torch.div(c0 + rel, chunk,
                                                                 rounding_mode="floor")
                    x = torch.where(own, prev[rel.clamp(0, chunk - 1)],
                                    torch.where(held, ring[k - 1, q], nan))
                    term = pfac.diags_p[d, ec] * x
                    acc = term if acc is None else acc + term
                v = (rhs - acc) * invd[ec]
            v = torch.where(data, v, zero)
            if k == levels - 1:
                out[e[inside]] = v[inside]
            else:
                ring[k, p0:p0 + chunk] = v
                owner[k, c % rc] = c
                prev = v
    return out


def sgs_apply_ring_plain(psgs, rp: torch.Tensor, plan: Optional[RingPlan] = None) -> torch.Tensor:
    """K4's ring kernel replayed in PyTorch with ``plan``'s chunks and rings
    (default ``ring_plan(psgs, 0)``: chunks of :data:`CHUNK` rows, the least
    rings): equal to :func:`sgs_apply_plain` bit for bit."""
    plan = plan or ring_plan(psgs, 0)
    y = _direction_ring(psgs.p_lower, psgs.inv_diag_p, rp, None, psgs, plan.chunk_l,
                        plan.ring_rows, True)
    return _direction_ring(psgs.p_upper, psgs.inv_diag_p, y, psgs.diag_p, psgs, plan.chunk_u,
                           plan.ring_rows, False)


def tri_pair_apply_ring_plain(pair, rp: torch.Tensor,
                              plan: Optional[RingPlan] = None) -> torch.Tensor:
    """K5's ring kernel replayed in PyTorch (as :func:`sgs_apply_ring_plain`):
    equal to :func:`tri_pair_apply_plain`."""
    plan = plan or ring_plan(pair, 0)
    y = _direction_ring(pair.p_lower, pair.inv_diag_l_p, rp, None, pair, plan.chunk_l,
                        plan.ring_rows, True)
    return _direction_ring(pair.p_upper, pair.inv_diag_u_p, y, None, pair, plan.chunk_u,
                           plan.ring_rows, False)


# -- wrappers ------------------------------------------------------------------


def _check(pre, vectors, rp: torch.Tensor) -> None:
    if rp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rp.device}")
    if rp.dtype not in _DTYPES:
        raise TypeError(f"r is {rp.dtype}; the kernel takes float32 or float64")
    if rp.shape != (pre.n_total,) or not rp.is_contiguous():
        raise ValueError(f"r has shape {tuple(rp.shape)}, expected a contiguous "
                         f"({pre.n_total},) vector in the padded layout")
    if int(pre.sweeps) < 1:
        raise ValueError(f"sweeps is {pre.sweeps}; the apply needs at least 1")
    tensors = list(vectors) + [p.diags_p for p in (pre.p_lower, pre.p_upper) if p is not None]
    for t in tensors:
        if t.device != rp.device or t.dtype != rp.dtype:
            raise TypeError(f"a factor is {t.dtype} on {t.device} but r is {rp.dtype} "
                            f"on {rp.device}")
        if t.shape[-1] != pre.n_total or not t.is_contiguous():
            raise ValueError("factors must be contiguous and laid out over n_total elements")
    for p in (pre.p_lower, pre.p_upper):
        if p is not None and not 1 <= len(p.offsets) <= _MAX_DIAGS:
            raise ValueError(f"{len(p.offsets)} strict diagonals; the kernel takes "
                             f"1..{_MAX_DIAGS}")


@functools.lru_cache(maxsize=256)
def _offsets_array(offsets: tuple) -> np.ndarray:
    """The int32 offsets the C entry reads (one 0 for an empty factor); kept
    by the cache, so it outlives every call that passes its address."""
    return np.asarray(offsets or (0,), dtype=np.int32)


def _factor_args(p):
    """(diagonals pointer, offsets address, count) of a strict factor, or
    null/empty for an empty one."""
    if p is None:
        return None, _offsets_array(()).ctypes.data, 0
    return p.diags_p.data_ptr(), _offsets_array(tuple(p.offsets)).ctypes.data, len(p.offsets)


@functools.cache
def _prepare(index: int) -> None:
    """The sweep kernels' opt-in to the shared memory of card ``index``,
    once, before its first apply or capture."""
    from . import _build

    with torch.cuda.device(index):
        _build.check(_build.library().smm_trisweep_prepare(), "sgs_apply / tri_pair_apply "
                     "(the opt-in to shared memory)")


@functools.lru_cache(maxsize=256)
def _ring_plan(lower: tuple, upper: tuple, n_total: int, sweeps: int, sgs: bool, f64: bool,
               index: int) -> RingPlan:
    """The ring kernel's plan for a layout on card ``index``: as many
    persistent CTAs as the card holds (the C query's occupancy, the smaller
    of the two directions'), at most one per chunk, and the query's chunks."""
    from . import _build

    _prepare(index)
    blocks, chunk_l, chunk_u = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        code = _build.library().smm_trisweep_ring_blocks_per_sm(
            int(f64), int(sgs), len(lower), len(upper), sweeps, ctypes.byref(blocks),
            ctypes.byref(chunk_l), ctypes.byref(chunk_u))
    _build.check(code, "sgs_apply / tri_pair_apply (the ring kernel's occupancy)")
    itemsize = 8 if f64 else 4
    if (chunk_l.value, chunk_u.value) != (ring_chunk(len(lower), sweeps, itemsize),
                                          ring_chunk(len(upper), sweeps, itemsize)):
        raise RuntimeError(f"the ring kernel's chunks {chunk_l.value}, {chunk_u.value} are not "
                           "ring_chunk's: csrc/trisweep.cu and ops/trisweep.py disagree")
    grid = min(-(-n_total // min(chunk_l.value, chunk_u.value)),
               max(blocks.value, 1) * _num_sms(index))
    return _ring_layout(lower, upper, sweeps, grid, chunk_l.value, chunk_u.value)


def _apply_variant(pre, rp: torch.Tensor, variant: str, tile: int = 0) -> torch.Tensor:
    """K4 or K5 on the card in the given variant (``"window"`` at ``tile``
    rows, ``"ring"`` at the plan of :func:`_ring_plan`, or ``"per-sweep"``),
    whatever the rule would pick, counted like the wrappers: the card tests
    hold every variant to the plain version with it."""
    from . import _build

    sgs = hasattr(pre, "diag_p")
    _check(pre, (pre.inv_diag_p, pre.diag_p) if sgs else (pre.inv_diag_l_p, pre.inv_diag_u_p),
           rp)
    if rp.device.type != "cuda":
        raise ValueError("_apply_variant launches a kernel: rp must be a CUDA tensor")
    lib = _build.library()
    f64 = rp.dtype == torch.float64
    if sgs:
        fn = lib.smm_sgs_apply_f64 if f64 else lib.smm_sgs_apply_f32
        return _launch("sgs_apply", fn, pre, rp, pre.inv_diag_p, pre.diag_p, variant, tile)
    fn = lib.smm_tri_pair_apply_f64 if f64 else lib.smm_tri_pair_apply_f32
    return _launch("tri_pair_apply", fn, pre, rp, pre.inv_diag_l_p, pre.inv_diag_u_p, variant,
                   tile)


def _launch(name: str, fn, pre, rp: torch.Tensor, first, second, kind: str,
            tile: int) -> torch.Tensor:
    from . import _build

    index = rp.device.index
    _prepare(index)
    ld, l_offs, nd_l = _factor_args(pre.p_lower)
    ud, u_offs, nd_u = _factor_args(pre.p_upper)
    if kind != "per-sweep" and rp.data_ptr() % 16:
        rp = rp.clone()  # the window and ring kernels copy 16-byte runs of every vector
    # every variant needs one scratch vector, the per-sweep kernels two
    w0, out = torch.empty_like(rp), torch.empty_like(rp)
    w1 = torch.empty_like(rp) if kind == "per-sweep" else None
    ring = sync = None
    plan = RingPlan(0, CHUNK, CHUNK, 0, 0)
    if kind == "ring":
        plan = _ring_plan(_offsets(pre.p_lower), _offsets(pre.p_upper), pre.n_total,
                          int(pre.sweeps), hasattr(pre, "diag_p"), rp.dtype == torch.float64,
                          index)
        sync = torch.empty(2 + 2 * -(-pre.n_total // CHUNK), dtype=torch.int32,
                           device=rp.device)
        if plan.ring_levels:
            ring = torch.empty(plan.ring_levels * plan.ring_rows, dtype=rp.dtype,
                               device=rp.device)
    with torch.cuda.device(rp.device):
        code = fn(rp.data_ptr(), first.data_ptr(), second.data_ptr(), ld, l_offs, nd_l, ud,
                  u_offs, nd_u, w0.data_ptr(), None if w1 is None else w1.data_ptr(),
                  out.data_ptr(), int(pre.sweeps), pre.n_total, pre.lead, pre.shape[0],
                  {"window": tile, "ring": 0, "per-sweep": -1}[kind],
                  None if ring is None else ring.data_ptr(), plan.ring_rows,
                  None if sync is None else sync.data_ptr(), plan.grid,
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, name)
    launches[name] += 1
    return out


def sgs_apply_fused(psgs, rp: torch.Tensor) -> torch.Tensor:
    """K4: z = M^{-1} r for a PaddedSGS, r and z in the padded layout; guard
    rows of z are exactly 0."""
    _check(psgs, (psgs.inv_diag_p, psgs.diag_p), rp)
    if rp.device.type == "cpu":
        return sgs_apply_plain(psgs, rp)
    from . import _build

    lib = _build.library()
    fn = lib.smm_sgs_apply_f32 if rp.dtype == torch.float32 else lib.smm_sgs_apply_f64
    return _launch("sgs_apply", fn, psgs, rp, psgs.inv_diag_p, psgs.diag_p,
                   *_rule_of(psgs, _num_sms(rp.device.index), rp.element_size()))


def tri_pair_apply_fused(pair, rp: torch.Tensor) -> torch.Tensor:
    """K5: z = (L U)^{-1} r for a PaddedTriPair, r and z in the padded
    layout; guard rows of z are exactly 0."""
    _check(pair, (pair.inv_diag_l_p, pair.inv_diag_u_p), rp)
    if rp.device.type == "cpu":
        return tri_pair_apply_plain(pair, rp)
    from . import _build

    lib = _build.library()
    fn = lib.smm_tri_pair_apply_f32 if rp.dtype == torch.float32 else lib.smm_tri_pair_apply_f64
    return _launch("tri_pair_apply", fn, pair, rp, pair.inv_diag_l_p, pair.inv_diag_u_p,
                   *_rule_of(pair, _num_sms(rp.device.index), rp.element_size()))
