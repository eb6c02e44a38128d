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
for their direction.  An SGS whose factors hold a constant-coefficient grid
stencil (:func:`constant_stencil` finds one in the stored values when the
factors are built; each strict part is then a :class:`ScalarFactor`) takes,
where the window kernels do not, ``"scalar"``: the per-sweep scheme with
each strict diagonal read as one scalar and its face mask computed from the
row's grid position, the init step inside the first sweep (``sweeps - 1``
launches a direction); :func:`sgs_apply_scalar_plain` replays it.
:data:`variant_launches` counts the applies of each variant.
:func:`sgs_apply_windowed_plain` /
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
from typing import Optional, Tuple

import numpy as np
import torch

from .dia_spmv import _DTYPES, _MAX_DIAGS, dia_spmv_padded_plain

__all__ = [
    "sgs_apply_fused", "tri_pair_apply_fused", "sgs_apply_plain", "tri_pair_apply_plain",
    "sgs_apply_ring_plain", "tri_pair_apply_ring_plain", "RingPlan", "ring_plan", "ring_chunk",
    "variant_of", "launches", "variant_launches", "reset_launch_counts", "ScalarFactor",
    "constant_stencil", "sgs_apply_scalar_plain",
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

# Kernel applies per wrapper, and per variant, and the launches of
# constant_stencil's check kernel, counted where the kernels are launched.
launches = {"sgs_apply": 0, "tri_pair_apply": 0, "stencil_check": 0}
variant_launches = {"window": 0, "ring": 0, "per-sweep": 0, "scalar": 0}


def reset_launch_counts() -> None:
    for counts in (launches, variant_launches):
        for name in counts:
            counts[name] = 0


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
    ``"scalar"``, ``"ring"`` or ``"per-sweep"``.

    The window kernels' tile is the layout's chunks split evenly over
    ``num_sms`` CTAs, one per SM.  They run when, in both directions, the
    rings of ``levels - 1`` levels of ``ring_rows(reach)`` and the operand
    staging fit the block's shared memory, and the halo ``(levels - 1) *
    reach`` is shorter than ``_HALO_TILES`` tiles (every CTA sweeps its halo
    again) or, with a tile of one chunk, the tile and the halo hold at most
    ``_SMALL_WINDOW_BYTES`` of a vector.  ``levels`` is ``sweeps``, or 1 for
    an empty strict part; ``reach`` is the direction's largest ``|offset|``.
    Of the other shapes an SGS of a constant-coefficient stencil
    (:func:`_is_scalar`) takes the scalar variant; of the rest the ring
    kernel takes those where, in each direction
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
                 hasattr(pre, "diag_p"), num_sms, itemsize, _is_scalar(pre))


@functools.lru_cache(maxsize=256)
def _rule(lower: tuple, upper: tuple, n_total: int, sweeps: int, sgs: bool,
          num_sms: int, itemsize: int, scalar: bool) -> tuple:
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
    if scalar:
        return "scalar", 0
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
    """``"window"``, ``"scalar"``, ``"ring"`` or ``"per-sweep"``: the variant
    an apply of ``pre`` takes on the CUDA ``device`` (the rule of
    :func:`variant_of`)."""
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


# -- constant-coefficient stencils: the scalar variant ---------------------------

# csrc/trisweep.cu's face bits: the faces of the grid a diagonal's neighbour
# crosses when its row lies on them (a row's own faces are the same bits)
_X_LO, _X_HI, _Y_LO, _Y_HI, _Z_LO, _Z_HI = 1, 2, 4, 8, 16, 32
# the scalar variant's global rows are 32-bit on the card
_MAX_GLOBAL_ROWS = 2 ** 31 - 1


def _split(off: int, nx: int, ny: int) -> Tuple[int, int, int]:
    """``off`` as the nearest steps ``(dx, dy, dz)`` on a grid of rows of
    ``nx`` points and planes of ``ny`` rows (0: a 2-D grid)."""
    plane = nx * ny
    dz = (off + plane // 2) // plane if plane else 0
    rest = off - dz * plane
    dy = (rest + nx // 2) // nx
    return rest - dy * nx, dy, dz


@functools.lru_cache(maxsize=256)
def _grid_of(offsets: tuple) -> Optional[Tuple[int, int]]:
    """The grid ``(nx, ny)`` (``ny`` 0: a 2-D grid) on which ``offsets`` are
    neighbours at steps of -1, 0 or 1 an axis, from the offsets alone, or
    None (a 1-D stencil has no rows).  The nonzero ``|offset|`` fall in runs of one
    or three (a neighbour's x steps about its y and z step) with 1, the x
    neighbour, apart; the least centre of a run is ``nx``, and the plane's
    stride the next centre, or the one ``nx`` past it where that is a centre
    too (the next is then ``P - nx``: 19 and 27 points)."""
    values = sorted({abs(o) for o in offsets if o})
    if 1 in values and 2 in values:
        return None
    centres, run = [], []
    for a in [v for v in values if v != 1] + [None]:
        if run and (a is None or a != run[-1] + 1):
            if len(run) not in (1, 3):
                return None
            centres.append(run[len(run) // 2])
            run = []
        if a is not None:
            run.append(a)
    if not centres:
        return None
    nx, ny = centres[0], 0
    if len(centres) > 1:
        plane = centres[1] + nx if centres[1] + nx in centres else centres[1]
        if plane % nx:
            return None
        ny = plane // nx
    if any(max(map(abs, _split(o, nx, ny))) > 1 for o in offsets):
        return None
    return nx, ny


def _faces(offsets: tuple, nx: int, ny: int) -> Tuple[int, ...]:
    """The faces each offset's neighbour crosses (csrc/trisweep.cu's bits)."""
    out = []
    for off in offsets:
        dx, dy, dz = _split(off, nx, ny)
        out.append((dx < 0) * _X_LO | (dx > 0) * _X_HI | (dy < 0) * _Y_LO | (dy > 0) * _Y_HI
                   | (dz < 0) * _Z_LO | (dz > 0) * _Z_HI)
    return tuple(out)


def _row_faces(g: torch.Tensor, nx: int, ny: int, n_global: int) -> torch.Tensor:
    """The faces global rows ``g`` lie on (csrc/trisweep.cu ``faces_at``): x
    and y by the position in the line and plane, the outermost axis (z, or y
    on a 2-D grid) by the system's first and last plane (line)."""
    ix = g % nx
    at = (ix == 0) * _X_LO + (ix == nx - 1) * _X_HI
    outer, lo, hi = nx, _Y_LO, _Y_HI
    if ny:
        iy = (g // nx) % ny
        at = at + (iy == 0) * _Y_LO + (iy == ny - 1) * _Y_HI
        outer, lo, hi = nx * ny, _Z_LO, _Z_HI
    return at + (g < outer) * lo + (g >= n_global - outer) * hi


def _inside(faces: int, at: torch.Tensor) -> torch.Tensor:
    """Whether each row's neighbour across ``faces`` lies inside the grid:
    the stored diagonal holds its one value there, an exact 0 elsewhere."""
    return (at & faces) == 0


def _interior_row(nx: int, ny: int, reach: int, row0: int, rows: int,
                  n_global: int) -> Optional[int]:
    """The first global row of ``[row0, row0 + rows)`` whose every neighbour
    lies inside the grid (x and y positions 1, ``reach`` rows from either
    end of the system), or None."""
    if nx < 3 or 0 < ny < 3:
        return None
    outer, first = (nx * ny, nx + 1) if ny else (nx, 1)
    g = -(-(max(row0, reach) - first) // outer) * outer + first
    return g if g < row0 + rows and g + reach < n_global else None


@dataclasses.dataclass(frozen=True)
class ScalarFactor:
    """A strict factor of a constant-coefficient grid stencil: diagonal
    ``k`` is ``coefs[k]`` on the data rows whose neighbour at ``offsets[k]``
    lies inside the grid of ``nx`` points a row and ``ny`` rows a plane (0:
    no such axis; the outermost axis ends with the system's ``n_global``
    rows), and an exact 0 elsewhere.  The data rows are global rows from
    ``row0``, at ``lead`` in the padded layout.  ``const_diag`` is ``(d,
    1 / d)``, the one value of the SGS's main diagonal and of its inverse on
    the data rows.  The scalar variant reads ``coefs`` and ``const_diag``;
    :attr:`diags_p` lays the diagonals out as a
    :class:`~.dia_spmv.PaddedDIA` holds them, at first use, for the plain
    versions and the other variants."""

    offsets: Tuple[int, ...]
    coefs: Tuple[float, ...]
    const_diag: Tuple[float, float]
    nx: int
    ny: int
    row0: int
    n_global: int
    shape: Tuple[int, int]
    lead: int
    n_total: int
    dtype: torch.dtype
    device: torch.device

    @functools.cached_property
    def faces(self) -> Tuple[int, ...]:
        return _faces(self.offsets, self.nx, self.ny)

    def coef_rows(self, k: int, g: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
        """Diagonal ``k`` on global rows ``g`` (on faces ``at``), as the
        scalar variant forms it."""
        c = torch.tensor(self.coefs[k], dtype=self.dtype, device=self.device)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        return torch.where(_inside(self.faces[k], at), c, zero)

    @functools.cached_property
    def diags_p(self) -> torch.Tensor:
        n = self.shape[0]
        out = torch.zeros((len(self.offsets), self.n_total), dtype=self.dtype, device=self.device)
        g = torch.arange(self.row0, self.row0 + n, device=self.device)
        at = _row_faces(g, self.nx, self.ny, self.n_global)
        for k in range(len(self.offsets)):
            out[k, self.lead:self.lead + n] = self.coef_rows(k, g, at)
        return out

    @functools.cached_property
    def c_args(self) -> tuple:
        """The C entry's offsets, faces and values, kept as long as the
        factor (the entry reads them by address)."""
        word = np.float64 if self.dtype == torch.float64 else np.float32
        return (np.asarray(self.offsets, dtype=np.int32), np.asarray(self.faces, dtype=np.int32),
                np.asarray(self.coefs, dtype=word))

    def astype(self, dtype: torch.dtype) -> "ScalarFactor":
        """The factor in ``dtype``, each value rounded as the padded
        vectors' ``.to(dtype)`` rounds it."""
        def cast(values):
            return tuple(torch.tensor(values, dtype=self.dtype).to(dtype).tolist())

        return dataclasses.replace(self, coefs=cast(self.coefs),
                                   const_diag=cast(self.const_diag), dtype=dtype)


def _mismatch_plain(words, offsets, faces, inv_words, grid, first, rows, ref) -> torch.Tensor:
    """csrc/trisweep.cu ``scalar_check`` on the stored words: True where a
    row does not match."""
    nx, ny, row0, n_global = grid
    g = torch.arange(row0, row0 + rows, device=words.device)
    at = _row_faces(g, nx, ny, n_global)
    zero = torch.zeros((), dtype=words.dtype, device=words.device)
    bad = (inv_words[first:first + rows] != inv_words[ref]).any()
    for k, f in enumerate(faces):
        want = torch.where(_inside(f, at), words[k, ref], zero)
        bad |= (words[k, first:first + rows] != want).any()
    return bad


def constant_stencil(diags: torch.Tensor, offsets, inv_diag: torch.Tensor, first: int,
                     rows: int, row0: int, n_global: int, *, lead: int, n_total: int
                     ) -> Optional[Tuple[Optional[ScalarFactor], Optional[ScalarFactor]]]:
    """The strict parts ``(lower, upper)`` of stored DIA diagonals as
    :class:`ScalarFactor` objects (None for an empty one), where the
    diagonals hold a constant-coefficient grid stencil, found from the
    values and offsets alone; their data rows lie at ``lead`` of a padded
    layout of ``n_total`` rows.

    ``diags[k, first:first + rows]`` are diagonal ``offsets[k]`` (the main
    one among them) on global rows ``[row0, row0 + rows)`` of a system of
    ``n_global`` rows, and ``inv_diag`` is indexed as ``diags``' columns.
    The grid comes from the offsets (:func:`_grid_of`), each diagonal's
    value from a row whose every neighbour lies inside it; then one pass
    (csrc/trisweep.cu ``scalar_check`` on the card) checks, bit for bit,
    that every diagonal holds that value where its neighbour lies inside the
    grid and an exact 0 elsewhere, and that ``inv_diag`` is one value, and
    one host read brings the verdict and the values; ``launches["stencil_check"]``
    counts the check kernel's launches.  Returns None where any row differs,
    where the offsets fit no grid, or where the grid has no interior row in
    the range: the factors then keep their stored diagonals."""
    offsets = tuple(int(o) for o in offsets)
    if (diags.dtype not in _DTYPES or diags.device.type not in ("cpu", "cuda") or 0 not in offsets
            or len(offsets) < 2 or n_global > _MAX_GLOBAL_ROWS):
        return None
    grid = _grid_of(offsets)
    if grid is None:
        return None
    nx, ny = grid
    g = _interior_row(nx, ny, max(abs(o) for o in offsets), row0, rows, n_global)
    if g is None:
        return None
    ref = first + g - row0
    faces = _faces(offsets, nx, ny)
    diags = diags.contiguous()
    word = torch.int64 if diags.dtype == torch.float64 else torch.int32
    if diags.device.type == "cuda":
        from . import _build

        bad = torch.zeros((), dtype=torch.int32, device=diags.device)
        offs = np.asarray(offsets, dtype=np.int32)
        face_bits = np.asarray(faces, dtype=np.int32)
        with torch.cuda.device(diags.device):
            code = _build.library().smm_scalar_stencil_check(
                int(word == torch.int64), diags.data_ptr(), diags.stride(0), offs.ctypes.data,
                face_bits.ctypes.data, len(offsets), inv_diag.contiguous().data_ptr(), nx, ny,
                row0, n_global, first, rows, ref, bad.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        _build.check(code, "constant_stencil (the check of the stored diagonals)")
        launches["stencil_check"] += 1
    else:
        bad = _mismatch_plain(diags.view(word), offsets, faces, inv_diag.view(word),
                              (nx, ny, row0, n_global), first, rows, ref)
    read = torch.cat([diags[:, ref], inv_diag[ref:ref + 1], bad.to(diags.dtype).reshape(1)])
    *values, inv, verdict = read.tolist()
    if verdict:
        return None
    const_diag = (values[offsets.index(0)], inv)

    def part(sign: int) -> Optional[ScalarFactor]:
        keep = [k for k, o in enumerate(offsets) if o * sign > 0]
        if not keep:
            return None
        return ScalarFactor(offsets=tuple(offsets[k] for k in keep),
                            coefs=tuple(values[k] for k in keep), const_diag=const_diag, nx=nx,
                            ny=ny, row0=row0, n_global=n_global, shape=(rows, rows), lead=lead,
                            n_total=n_total, dtype=diags.dtype, device=diags.device)

    return part(-1), part(1)


def _is_scalar(pre) -> bool:
    """Whether ``pre`` is an SGS of a constant-coefficient stencil: its
    strict parts :class:`ScalarFactor` objects, one at least (each carries
    the main diagonal's one value)."""
    facs = [p for p in (pre.p_lower, pre.p_upper) if p is not None]
    return hasattr(pre, "diag_p") and bool(facs) and all(isinstance(p, ScalarFactor)
                                                         for p in facs)


def _direction_scalar(pfac, src: torch.Tensor, pre, mid: bool) -> torch.Tensor:
    """One direction of csrc/trisweep.cu's scalar variant: each diagonal's
    rows formed from its value and the face mask, the init step formed at
    each neighbour from ``src`` (an exact 0 off the data rows) inside the
    first sweep, and, with ``mid``, the rhs ``d * src``."""
    d, invd = (torch.tensor(v, dtype=src.dtype, device=src.device)
               for v in (pre.p_lower or pre.p_upper).const_diag)
    lead, n = pre.lead, pre.shape[0]
    rows = slice(lead, lead + n)
    rhs = d * src[rows] if mid else src[rows]
    if pfac is None or pre.sweeps == 1:
        out = torch.zeros_like(src)
        out[rows] = rhs * invd
        return out
    g = torch.arange(pfac.row0, pfac.row0 + n, device=src.device)
    at = _row_faces(g, pfac.nx, pfac.ny, pfac.n_global)
    coefs = [pfac.coef_rows(k, g, at) for k in range(len(pfac.offsets))]
    e = torch.arange(lead, lead + n, device=src.device)
    zero = torch.zeros((), dtype=src.dtype, device=src.device)
    x = None
    for _ in range(pre.sweeps - 1):
        acc = None
        for k, off in enumerate(pfac.offsets):
            if x is None:
                v = src[lead + off:lead + off + n]
                v = (d * v if mid else v) * invd
                xv = torch.where((e + off >= lead) & (e + off < lead + n), v, zero)
            else:
                xv = x[lead + off:lead + off + n]
            term = coefs[k] * xv
            acc = term if acc is None else acc + term
        x = torch.zeros_like(src)
        x[rows] = (rhs - acc) * invd
    return x


def sgs_apply_scalar_plain(psgs, rp: torch.Tensor) -> torch.Tensor:
    """K4's scalar variant replayed in PyTorch, for an SGS of a
    constant-coefficient stencil: equal to :func:`sgs_apply_plain` on the
    stored diagonals bit for bit."""
    if not _is_scalar(psgs):
        raise ValueError("the scalar variant takes an SGS of a constant-coefficient stencil")
    y = _direction_scalar(psgs.p_lower, rp, psgs, False)
    return _direction_scalar(psgs.p_upper, y, psgs, True)


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
    factors = [p for p in (pre.p_lower, pre.p_upper) if p is not None]
    for p in factors:
        if isinstance(p, ScalarFactor) and (p.dtype != rp.dtype or p.device != rp.device
                                            or p.n_total != pre.n_total):
            raise TypeError(f"a factor is {p.dtype} on {p.device} over {p.n_total} rows but r "
                            f"is {rp.dtype} on {rp.device} over {pre.n_total}")
    tensors = list(vectors) + [p.diags_p for p in factors if not isinstance(p, ScalarFactor)]
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
    rows, ``"ring"`` at the plan of :func:`_ring_plan`, ``"per-sweep"``, or
    ``"scalar"`` for an SGS of a constant-coefficient stencil), whatever
    the rule would pick, counted like the wrappers: the card tests hold
    every variant to the plain version with it."""
    from . import _build

    sgs = hasattr(pre, "diag_p")
    _check(pre, (pre.inv_diag_p, pre.diag_p) if sgs else (pre.inv_diag_l_p, pre.inv_diag_u_p),
           rp)
    if rp.device.type != "cuda":
        raise ValueError("_apply_variant launches a kernel: rp must be a CUDA tensor")
    if variant == "scalar":
        return _launch_scalar(pre, rp)
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
    variant_launches[kind] += 1
    return out


def _scalar_args(p) -> tuple:
    """(offsets, faces, values addresses, count) of a scalar strict part,
    or empty ones."""
    if p is None:
        empty = _offsets_array(()).ctypes.data
        return empty, empty, empty, 0
    return (*(a.ctypes.data for a in p.c_args), len(p.offsets))


def _launch_scalar(psgs, rp: torch.Tensor) -> torch.Tensor:
    """K4's scalar variant (csrc/trisweep.cu ``smm_sgs_apply_scalar_*``)."""
    from . import _build

    if not _is_scalar(psgs):
        raise ValueError("the scalar variant takes an SGS of a constant-coefficient stencil")
    lib = _build.library()
    fn = lib.smm_sgs_apply_scalar_f64 if rp.dtype == torch.float64 else lib.smm_sgs_apply_scalar_f32
    grid = psgs.p_lower or psgs.p_upper
    w0, w1, out = torch.empty_like(rp), torch.empty_like(rp), torch.empty_like(rp)
    with torch.cuda.device(rp.device):
        code = fn(rp.data_ptr(), w0.data_ptr(), w1.data_ptr(), out.data_ptr(), int(psgs.sweeps),
                  psgs.n_total, psgs.lead, psgs.shape[0], *_scalar_args(psgs.p_lower),
                  *_scalar_args(psgs.p_upper), *grid.const_diag, grid.nx, grid.ny, grid.row0,
                  grid.n_global, torch.cuda.current_stream().cuda_stream)
    _build.check(code, "sgs_apply (the scalar variant)")
    launches["sgs_apply"] += 1
    variant_launches["scalar"] += 1
    return out


def sgs_apply_fused(psgs, rp: torch.Tensor) -> torch.Tensor:
    """K4: z = M^{-1} r for a PaddedSGS, r and z in the padded layout; guard
    rows of z are exactly 0."""
    _check(psgs, (psgs.inv_diag_p, psgs.diag_p), rp)
    if rp.device.type == "cpu":
        return sgs_apply_plain(psgs, rp)
    from . import _build

    kind, tile = _rule_of(psgs, _num_sms(rp.device.index), rp.element_size())
    if kind == "scalar":
        return _launch_scalar(psgs, rp)
    lib = _build.library()
    fn = lib.smm_sgs_apply_f32 if rp.dtype == torch.float32 else lib.smm_sgs_apply_f64
    return _launch("sgs_apply", fn, psgs, rp, psgs.inv_diag_p, psgs.diag_p, kind, tile)


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
