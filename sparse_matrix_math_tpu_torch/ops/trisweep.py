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

On the card an apply takes one of two variants, by the rule of
:func:`window_tile`: the halo-window kernels (one launch per direction,
each CTA walking its tile's one-sided window in chunks of :data:`CHUNK`
rows with the levels' rings in shared memory), or, where the rings do not
fit or the halo reaches two tiles, the large-reach variant (one launch per
step, ``2 * sweeps`` per apply).  :func:`sgs_apply_windowed_plain` and
:func:`tri_pair_apply_windowed_plain` replay the window kernels'
decomposition (tiles, chunks, cones and rings, with the kernels' index
math) in PyTorch; the tests and ``chip_smoke.py`` hold them against the
plain versions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dia_spmv import _DTYPES, _MAX_DIAGS, dia_spmv_padded_plain

__all__ = [
    "sgs_apply_fused", "tri_pair_apply_fused", "sgs_apply_plain", "tri_pair_apply_plain",
    "launches", "reset_launch_counts",
]

# csrc/trisweep.cu's window kernels: rows per chunk, chunks of operands in
# flight, and the dynamic shared memory of a CTA (the 227 KB one block may
# use, less the kernel's static copy of the 64 offsets)
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
    """The rule that picks an apply's variant on the card: the tile (rows
    per CTA) of the window kernels, or 0 for the large-reach variant.

    The tile is the layout's chunks split evenly over ``num_sms`` CTAs, one
    per SM.  The window kernels run when, in both directions, the rings of
    ``levels - 1`` levels of ``ring_rows(reach)`` and the operand staging
    fit the block's shared memory, and the halo ``(levels - 1) * reach`` is
    shorter than ``_HALO_TILES`` tiles (every CTA sweeps its halo again, so
    a long halo costs more than the launches it saves).  ``levels`` is
    ``sweeps``, or 1 for an empty strict part; ``reach`` is the direction's
    largest ``|offset|``."""
    return _tile_rule(_offsets(pre.p_lower), _offsets(pre.p_upper), pre.n_total,
                      int(pre.sweeps), hasattr(pre, "diag_p"), num_sms, itemsize)


@functools.lru_cache(maxsize=256)
def _tile_rule(lower: tuple, upper: tuple, n_total: int, sweeps: int, sgs: bool,
               num_sms: int, itemsize: int) -> int:
    """:func:`window_tile` on plain values, worked out once per layout."""
    tile = -(-n_total // (CHUNK * num_sms)) * CHUNK
    for offsets, fixed, sign in ((lower, 2, -1), (upper, 3 if sgs else 2, 1)):
        if any(o * sign <= 0 for o in offsets):
            return 0
        halo = (_levels(offsets, sweeps) - 1) * _reach(offsets)
        if (_window_smem(offsets, sweeps, fixed, itemsize) > _SMEM_BYTES
                or halo >= _HALO_TILES * tile):
            return 0
    return int(tile)


@functools.cache
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def variant(pre, device) -> str:
    """``"window"`` or ``"per-sweep"``: the variant an apply of ``pre`` takes
    on the CUDA ``device`` (the rule of :func:`window_tile`)."""
    device = torch.device(device)
    itemsize = torch.empty((), dtype=pre.dtype).element_size()
    return "window" if window_tile(pre, _num_sms(device.index or 0), itemsize) else "per-sweep"


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


def _launch(name: str, fn, pre, rp: torch.Tensor, first, second) -> torch.Tensor:
    from . import _build

    ld, l_offs, nd_l = _factor_args(pre.p_lower)
    ud, u_offs, nd_u = _factor_args(pre.p_upper)
    tile = window_tile(pre, _num_sms(rp.device.index), rp.element_size())
    if tile and rp.data_ptr() % 16:
        rp = rp.clone()  # the window kernels copy 16-byte runs of every vector
    # the window kernels need one scratch vector, the large-reach variant two
    w0, out = torch.empty_like(rp), torch.empty_like(rp)
    w1 = torch.empty_like(rp) if tile == 0 else None
    with torch.cuda.device(rp.device):
        code = fn(rp.data_ptr(), first.data_ptr(), second.data_ptr(), ld, l_offs, nd_l, ud,
                  u_offs, nd_u, w0.data_ptr(),
                  None if w1 is None else w1.data_ptr(), out.data_ptr(), int(pre.sweeps),
                  pre.n_total, pre.lead, pre.shape[0], tile,
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
    return _launch("sgs_apply", fn, psgs, rp, psgs.inv_diag_p, psgs.diag_p)


def tri_pair_apply_fused(pair, rp: torch.Tensor) -> torch.Tensor:
    """K5: z = (L U)^{-1} r for a PaddedTriPair, r and z in the padded
    layout; guard rows of z are exactly 0."""
    _check(pair, (pair.inv_diag_l_p, pair.inv_diag_u_p), rp)
    if rp.device.type == "cpu":
        return tri_pair_apply_plain(pair, rp)
    from . import _build

    lib = _build.library()
    fn = lib.smm_tri_pair_apply_f32 if rp.dtype == torch.float32 else lib.smm_tri_pair_apply_f64
    return _launch("tri_pair_apply", fn, pair, rp, pair.inv_diag_l_p, pair.inv_diag_u_p)
