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
"""

from __future__ import annotations

import numpy as np
import torch

from .dia_spmv import _DTYPES, _MAX_DIAGS, dia_spmv_padded_plain

__all__ = [
    "sgs_apply_fused", "tri_pair_apply_fused", "sgs_apply_plain", "tri_pair_apply_plain",
    "launches", "reset_launch_counts",
]

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


def _factor_args(p):
    """(diagonals pointer, offsets array, count) of a strict factor, or
    null/empty for an empty one; the offsets array must outlive the call."""
    if p is None:
        return None, np.zeros(1, dtype=np.int32), 0
    return p.diags_p.data_ptr(), np.asarray(p.offsets, dtype=np.int32), len(p.offsets)


def _launch(name: str, fn, pre, rp: torch.Tensor, first, second) -> torch.Tensor:
    from . import _build

    ld, l_offs, nd_l = _factor_args(pre.p_lower)
    ud, u_offs, nd_u = _factor_args(pre.p_upper)
    w0, w1, out = (torch.empty_like(rp) for _ in range(3))
    with torch.cuda.device(rp.device):
        code = fn(rp.data_ptr(), first.data_ptr(), second.data_ptr(), ld, l_offs.ctypes.data,
                  nd_l, ud, u_offs.ctypes.data, nd_u, w0.data_ptr(), w1.data_ptr(),
                  out.data_ptr(), int(pre.sweeps), pre.n_total, pre.lead, pre.shape[0],
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
