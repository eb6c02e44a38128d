"""ctypes binding of the host runtime: the IC(0) and ILU(0) factorizations
and the W-SELL and R-SELL layout routines.

Port of ``sparse_matrix_math_tpu/native/__init__.py:34-131, 150-246, 288-523``.  The
C++ source is this package's ``csrc/smm_native.cpp``, a verbatim copy of the
JAX package's ``native/smm_native.cpp`` (the CPU tests hold its factors and
W-SELL planes to the JAX package's).  It is compiled at first use with the
JAX package's flags (``g++ -O3 -march=native -std=c++17 -shared -fPIC``,
plus ``-fopenmp`` when that compiles) into this package's ``build/``
directory under a name that hashes the source and the flags.  Bound:
``smm_ic0_factorize`` and ``smm_ilu0_factorize`` (native/__init__.py:193-246)
the W-SELL layout routines ``smm_wsell_plan``, ``smm_wsell_emit`` and
``smm_wsell_color`` (native/__init__.py:175-185, 288-311, 462-523), and the
R-SELL routed-chain routines ``smm_stream_pack_cf``, ``smm_sort_perm``,
``smm_stream_group``, ``smm_stream_emit`` and ``smm_stream_level``
(native/__init__.py:150-174, 312-460).

Like the JAX binding, a missing compiler or a failed build leaves the
library unavailable: each call then returns None, and its caller falls back
to Python (precond/_factorize.py, formats/wsell.py, formats/rsell.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "library", "ic0_factorize", "ilu0_factorize", "wsell_plan",
           "wsell_emit", "wsell_color", "stream_pack_cf", "sort_perm", "stream_group",
           "stream_emit", "stream_level", "SOURCE"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "smm_native.cpp"
_BUILD_DIR = _PKG / "build"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _compile(out: Path) -> bool:
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    base = ["g++", *_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        for cmd in (base + ["-fopenmp"], base):  # OpenMP first, as the JAX build
            if subprocess.run(cmd, capture_output=True, timeout=300).returncode == 0:
                os.replace(tmp, out)
                return True
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        tmp.unlink(missing_ok=True)
    return False


@functools.cache
def library() -> Optional[ctypes.CDLL]:
    """Build (once per source version) and load the library; None when it
    cannot be built or loaded."""
    if not SOURCE.exists():
        return None
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = _BUILD_DIR / f"libsmm_native_{tag}.so"
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError:
        return None
    if not out.exists() and not _compile(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError:
        return None
    lib.smm_ic0_factorize.restype = ctypes.c_int
    lib.smm_ic0_factorize.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _f64p, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.smm_ilu0_factorize.restype = ctypes.c_int
    lib.smm_ilu0_factorize.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _f64p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.smm_wsell_color.restype = ctypes.c_int64
    lib.smm_wsell_color.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p, _i64p, _i64p, _i32p,
    ]
    lib.smm_wsell_plan.restype = ctypes.c_int64
    lib.smm_wsell_plan.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, _i64p, _i64p, _i32p, _i64p, _i64p, _i64p,
    ]
    lib.smm_wsell_emit.restype = ctypes.c_int
    lib.smm_wsell_emit.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        _i64p, _i64p, ctypes.c_void_p, _i64p, _i32p, _i64p, _i32p,
        ctypes.c_void_p, _i32p,
    ]
    c64 = ctypes.c_int64
    lib.smm_stream_pack_cf.restype = c64
    lib.smm_stream_pack_cf.argtypes = [c64, c64, c64, _i64p, _i64p, _i64p, _i64p, _i32p,
                                       _i32p, _i64p]
    lib.smm_sort_perm.restype = None
    lib.smm_sort_perm.argtypes = [c64, _u64p, ctypes.c_int, _i64p]
    lib.smm_stream_group.restype = c64
    lib.smm_stream_group.argtypes = [c64, c64] + [_i64p] * 6
    lib.smm_stream_emit.restype = None
    lib.smm_stream_emit.argtypes = [c64, c64, ctypes.c_int, _i64p, _i64p, _i32p, _i32p,
                                    _i64p, _i64p, ctypes.c_void_p, _i32p, _i64p]
    lib.smm_stream_level.restype = c64
    lib.smm_stream_level.argtypes = [c64] * 8 + [_i64p] * 10
    return lib


def available() -> bool:
    """Whether the native library compiled and loaded."""
    return library() is not None


def ic0_factorize(l_indptr, l_indices, a_lower) -> Optional[np.ndarray]:
    """L values of IC(0) on the given lower pattern (ascending columns, the
    diagonal last in each row), or None when the library is unavailable.
    Raises ValueError on a non-positive pivot."""
    lib = library()
    if lib is None:
        return None
    n = l_indptr.shape[0] - 1
    l_values = np.zeros(a_lower.shape[0], dtype=np.float64)
    err = ctypes.c_int64(-1)
    rc = lib.smm_ic0_factorize(
        n,
        np.ascontiguousarray(l_indptr, np.int64),
        np.ascontiguousarray(l_indices, np.int64),
        np.ascontiguousarray(a_lower, np.float64),
        l_values,
        ctypes.byref(err),
    )
    if rc == 2:
        raise ValueError(f"non-positive pivot at row {err.value}; matrix is not SPD")
    if rc != 0:
        raise RuntimeError(f"smm_ic0_factorize returned {rc}")
    return l_values


def ilu0_factorize(indptr, indices, diag_pos, data, pivot_tol: float = 0.0
                   ) -> Optional[np.ndarray]:
    """ILU(0) factor values on A's pattern, or None when the library is
    unavailable.  Raises ValueError on a pivot with ``|pivot| <= pivot_tol``."""
    lib = library()
    if lib is None:
        return None
    n = indptr.shape[0] - 1
    factor = np.array(data, dtype=np.float64, copy=True)
    err = ctypes.c_int64(-1)
    rc = lib.smm_ilu0_factorize(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int64),
        np.ascontiguousarray(diag_pos, np.int64),
        factor,
        float(pivot_tol),
        ctypes.byref(err),
    )
    if rc == 3:
        raise ValueError(f"zero pivot at row {err.value} during ILU(0)")
    if rc != 0:
        raise RuntimeError(f"smm_ilu0_factorize returned {rc}")
    return factor


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def wsell_color(job, t, lane, lsrc, sw, n_jobs: int) -> Optional[np.ndarray]:
    """First-fit W-SELL slot-row colouring: an int32 slot row per nnz
    meeting the layout's constraints (formats/wsell.py), or None when the
    library is unavailable or refuses the input."""
    lib = library()
    if lib is None:
        return None
    row = np.empty(job.shape[0], np.int32)
    rc = lib.smm_wsell_color(job.shape[0], int(n_jobs), _i64(job), _i64(t), _i64(lane),
                             _i64(lsrc), _i64(sw), row)
    return None if rc < 0 else row


def wsell_plan(r, c, n_rows: int, x_rows: int, window_f: int):
    """The fused W-SELL layout plan: per nnz (job, int32 slot row), per job
    (8·K rows, window base, slab); None when the library is unavailable or
    the job key span is too large for its dense map."""
    lib = library()
    if lib is None:
        return None
    n = r.shape[0]
    job = np.empty(n, np.int64)
    row = np.empty(n, np.int32)
    job_rows, job_base, job_slab = (np.empty(n, np.int64) for _ in range(3))
    n_jobs = lib.smm_wsell_plan(n, int(n_rows), int(x_rows), int(window_f), _i64(r), _i64(c),
                                job, row, job_rows, job_base, job_slab)
    if n_jobs < 0:
        return None
    k = int(n_jobs)
    return job, row, job_rows[:k], job_base[:k], job_slab[:k]


def wsell_emit(lsrc_shift: int, wrows: int, r, c, v: np.ndarray, job, row,
               vreg_start_of_job, base_vreg, vals_plane: np.ndarray,
               meta_plane: np.ndarray) -> Optional[bool]:
    """Scatter the W-SELL vals and meta planes in place.  True on success;
    None when the library is unavailable or the value type is neither
    float32 nor float64.  Raises AssertionError when a window sublane falls
    outside ``[0, wrows)``."""
    lib = library()
    if lib is None or v.dtype != vals_plane.dtype or v.dtype not in (np.float32, np.float64):
        return None
    assert vals_plane.flags["C_CONTIGUOUS"] and meta_plane.flags["C_CONTIGUOUS"]
    rc = lib.smm_wsell_emit(
        r.shape[0], int(lsrc_shift), int(wrows), int(v.dtype == np.float64), _i64(r), _i64(c),
        np.ascontiguousarray(v).ctypes.data_as(ctypes.c_void_p), _i64(job),
        np.ascontiguousarray(row, np.int32), _i64(vreg_start_of_job),
        np.ascontiguousarray(base_vreg, np.int32),
        vals_plane.ctypes.data_as(ctypes.c_void_p), meta_plane,
    )
    if rc != 0:
        raise AssertionError(f"window base math violated sw in [0, {wrows})")
    return True


def stream_pack_cf(group, sigma, lam, nd, wrows: int):
    """The closed-form R-SELL stream-pass packing, the native twin of
    ``formats/rsell.py:_pack_pass``: (int32 row in group, int32 out lane,
    rows per group), or None when the library is unavailable or refuses the
    input.  Raises ValueError when a flood of duplicate sources does not
    pack, as the NumPy packer does."""
    lib = library()
    if lib is None:
        return None
    n = group.shape[0]
    n_groups = int(group[-1]) + 1 if n else 0
    row = np.empty(n, np.int32)
    lane = np.empty(n, np.int32)
    group_rows = np.empty(max(n_groups, 1), np.int64)
    rc = lib.smm_stream_pack_cf(n, n_groups, int(wrows), _i64(group), _i64(sigma), _i64(lam),
                                _i64(nd), row, lane, group_rows)
    if rc == -2:
        raise ValueError("R-SELL packer did not converge (duplicate flood)")
    if rc < 0:
        return None
    return row, lane, group_rows[:n_groups]


def sort_perm(key: np.ndarray) -> Optional[np.ndarray]:
    """The stable radix-sort permutation of non-negative int64 (or uint64)
    keys, equal to ``np.argsort(key, kind="stable")``; None when the library
    is unavailable or the keys are of another type or negative."""
    lib = library()
    if lib is None:
        return None
    key = np.ascontiguousarray(key)
    if key.dtype == np.int64:
        if key.size and int(key.min()) < 0:
            return None
        key = key.view(np.uint64)
    elif key.dtype != np.uint64:
        return None
    bits = int(key.max(initial=0)).bit_length() if key.size else 1
    perm = np.empty(key.shape[0], np.int64)
    lib.smm_sort_perm(key.shape[0], key, max(bits, 1), perm)
    return perm


def stream_group(wrows: int, bucket, pos):
    """One stream level's grouping, for inputs sorted by (bucket, pos):
    per element (group, window sublane sigma, source lane lam), and per group
    its window stack; None when the library is unavailable."""
    lib = library()
    if lib is None:
        return None
    n = bucket.shape[0]
    group, sigma, lam, group_stack = (np.empty(n, np.int64) for _ in range(4))
    n_groups = lib.smm_stream_group(n, int(wrows), _i64(bucket), _i64(pos), group, sigma, lam,
                                    group_stack)
    return group, sigma, lam, group_stack[:n_groups]


def stream_emit(sw_bits: int, group, row_off, row_in_group, out_lane, lam, sigma,
                vals_plane: np.ndarray, meta_plane: np.ndarray) -> Optional[np.ndarray]:
    """Scatter one stream level's zeroed vals (float32 or float64) and meta
    (int32) planes in place and return each element's new position; None when
    the library is unavailable or the value type is another."""
    lib = library()
    if lib is None or vals_plane.dtype not in (np.float32, np.float64):
        return None
    assert vals_plane.flags["C_CONTIGUOUS"] and meta_plane.flags["C_CONTIGUOUS"]
    out_pos = np.empty(group.shape[0], np.int64)
    lib.smm_stream_emit(
        group.shape[0], int(sw_bits), int(vals_plane.dtype == np.float64), _i64(group),
        _i64(row_off), np.ascontiguousarray(row_in_group, np.int32),
        np.ascontiguousarray(out_lane, np.int32), _i64(lam), _i64(sigma),
        vals_plane.ctypes.data_as(ctypes.c_void_p), meta_plane, out_pos,
    )
    return out_pos


def stream_level(wrows: int, d: int, wt: int, d_next: int, wt_next: int, pos_bits: int,
                 key_bits: int, prefix: np.ndarray, pos: np.ndarray, order: np.ndarray,
                 leaf: np.ndarray, slab_in_leaf: np.ndarray):
    """The fused routed-chain level: ``prefix <- prefix * d + (leaf // wt) % d``,
    a stable sort of all five carried arrays IN PLACE by (prefix, pos), then
    the next-level digit and the grouping of the sorted order.  Returns
    (nd, group, sigma, lam, group_stack), or None when the library is
    unavailable, refuses, or an array is not contiguous int64."""
    lib = library()
    if lib is None:
        return None
    carried = (prefix, pos, order, leaf, slab_in_leaf)
    if any(a.dtype != np.int64 or not a.flags["C_CONTIGUOUS"] for a in carried):
        return None
    n = prefix.shape[0]
    nd, group, sigma, lam, group_stack = (np.empty(n, np.int64) for _ in range(5))
    n_groups = lib.smm_stream_level(n, int(wrows), int(d), int(wt), int(d_next), int(wt_next),
                                    int(pos_bits), int(key_bits), *carried, nd, group, sigma,
                                    lam, group_stack)
    if n_groups < 0:
        return None
    return nd, group, sigma, lam, group_stack[:n_groups]
