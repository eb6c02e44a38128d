"""ctypes binding of the host runtime's IC(0) and ILU(0) factorizations.

Port of ``sparse_matrix_math_tpu/native/__init__.py:34-131, 193-246``.  The
C++ source is this package's ``csrc/smm_native.cpp``, a verbatim copy of the
JAX package's ``native/smm_native.cpp`` (the CPU tests hold its factors and
W-SELL planes to the JAX package's).  It is compiled at first use with the
JAX package's flags (``g++ -O3 -march=native -std=c++17 -shared -fPIC``,
plus ``-fopenmp`` when that compiles) into this package's ``build/``
directory under a name that hashes the source and the flags.  Bound:
``smm_ic0_factorize`` and ``smm_ilu0_factorize`` (native/__init__.py:193-246)
and the W-SELL layout routines ``smm_wsell_plan``, ``smm_wsell_emit`` and
``smm_wsell_color`` (native/__init__.py:175-185, 288-311, 462-523).

Like the JAX binding, a missing compiler or a failed build leaves the
library unavailable: each call then returns None, and its caller falls back
to Python (precond/_factorize.py, formats/wsell.py).
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
           "wsell_emit", "wsell_color", "SOURCE"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "smm_native.cpp"
_BUILD_DIR = _PKG / "build"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
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
