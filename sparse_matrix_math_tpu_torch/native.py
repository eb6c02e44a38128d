"""ctypes binding of the host runtime's IC(0) and ILU(0) factorizations.

Port of ``sparse_matrix_math_tpu/native/__init__.py:34-131, 193-246``.  The
C++ source is the JAX package's ``native/smm_native.cpp``, reached by its
path in the checkout: it is neither copied nor imported through the JAX
package (whose import pulls in jax).  It is compiled at first use with the
JAX package's flags (``g++ -O3 -march=native -std=c++17 -shared -fPIC``,
plus ``-fopenmp`` when that compiles) into this package's ``build/``
directory under a name that hashes the source and the flags.  Only
``smm_ic0_factorize`` and ``smm_ilu0_factorize`` are bound.

Like the JAX binding, a missing compiler or a failed build leaves the
library unavailable, and the factorizations fall back to their Python
loops (precond/_factorize.py).
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

__all__ = ["available", "library", "ic0_factorize", "ilu0_factorize", "SOURCE"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG.parent / "sparse_matrix_math_tpu" / "native" / "smm_native.cpp"
_BUILD_DIR = _PKG / "build"
_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
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
