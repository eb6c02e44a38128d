"""Build and load the port's CUDA kernels.

``csrc/dia_spmv.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  The library lands in the package's
``build/`` directory under a name that hashes the source and the flags, so
an edited source is rebuilt and a stale library is never loaded.  The build
runs at first use, from the sources in the checkout alone; a failed build
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "check", "SOURCE"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dia_spmv.cu"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    # diags, xp, y, offsets, ndiags, n_total, lead, n_rows, stream
    "smm_dia_spmv_padded_f32": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    "smm_dia_spmv_padded_f64": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    # diags, x, y, offsets, ndiags, n_rows, n_cols, stream
    "smm_dia_spmv_f32": [_P, _P, _P, _P, _I, _LL, _LL, _P],
    "smm_dia_spmv_f64": [_P, _P, _P, _P, _I, _LL, _LL, _P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels cannot be built"
        )
    return found


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / f"libsmm_dia_spmv_{tag}.so"
    if not out.exists():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.smm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.smm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if code != 0:
        msg = library().smm_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
