"""Build and load the port's CUDA kernels.

The sources in :data:`SOURCES` are compiled with ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds.  The library lands in the package's
``build/`` directory under a name that hashes every source and the flags,
so an edited source is rebuilt and a stale library is never loaded.  The
build runs at first use, from the sources in the checkout alone; a failed
build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "check", "SOURCES"]

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG / "csrc" / name for name in
                ("dia_spmv.cu", "trisweep.cu", "sell_spmv.cu",
                 "dia_spmv_df.cu", "stream_gather.cu"))
_BUILD_DIR = _PKG / "build"
_COMPILE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_APPLY = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _LL, _LL, _LL, _LL, _P]
_SIGNATURES = {
    # diags, xp, y, offsets, ndiags, n_total, lead, n_rows, stream
    "smm_dia_spmv_padded_f32": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    "smm_dia_spmv_padded_f64": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    "smm_dia_spmv_padded_bf16_f32": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    "smm_dia_spmv_padded_f16_f32": [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    # diags, x, y, offsets, ndiags, n_rows, n_cols, stream
    "smm_dia_spmv_f32": [_P, _P, _P, _P, _I, _LL, _LL, _P],
    "smm_dia_spmv_f64": [_P, _P, _P, _P, _I, _LL, _LL, _P],
    # r, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1, out,
    # sweeps, n_total, lead, n_rows, tile, stream
    "smm_sgs_apply_f32": _APPLY,
    "smm_sgs_apply_f64": _APPLY,
    # r, invd_l, invd_u, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1,
    # out, sweeps, n_total, lead, n_rows, tile, stream
    "smm_tri_pair_apply_f32": _APPLY,
    "smm_tri_pair_apply_f64": _APPLY,
    # vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, k, stream
    "smm_sell_spmm_f32": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
    "smm_sell_spmm_f64": [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _P],
    # diags_hi, diags_lo, xh, xl, yh, yl, offsets, ndiags, n_total, lead,
    # n_rows, stream
    "smm_dia_spmv_padded_df": [_P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL, _P],
    # vals, meta, base, table, out, n_vregs, table_len, sw_bits, stream
    "smm_stream_gather_f32": [_P, _P, _P, _P, _P, _LL, _LL, _I, _P],
    "smm_stream_gather_f64": [_P, _P, _P, _P, _P, _LL, _LL, _I, _P],
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


def _run_all(commands) -> None:
    """Start every command at once, wait for all, raise on the first failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in commands]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n" + "\n".join(failed))


def _build(out: Path) -> None:
    nvcc = _nvcc()
    work = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / f"{src.stem}.o" for src in SOURCES]
        _run_all([[nvcc, *_COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(SOURCES, objs)])
        lib = work / out.name
        _run_all([[nvcc, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, out)  # atomic: a concurrent build never loads a partial file
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per version of the sources) and load the kernel library."""
    digest = hashlib.sha256(" ".join(_COMPILE_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _BUILD_DIR / f"libsmm_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _build(out)
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
