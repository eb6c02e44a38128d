#!/usr/bin/env python3
"""A/B an L2 persisting window over x for the folded routed product on one CUDA card.

    python3 tools/routed_l2_ab.py [n] [rounds]

On ``uniform_random_csr(n, per_row=5)`` (default 2,000,000, the JAX bench's
zero-locality system) in float32 and float64, the routed product is one
launch of ``csrc/sell_spmv.cu`` over the chain folded into its final layout
(``RoutedMatrix.sell``): it streams the layout's values and column words
once and gathers x, 8 MB (16 MB in float64), at random through the 50 MB
L2.  The B side sets an access policy window over x on the stream
(``cudaStreamSetAttribute``, ``cudaAccessPropertyPersisting`` at hit ratio
1.0, the device's persisting L2 limit raised to the window) so that the
streamed layout cannot evict x; the A side has no window.  Each side's time
per product from CUDA events over 20 launches (median of 11) through the
wrapper, in turns A, B, B, A per round; every B product is held bit for bit
to an A product.  The window is cleared and the persisting lines reset after
each B reading.

Prints the card's name and power limit, and one JSON line last.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_ACCESS_POLICY_WINDOW = 1      # cudaLaunchAttributeAccessPolicyWindow (= cudaStreamAttr...)
_PERSISTING, _STREAMING = 2, 1  # cudaAccessProperty
_LIMIT_PERSISTING_L2 = 0x06     # cudaLimitPersistingL2CacheSize
_ATTR_MAX_PERSISTING_L2 = 108   # cudaDevAttrMaxPersistingL2CacheSize
_ATTR_MAX_WINDOW = 109          # cudaDevAttrMaxAccessPolicyWindowSize


class _Window(ctypes.Structure):
    _fields_ = [("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t),
                ("hitRatio", ctypes.c_float), ("hitProp", ctypes.c_int),
                ("missProp", ctypes.c_int)]


class _Value(ctypes.Union):
    _fields_ = [("pad", ctypes.c_char * 64), ("window", _Window)]


def cudart():
    """The CUDA runtime this process's torch loaded."""
    with open("/proc/self/maps") as maps:
        paths = {line.split()[-1] for line in maps if "libcudart" in line}
    if not paths:  # a torch linked to the runtime statically: the toolkit's
        paths = {"/usr/local/cuda/lib64/libcudart.so"}
    return ctypes.CDLL(sorted(paths)[0])


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def set_window(rt, stream: int, x, on: bool) -> None:
    value = _Value()
    if on:
        value.window = _Window(x.data_ptr(), x.numel() * x.element_size(), 1.0, _PERSISTING,
                               _STREAMING)
    check(rt.cudaStreamSetAttribute(ctypes.c_void_p(stream), _ACCESS_POLICY_WINDOW,
                                    ctypes.byref(value)), "cudaStreamSetAttribute")
    if not on:
        check(rt.cudaCtxResetPersistingL2Cache(), "cudaCtxResetPersistingL2Cache")


def main() -> int:
    import torch

    import chip_smoke as C
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    if not torch.cuda.is_available():
        print("routed_l2_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(smi)
    _build.library()
    dev = torch.device("cuda", 0)
    rt = cudart()
    limit, window_max = ctypes.c_int(), ctypes.c_int()
    check(rt.cudaDeviceGetAttribute(ctypes.byref(limit), _ATTR_MAX_PERSISTING_L2, 0), "attr")
    check(rt.cudaDeviceGetAttribute(ctypes.byref(window_max), _ATTR_MAX_WINDOW, 0), "attr")
    out = {"card": smi, "n": n, "max_persisting_l2_bytes": limit.value,
           "max_window_bytes": window_max.value}
    print(f"max persisting L2 {limit.value} B, max window {window_max.value} B")
    stream = torch.cuda.current_stream().cuda_stream
    for dt in (torch.float32, torch.float64):
        name = str(dt)[6:]
        ra = smm.routed_from_csr(smm.uniform_random_csr(n, per_row=5, dtype=dt, device=dev),
                                 max_slot_ratio=16.0)
        x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(3), device=dev,
                        dtype=torch.float64).to(dt)
        nbytes = x.numel() * x.element_size()
        check(rt.cudaDeviceSetLimit(_LIMIT_PERSISTING_L2, ctypes.c_size_t(
            min(nbytes, limit.value))), "cudaDeviceSetLimit")
        ref = W.routed_spmv(ra, x)
        readings = {"A": [], "B": []}
        for _ in range(rounds):
            for side in "ABBA":
                set_window(rt, stream, x, side == "B")
                y = W.routed_spmv(ra, x)
                readings[side].append(C.median_ms(lambda: W.routed_spmv(ra, x)))
                torch.cuda.synchronize()
                set_window(rt, stream, x, False)
                if not C.bits_equal(torch, y, ref):
                    raise RuntimeError(f"{name}: the product under side {side} differs in bits")
        bound = C.bound_ms(C.sell_bytes(ra.sell, x.element_size()))
        out[name] = {"no_window_ms": readings["A"], "window_ms": readings["B"],
                     "bound_ms": bound, "x_bytes": nbytes}
        print(f"{name}: no window {readings['A']} ms, persisting window over x "
              f"{readings['B']} ms (bound {bound:.4f} ms, x {nbytes} B)")
        del ra, x, ref, y
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
