#!/usr/bin/env python3
"""Compare the one-column code (K = 1: K6, K7) of two versions of
``sparse_matrix_math_tpu_torch/csrc/sell_spmv.cu`` on one CUDA card: the
machine code the compiler makes of it, and its time.

    python3 tools/sell_k1_ab.py OTHER.cu [m] [rounds]

OTHER.cu is another version of the file, for example an earlier commit's,
unpacked with ``git archive`` into a git-ignored directory.  Both are built
side by side with nvcc and the port's flags (``ops/_build.py``) into the
git-ignored ``sparse_matrix_math_tpu_torch/build/k1ab/``; then

* ptxas's registers and spill stores of each one-column kernel, float32 and
  float64;
* ``cuobjdump -sass`` of both libraries: each one-column kernel's
  instruction encodings and its instructions (branch labels renamed alike),
  identical between the two or the number of lines that differ, with the
  first few, and whether they are the same once register numbers and
  ``.reuse`` hints are taken out (the same instructions in the same order,
  registers allocated differently);
* both timed on the same inputs, each result held bit for bit to the
  other's, in the order other, this, this, other in each of ``rounds``
  rounds (3 by default; ``chip_smoke.median_ms``, CUDA events): the W-SELL
  layout of ``laplace_3d_jittered(m, symmetric=True, shift=0.25)`` in
  float32 and float64, and the strict L of its IC(0) factor
  (``method="jacobi", sweeps=4``) in float32; m = 113 by default, phase W's
  system; then the checkout's wrapper ``wsell_spmv`` on the same inputs, as
  ``chip_smoke.py`` times it, and the host's microseconds per call of the
  wrapper and of the bare C entry.

The entries of OTHER.cu may be ``smm_sell_spmv_*`` (one column) or
``smm_sell_spmm_*`` (k columns; called with k = 1).  Prints the card's name
and power limit and, last, one JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import difflib
import json
import os
import re
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from ab_build import build  # noqa: E402
from chip_smoke import median_ms  # noqa: E402

_SRC = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "csrc", "sell_spmv.cu")
_OUT = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "build", "k1ab")
# sell_kernel<T> (one template argument) or sell_kernel<T, 1>, T float or double
_K1 = re.compile(r"sell_kernelI([fd])(?:Li(\d+)E)?EEv")


def one_column(name: str):
    """``"float32"``/``"float64"`` for a one-column kernel's mangled name, else None."""
    m = _K1.search(name)
    if m is None or (m.group(2) not in (None, "1")):
        return None
    return "float32" if m.group(1) == "f" else "float64"


def sass(lib: str) -> dict:
    """Per one-column kernel of ``lib``: its instruction encodings and its
    instructions with branch labels renamed in order of appearance."""
    from sparse_matrix_math_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        dtype = one_column(chunk.split("\n", 1)[0])
        if dtype is None:
            continue
        words = re.findall(r"/\* (0x[0-9a-f]{16}) \*/", chunk)
        labels = {}

        def rename(m):
            return labels.setdefault(m.group(0), f".L{len(labels)}")

        instrs = [re.sub(r"\.L_x_\d+", rename, m.strip())
                  for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", chunk)]
        out[dtype] = {"encodings": words, "instructions": instrs}
    return out


def changed(a: list, b: list) -> list:
    """The lines a line diff of ``a`` and ``b`` removes or adds."""
    return [d for d in difflib.unified_diff(a, b, lineterm="", n=0)
            if d[:1] in "+-" and d[:3] not in ("+++", "---")]


def without_registers(instrs: list) -> list:
    """The instructions with register numbers and ``.reuse`` hints taken out."""
    return [re.sub(r"\b(U?[RP])\d+\b", r"\1", i.replace(".reuse", "")) for i in instrs]


def entry(dll, dtype_name: str):
    """The one-column call of a library: (vals, cols, chunk_ptr, row_of, x,
    y, n_slabs, n_rows, stream) -> CUDA error code."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    suffix = "f32" if dtype_name == "float32" else "f64"
    try:
        fn = getattr(dll, f"smm_sell_spmm_{suffix}")
    except AttributeError:
        fn = getattr(dll, f"smm_sell_spmv_{suffix}")
        fn.argtypes = [P, P, P, P, P, P, I, LL, P]
        fn.restype = I
        return fn
    fn.argtypes = [P, P, P, P, P, P, I, LL, I, P]
    fn.restype = I
    return lambda *a: fn(*a[:8], 1, a[8])


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 113
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    built = build({"other": other, "this": _SRC}, _OUT, "libsell")
    for b in built.values():  # the one-column kernels, by dtype
        b["ptxas"] = {one_column(name): {k: info[k] for k in ("registers", "spill_store_bytes")}
                      for name, info in b["ptxas"].items() if one_column(name)}
    result = {"card": smi, "other": other, "ptxas": {k: v["ptxas"] for k, v in built.items()},
              "sass": {}, "times": {}}
    code = {k: sass(v["lib"]) for k, v in built.items()}
    for dtype in ("float32", "float64"):
        a, b = code["other"].get(dtype), code["this"].get(dtype)
        if a is None or b is None:
            missing = "other" if a is None else "this"
            raise RuntimeError(f"no one-column {dtype} kernel in {missing}")
        same_enc = a["encodings"] == b["encodings"]
        diff = changed(a["instructions"], b["instructions"])
        ops_diff = changed(without_registers(a["instructions"]),
                           without_registers(b["instructions"]))
        same_ops = not ops_diff
        result["sass"][dtype] = {"instructions": [len(a["instructions"]), len(b["instructions"])],
                                 "encodings_identical": same_enc,
                                 "instructions_identical": not diff,
                                 "differing_lines": len(diff),
                                 "identical_without_register_numbers": same_ops,
                                 "differing_lines_without_register_numbers": len(ops_diff)}
        print(f"sell_kernel one column {dtype}: ptxas other {built['other']['ptxas'].get(dtype)}, "
              f"this {built['this']['ptxas'].get(dtype)}; SASS {len(a['instructions'])} / "
              f"{len(b['instructions'])} instructions, encodings identical: {same_enc}, "
              f"instructions identical: {not diff}, identical without register numbers: "
              f"{same_ops}" + (f"; {len(diff)} differing lines, first: {diff[:12]}"
                               if diff else "")
              + (f"; without register numbers {len(ops_diff)}: {ops_diff[:24]}"
                 if ops_diff else ""))

    dev = torch.device("cuda", 0)
    dlls = {k: ctypes.CDLL(v["lib"]) for k, v in built.items()}
    cases = []
    for dt in (torch.float32, torch.float64):
        csr = smm.laplace_3d_jittered(m, symmetric=True, shift=0.25, dtype=dt, device=dev)
        ws = smm.try_wsell_from_csr(csr)
        cases.append((f"K7 jittered({m}) {str(dt)[6:]}", ws))
        if dt == torch.float32:
            ic = smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=4)
            cases.append((f"K7 IC(0) strict L jittered({m}) float32", ic.lower.wsell))
    gen = torch.Generator(device=dev).manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    wrapper = W.wsell_spmv
    for label, a in cases:
        s = a.sell
        name = str(s.dtype)[6:]
        word = torch.int32 if s.dtype == torch.float32 else torch.int64
        x = (torch.rand(a.shape[1], generator=gen, device=dev, dtype=torch.float64) - 0.5).to(
            s.dtype)
        ys, calls = {}, {}
        for key, dll in dlls.items():
            fn, y = entry(dll, name), torch.empty(a.shape[0], dtype=s.dtype, device=dev)

            def call(fn=fn, y=y):
                err = fn(s.vals.data_ptr(), s.cols.data_ptr(), s.chunk_ptr.data_ptr(),
                         s.row_of.data_ptr(), x.data_ptr(), y.data_ptr(), s.n_slabs,
                         s.shape[0], stream)
                if err != 0:
                    raise RuntimeError(f"{label}: CUDA error {err}")

            call()
            ys[key], calls[key] = y, call
        torch.cuda.synchronize()
        if not torch.equal(ys["other"].view(word), ys["this"].view(word)):
            raise RuntimeError(f"{label}: the two versions differ")
        readings = {"other": [], "this": []}
        for _ in range(rounds):
            for key in ("other", "this", "this", "other"):
                readings[key].append(median_ms(calls[key]))
        # the port's wrapper on the same inputs, timed as chip_smoke.py times
        # it, and the host's microseconds per call of the wrapper and of the
        # bare C entry (no sync between calls: the launches queue up)
        readings["wrapper"] = [median_ms(lambda: wrapper(a, x)) for _ in range(rounds)]
        host_us = {}
        for key, fn in (("wrapper", lambda: wrapper(a, x)), ("this", calls["this"])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            host_us[key] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        result["times"][label] = dict(readings, host_us_per_call=host_us)
        print(f"{label}: bit for bit equal; ms other {readings['other']}, this {readings['this']}, "
              f"through the wrapper {readings['wrapper']}; host us per call: wrapper "
              f"{host_us['wrapper']:.1f}, bare C entry {host_us['this']:.1f}")
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
