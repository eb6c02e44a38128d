#!/usr/bin/env python3
"""Compare K2/K3, the padded DIA product, of two versions of
``sparse_matrix_math_tpu_torch/csrc/dia_spmv.cu`` on one CUDA card, and the
checkout's kernels and plans against each other.

    python3 tools/dia_ab.py PARENT.cu [rounds] [SYSTEM ...]

PARENT.cu is an earlier version of the file (for example the parent
commit's, unpacked with ``git archive`` into the git-ignored
``chip_checkout/``): one whose padded entries take no plan (the
one-thread-per-row kernel alone), or one that takes the checkout's plan
arguments, which it is then given.  Both are built side by side
(``tools/ab_build.py``: nvcc, the port's flags and ``-Xptxas -v``) into the
git-ignored ``sparse_matrix_math_tpu_torch/build/dia_ab/``; then

* ptxas's registers, shared memory, stack frame and spill stores of every
  kernel;
* on each case, every call's result held bit for bit to the plain version
  ``dia_spmv_padded_plain``, then each timed from a captured CUDA graph of
  20 calls (``chip_smoke.graph_ms``) in the order parent, this,
  alternatives, alternatives reversed, this, parent in each of ``rounds``
  rounds (3 by default).  "this" is the checkout's entry with the plan the
  rule of ``ops/dia_spmv.py:staged_plan`` picks; the alternatives are the
  checkout's other choices on the same inputs (``alternatives``): the row
  kernel and the staged kernel at every tile that fits;
* the same calls cold: a CUDA graph of 20 times (a 64 MB buffer written,
  then the call), less a graph of the 64 MB writes alone, per call, for
  parent, this and the row kernel (the diagonals at 5 points, 40-56 MB,
  otherwise partly stay in the 50 MB L2 from one call to the next);
* the checkout's wrapper ``dia_spmv_padded`` on the same inputs, timed as
  ``chip_smoke.median_ms`` times it, and the host's microseconds per call
  of the wrapper and of both bare C entries.

Cases: ``poisson_2d(1414)``, ``convection_diffusion_2d(1414)``,
``poisson_3d(243)`` and ``poisson_3d_27pt(128)``, the smaller
``poisson_2d(400)`` and ``poisson_2d(200)`` (where the rule's tiles-per-SM
threshold falls) and ``scattered(64)`` (2M rows, 64 random diagonals 1,000
apart, each its own segment), each in float32, float64, and bfloat16 and
float16 diagonals with float32 x.  SYSTEM arguments keep only those
systems; any generator of the package with one size argument may be named
(e.g. ``poisson_3d(80)``).  Each case prints the plan the rule takes and the
bound (``chip_smoke.k2_bytes``: the active rows' diagonals and x once, y
over the layout).  Prints the card's name and power limit and, last, one
JSON line.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from ab_build import build  # noqa: E402
from chip_smoke import bound_ms, graph_ms, k2_bytes, median_ms  # noqa: E402

_SRC = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "csrc", "dia_spmv.cu")
_OUT = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "build", "dia_ab")
_FLUSH_BYTES = 64 << 20

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PARENT_ARGS = [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P]
_THIS_ARGS = [_P, _P, _P, _P, _I, _LL, _LL, _LL, _I, _P, _LL, _LL, _P]
_ENTRY = {"float32": "smm_dia_spmv_padded_f32", "float64": "smm_dia_spmv_padded_f64",
          "bfloat16": "smm_dia_spmv_padded_bf16_f32",
          "float16": "smm_dia_spmv_padded_f16_f32"}


def caller(torch, K, dll, fn, p, xp, plan, parent: bool):
    """A call of a bare C entry ``fn`` of ``dll`` on fixed buffers (a graph
    replays it): ``plan`` None for the row kernel; the plan's arguments as
    the wrapper gives them (``ops/dia_spmv.py:_launch_args``), the staged
    kernel of ``dll`` opted in to the card's shared memory first (the
    wrapper's query opts in the package's own library only)."""
    offs = torch.tensor(p.offsets, dtype=torch.int32).numpy()
    y = torch.empty_like(xp)
    tail = [] if parent else list(K._launch_args(p, plan, xp.device.index))
    if tail and plan is not None:
        query = dll.smm_dia_staged_blocks_per_sm
        query.argtypes, query.restype = [_I, _I, _LL, _P], ctypes.c_int
        smem = K._HEADER_BYTES + K._STAGES * tail[2]
        code = query(K._PADDED_ENTRY[p.dtype][2], plan.tile, smem,
                     ctypes.byref(ctypes.c_int(0)))
        if code != 0:
            raise RuntimeError(f"CUDA error {code} opting in the staged kernel")

    def call():
        code = fn(p.diags_p.data_ptr(), xp.data_ptr(), y.data_ptr(), offs.ctypes.data,
                  len(p.offsets), p.n_total, p.lead, p.shape[0], *tail,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")
        return y

    return call


def bits(torch, t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def alternatives(K, p, plan, x_size: int) -> dict:
    """The checkout's other choices on one layout, by name: the row kernel,
    and the staged kernel at every tile that fits."""
    nd, d_size = len(p.offsets), p.diags_p.element_size()
    out = {} if plan is None else {"rows": None}
    for tile in K.STAGED_TILES:
        cand = K.StagedPlan(tile, K.x_clusters(p.offsets, tile, x_size))
        if cand != plan and cand.smem_bytes(nd, d_size, x_size) <= K._SMEM_BYTES:
            out[f"staged_t{tile}"] = cand
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    only = list(dict.fromkeys(sys.argv[3:]))
    with open(parent) as f:
        parent_takes_plan = "long long stage_bytes, long long grid" in f.read()
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    built = build({"parent": parent, "this": _SRC}, _OUT, "libdia")
    for key, b in built.items():
        for name, info in b["ptxas"].items():
            print(f"ptxas {key} {name}: {info}")
    dlls = {k: ctypes.CDLL(v["lib"]) for k, v in built.items()}
    result = {"device": smi, "parent": parent,
              "ptxas": {k: v["ptxas"] for k, v in built.items()}, "cases": {}}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)

    def stencil(make, *args):
        return lambda: smm.dia_from_csr(make(*args, dtype=torch.float64, device=dev))

    def scattered():
        n, offsets = 2_000_000, tuple(range(-32_000, 32_000, 1_000))
        diags = torch.rand((len(offsets), n), generator=gen, device=dev, dtype=torch.float64)
        return smm.DIAMatrix(diags=diags, offsets=offsets, shape=(n, n), nnz=0)

    systems = [("poisson_2d(1414)", stencil(smm.poisson_2d, 1414)),
               ("convection_diffusion_2d(1414)", stencil(smm.convection_diffusion_2d, 1414)),
               ("poisson_3d(243)", stencil(smm.poisson_3d, 243)),
               ("poisson_3d_27pt(128)", stencil(smm.poisson_3d_27pt, 128)),
               ("poisson_2d(400)", stencil(smm.poisson_2d, 400)),
               ("poisson_2d(200)", stencil(smm.poisson_2d, 200)),
               ("scattered(64)", scattered)]
    if only:
        known = dict(systems)
        systems = []
        for label in only:
            m = re.fullmatch(r"(\w+)\((\d+)\)", label)
            if label not in known and not (m and hasattr(smm, m.group(1))):
                raise SystemExit(f"unknown system {label}")
            systems.append((label, known.get(label) or stencil(getattr(smm, m.group(1)),
                                                               int(m.group(2)))))
    flush = torch.empty(_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for label, make in systems:
        dia64 = make()
        for name in ("float32", "float64", "bfloat16", "float16"):
            d_dtype = getattr(torch, name)
            x_dtype = d_dtype if name in ("float32", "float64") else torch.float32
            p = K.pad_dia(dia64.astype(x_dtype))
            if d_dtype != x_dtype:
                p = dataclasses.replace(p, diags_p=p.diags_p.to(d_dtype))
            n = p.shape[0]
            xp = p.to_padded((torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
                              - 0.5).to(x_dtype))
            plan = K.staged_plan(p.offsets, p.n_total, d_dtype, x_dtype, sms)
            this_fn = getattr(dlls["this"], _ENTRY[name])
            this_fn.argtypes, this_fn.restype = _THIS_ARGS, ctypes.c_int
            par_fn = getattr(dlls["parent"], _ENTRY[name])
            par_fn.argtypes = _THIS_ARGS if parent_takes_plan else _PARENT_ARGS
            par_fn.restype = ctypes.c_int
            calls = {"parent": caller(torch, K, dlls["parent"], par_fn, p, xp, plan,
                                      not parent_takes_plan),
                     "this": caller(torch, K, dlls["this"], this_fn, p, xp, plan, False)}
            alts = alternatives(K, p, plan, x_dtype.itemsize)
            calls.update({key: caller(torch, K, dlls["this"], this_fn, p, xp, alt, False)
                          for key, alt in alts.items()})
            want = K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, n, xp)
            for key, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                if not torch.equal(bits(torch, got), bits(torch, want)):
                    raise RuntimeError(f"{label} {name}: {key} differs from the plain version")
            order = ["parent", "this", *alts, *reversed(list(alts)), "this", "parent"]
            readings = {k: [] for k in calls}
            cold = {k: [] for k in ("parent", "this", "rows") if k in calls}
            for _ in range(rounds):
                for key in order:
                    readings[key].append(graph_ms(torch, calls[key]))
                for key in [*cold, *reversed(list(cold))]:
                    both = graph_ms(torch, lambda c=calls[key]: (flush.zero_(), c()))
                    cold[key].append(both - graph_ms(torch, flush.zero_))
            readings["wrapper"] = [median_ms(lambda: K.dia_spmv_padded(p, xp), samples=5,
                                             calls=10) for _ in range(rounds)]
            host_us = {}
            for key, fn in (("wrapper", lambda: K.dia_spmv_padded(p, xp)),
                            ("this", calls["this"]), ("parent", calls["parent"])):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    fn()
                host_us[key] = (time.perf_counter() - t0) / 100 * 1e6
                torch.cuda.synchronize()
            nbytes = k2_bytes(p, x_dtype.itemsize)
            med = {k: statistics.median(v) for k, v in readings.items()}
            cold_med = {k: statistics.median(v) for k, v in cold.items()}
            tag = f"{label} {name}"
            case = {"ndiags": len(p.offsets), "n_total": p.n_total,
                    "variant": K.variant(p, dev),
                    "plan": None if plan is None else dataclasses.asdict(plan),
                    "alternatives": {k: dataclasses.asdict(v) if v else None
                                     for k, v in alts.items()},
                    "bound_ms": bound_ms(nbytes), "bound_bytes": nbytes,
                    "ms": readings, "median_ms": med, "cold_ms": cold,
                    "cold_median_ms": cold_med,
                    "parent_over_this": med["parent"] / med["this"],
                    "host_us_per_call": host_us}
            result["cases"][tag] = case
            print(f"{tag}: {case['variant']}, {len(p.offsets)} diagonals, n_total {p.n_total}, "
                  f"all bit for bit the plain version; bound {case['bound_ms']:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB); medians (ms) "
                  + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
                  + f"; parent / this {case['parent_over_this']:.3f}; this at "
                  f"{100 * case['bound_ms'] / med['this']:.0f}% of the bound; cold medians "
                  + ", ".join(f"{k} {v:.4f}" for k, v in cold_med.items())
                  + f"; host us per call: wrapper {host_us['wrapper']:.1f}, bare C entry "
                  f"{host_us['this']:.1f} (parent's {host_us['parent']:.1f})"
                  + f"; readings {readings}; cold {cold}")
            del p, xp, want, calls
            torch.cuda.empty_cache()
        del dia64
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
