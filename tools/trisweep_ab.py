#!/usr/bin/env python3
"""Compare the fused sweep applies K4/K5 of two versions of
``sparse_matrix_math_tpu_torch/csrc/trisweep.cu`` on one CUDA card, and the
checkout's two variants and tiles against each other.

    python3 tools/trisweep_ab.py PARENT.cu|- [rounds] [sweeps] [SYSTEM ...]

PARENT.cu is an earlier version of the file whose C entries end in ``tile,
stream``, as they did before the ring kernel (window kernels at tile > 0,
per-sweep kernels at 0): for example the parent commit's, unpacked with
``git archive`` into the git-ignored ``chip_checkout/``; ``-`` times the
checkout's variants alone.  Both are built side by side with nvcc,
the port's flags (``ops/_build.py``) and ``-Xptxas -v`` into the git-ignored
``sparse_matrix_math_tpu_torch/build/trisweep_ab/``, and the checkout's
library is opted in through its own ``smm_trisweep_prepare``; then

* ptxas's registers, shared memory and spill stores of every kernel;
* on each case, every call's result held bit for bit to the plain
  version's (``ops/trisweep.py``), then each timed from a captured CUDA graph
  of 20 applies (``chip_smoke.graph_ms``) in the order parent, this,
  alternatives, alternatives reversed, this, parent in each of ``rounds``
  rounds (3 by default).  "this" is the checkout's entry at the variant the
  rule of ``ops/trisweep.py:variant_of`` picks; the alternatives are the
  checkout's other variants on the same inputs: ``ring`` (the ring kernel at
  its plan from the library's own occupancy query), ``window_split`` (the
  layout's chunks split over the SMs, the halo not considered) and
  ``window_halo_tile`` (a tile as long as the halo, where the halo outgrows
  the split), ``per_sweep`` (the per-sweep kernels on the stored diagonals,
  tile -1) and, for an SGS of a constant-coefficient stencil, ``scalar``
  (``smm_sgs_apply_scalar_*``), each where the rule picks another; an
  alternative whose shared memory the C entry refuses is left out.  The
  parent runs at the window kernels' tile where the checkout's rule gives
  one, else with its per-sweep kernels;
* the checkout's wrapper on the same inputs, timed as ``chip_smoke.median_ms``
  times it (CUDA events around back-to-back calls), and the host's
  microseconds per call of the wrapper and of the bare C entry.

Cases (``sweeps`` 4 by default), in float32 and float64: SGS, IC(0) and
ILU(0) on ``poisson_2d(1414)``, SGS and ILU(0) on
``convection_diffusion_2d(1414)``, SGS, IC(0) and ILU(0) on ``poisson_3d(243)``
and ``poisson_3d_27pt(128)`` (rings over the shared memory), SGS and IC(0) on
``poisson_3d(40)`` and ``poisson_3d(100)``, SGS on ``poisson_3d(64)`` and
``poisson_3d_27pt(24)`` (halos longer than the split tile), SGS on
``poisson_3d(72)``, ``(88)`` and ``(96)`` (0.7-3.3 of the ring kernel's
chunks an SM, around the rule's threshold), and SGS on
``poisson_3d_27pt(256)`` in float64 and ``poisson_3d(243) f32`` (the
benchmark's HPCG and 243^3 SGS cells; these two run only when named).  SYSTEM
arguments (e.g. ``poisson_3d(40)``) keep only those systems.  Each case
prints the variant and tile the rule takes, the bound (each input read
once, z written once) and the traffic of the two designs.  Prints the
card's name and power limit and, last, one JSON line.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

from ab_build import build  # noqa: E402
from chip_smoke import (apply_bytes, bound_ms, graph_ms, median_ms,  # noqa: E402
                        traffic_bytes)

_SRC = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "csrc", "trisweep.cu")
_OUT = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "build", "trisweep_ab")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# r, invd(_l), diag | invd_u, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1,
# out, sweeps, n_total, lead, n_rows, tile, [ring, ring_rows, sync, grid,]
# stream
_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _LL, _LL, _LL, _LL]


def entry(dll, sgs: bool, dtype_name: str, parent: bool):
    suffix = "f32" if dtype_name == "float32" else "f64"
    fn = getattr(dll, f"smm_{'sgs' if sgs else 'tri_pair'}_apply_{suffix}")
    fn.argtypes = _ARGS + ([] if parent else [_P, _I, _P, _I]) + [_P]
    fn.restype = ctypes.c_int
    return fn


def scalar_caller(torch, dll, T, pre, rp):
    """A call of the checkout's scalar-variant entry on fixed buffers."""
    f64 = rp.dtype == torch.float64
    word = ctypes.c_double if f64 else ctypes.c_float
    fn = getattr(dll, f"smm_sgs_apply_scalar_{'f64' if f64 else 'f32'}")
    fn.argtypes = [_P, _P, _P, _P, _I, _LL, _LL, _LL, _P, _P, _P, _I, _P, _P, _P, _I, word,
                   word, _LL, _LL, _LL, _LL, _P]
    fn.restype = ctypes.c_int
    w0, w1, out = (torch.empty_like(rp) for _ in range(3))
    grid = pre.p_lower or pre.p_upper

    def call():
        code = fn(rp.data_ptr(), w0.data_ptr(), w1.data_ptr(), out.data_ptr(), int(pre.sweeps),
                  pre.n_total, pre.lead, pre.shape[0], *T._scalar_args(pre.p_lower),
                  *T._scalar_args(pre.p_upper), *grid.const_diag, grid.nx, grid.ny, grid.row0,
                  grid.n_global, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"scalar: CUDA error {code}")
        return out

    return call


def ring_plan_of(dll, T, pre, sgs: bool, f64: bool, sms: int):
    """The ring kernel's plan for ``pre`` from the checkout library's own
    occupancy query (``ops/trisweep.py:_ring_plan`` asks the port's)."""
    blocks, chunk_l, chunk_u = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    lower, upper = T._offsets(pre.p_lower), T._offsets(pre.p_upper)
    code = dll.smm_trisweep_ring_blocks_per_sm(int(f64), int(sgs), len(lower), len(upper),
                                               int(pre.sweeps), ctypes.byref(blocks),
                                               ctypes.byref(chunk_l), ctypes.byref(chunk_u))
    if code != 0:
        raise RuntimeError(f"occupancy query: CUDA error {code}")
    grid = min(-(-pre.n_total // min(chunk_l.value, chunk_u.value)), blocks.value * sms)
    return T._ring_layout(lower, upper, int(pre.sweeps), grid, chunk_l.value, chunk_u.value)


def caller(torch, fn, pre, rp, sgs: bool, tile: int, plan=None, parent: bool = False,
           key: str = ""):
    """A call of the bare C entry on fixed buffers (a graph replays it): the
    parent's at ``tile``, or the checkout's at ``tile`` (0 with the ring
    kernel's ``plan``)."""
    first, second = ((pre.inv_diag_p, pre.diag_p) if sgs
                     else (pre.inv_diag_l_p, pre.inv_diag_u_p))
    facs = []
    for p in (pre.p_lower, pre.p_upper):
        if p is None:
            facs.append((None, torch.zeros(1, dtype=torch.int32).numpy(), 0))
        else:
            facs.append((p.diags_p.data_ptr(),
                         torch.tensor(p.offsets, dtype=torch.int32).numpy(), len(p.offsets)))
    (ld, lo, nl), (ud, uo, nu) = facs
    w0, w1, out = (torch.empty_like(rp) for _ in range(3))
    tail, keep = [], []
    if not parent:
        ring = sync = None
        if plan is not None:
            ring = torch.empty(max(plan.ring_levels * plan.ring_rows, 1), dtype=rp.dtype,
                               device=rp.device)
            sync = torch.empty(2 + 2 * -(-pre.n_total // 1024), dtype=torch.int32,
                               device=rp.device)
        tail = [None if ring is None else ring.data_ptr(), 0 if plan is None else plan.ring_rows,
                None if sync is None else sync.data_ptr(), 0 if plan is None else plan.grid]
        keep = [ring, sync]  # alive as long as the call

    def call():
        code = fn(rp.data_ptr(), first.data_ptr(), second.data_ptr(), ld, lo.ctypes.data, nl,
                  ud, uo.ctypes.data, nu, w0.data_ptr(), w1.data_ptr(), out.data_ptr(),
                  int(pre.sweeps), pre.n_total, pre.lead, pre.shape[0], tile, *tail,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{key} (tile {tile}): CUDA error {code}")
        return out

    call.keep = keep
    return call


def bits(torch, t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = None if sys.argv[1] == "-" else os.path.abspath(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sweeps = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    only = set(sys.argv[4:])
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.precond import PaddedSGS, PaddedTriPair

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    built = build({"this": _SRC} if parent is None else {"parent": parent, "this": _SRC}, _OUT,
                  "libtrisweep")
    for key, b in built.items():
        for name, info in b["ptxas"].items():
            print(f"ptxas {key} {name}: {info}")
    dlls = {k: ctypes.CDLL(v["lib"]) for k, v in built.items()}
    this_dll = dlls["this"]
    this_dll.smm_trisweep_prepare.argtypes = []
    this_dll.smm_trisweep_ring_blocks_per_sm.argtypes = [_I, _I, _I, _I, _I, _P, _P, _P]
    if this_dll.smm_trisweep_prepare() != 0:
        raise RuntimeError("smm_trisweep_prepare failed")
    result = {"device": smi, "parent": parent, "sweeps": sweeps,
              "ptxas": {k: v["ptxas"] for k, v in built.items()}, "cases": {}}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    systems = [("poisson_2d(1414)", smm.poisson_2d, (1414,), ("sgs", "ic0", "ilu0")),
               ("convection_diffusion_2d(1414)", smm.convection_diffusion_2d, (1414,),
                ("sgs", "ilu0")),
               ("poisson_3d(243)", smm.poisson_3d, (243,), ("sgs", "ic0", "ilu0")),
               ("poisson_3d_27pt(128)", smm.poisson_3d_27pt, (128,), ("sgs", "ic0", "ilu0")),
               ("poisson_3d(40)", smm.poisson_3d, (40,), ("sgs", "ic0")),
               ("poisson_3d(64)", smm.poisson_3d, (64,), ("sgs",)),
               ("poisson_3d(72)", smm.poisson_3d, (72,), ("sgs",)),
               ("poisson_3d(88)", smm.poisson_3d, (88,), ("sgs",)),
               ("poisson_3d(96)", smm.poisson_3d, (96,), ("sgs",)),
               ("poisson_3d(100)", smm.poisson_3d, (100,), ("sgs", "ic0")),
               ("poisson_3d_27pt(24)", smm.poisson_3d_27pt, (24,), ("sgs",))]
    named = [("poisson_3d_27pt(256)", smm.poisson_3d_27pt, (256,), ("sgs",), torch.float64),
             ("poisson_3d(243) f32", smm.poisson_3d, (243,), ("sgs",), torch.float32)]
    systems = [s + (None,) for s in systems]
    if only:
        systems = [s for s in systems + named if s[0] in only]
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, make, args, kinds, only_dtype in systems:
        csr = make(*args, device=dev)
        dia64 = smm.dia_from_csr(csr)
        for kind in kinds:
            if kind == "sgs":
                pre64 = PaddedSGS.from_dia(dia64, sweeps=sweeps)
            else:
                fac = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=sweeps,
                                             strict_layout="csr")
                pre64 = PaddedTriPair.from_factors(fac.lower, fac.upper, dia64)
            sgs = kind == "sgs"
            fused, plain = ((T.sgs_apply_fused, T.sgs_apply_plain) if sgs
                            else (T.tri_pair_apply_fused, T.tri_pair_apply_plain))
            for dtype in (torch.float32, torch.float64):
                if only_dtype not in (None, dtype):
                    continue
                name = str(dtype).removeprefix("torch.")
                pre = pre64.astype(dtype)
                rp = torch.zeros(pre.n_total, dtype=dtype, device=dev)
                rp[pre.lead:pre.lead + pre.shape[0]] = (
                    torch.rand(pre.shape[0], generator=gen, device=dev, dtype=torch.float64)
                    - 0.5).to(dtype)
                variant = T.variant_of(pre, sms, rp.element_size())
                tile = T.window_tile(pre, sms, rp.element_size())
                f64 = dtype == torch.float64
                this_fn = entry(this_dll, sgs, name, False)
                plan = ring_plan_of(this_dll, T, pre, sgs, f64, sms)
                scalar = sgs and T._is_scalar(pre)
                calls = {}
                if parent is not None:
                    calls["parent"] = caller(torch, entry(dlls["parent"], sgs, name, True), pre,
                                             rp, sgs, tile, parent=True, key="parent")
                if variant == "scalar":
                    calls["this"] = scalar_caller(torch, this_dll, T, pre, rp)
                else:
                    this_tile = {"window": tile, "ring": 0, "per-sweep": -1}[variant]
                    calls["this"] = caller(torch, this_fn, pre, rp, sgs, this_tile,
                                           plan if variant == "ring" else None, key="this")
                split = -(-pre.n_total // (T.CHUNK * sms)) * T.CHUNK
                halo = max((T._levels(o, sweeps) - 1) * T._reach(o)
                           for o in (T._offsets(pre.p_lower), T._offsets(pre.p_upper)))
                halo_tile = -(-halo // T.CHUNK) * T.CHUNK
                alternatives = {} if variant == "ring" else {"ring": 0}
                if variant != "window":
                    alternatives["window_split"] = split
                    if halo_tile > split:
                        alternatives["window_halo_tile"] = halo_tile
                if variant != "per-sweep":
                    alternatives["per_sweep"] = -1
                refused = []
                if scalar and variant != "scalar":
                    calls["scalar"] = scalar_caller(torch, this_dll, T, pre, rp)
                for key, alt in alternatives.items():
                    call = caller(torch, this_fn, pre, rp, sgs, alt, plan if alt == 0 else None,
                                  key=key)
                    try:
                        call()
                    except RuntimeError:  # the C entry's shared-memory check
                        refused.append(key)
                        continue
                    calls[key] = call
                alts = [k for k in alternatives if k in calls] + (
                    ["scalar"] if "scalar" in calls else [])
                want = plain(pre, rp)
                for key, call in calls.items():
                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(bits(torch, got), bits(torch, want)):
                        raise RuntimeError(f"{label} {kind} {name}: {key} differs from the "
                                           "plain version")
                ends = ["this"] if parent is None else ["parent", "this"]
                order = [*ends, *alts, *reversed(alts), *reversed(ends)]
                readings = {k: [] for k in calls}
                for _ in range(rounds):
                    for key in order:
                        readings[key].append(graph_ms(torch, calls[key]))
                readings["wrapper"] = [median_ms(lambda: fused(pre, rp), samples=5, calls=10)
                                       for _ in range(rounds)]
                host_us = {}
                for key, fn in (("wrapper", lambda: fused(pre, rp)), ("this", calls["this"])):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(100):
                        fn()
                    host_us[key] = (time.perf_counter() - t0) / 100 * 1e6
                    torch.cuda.synchronize()
                nbytes = apply_bytes(pre, sgs, rp.element_size())
                tag = f"{kind} {label} {name} sweeps={sweeps}"
                case = {"variant": variant, "tile": tile, "split_tile": split, "halo": halo,
                        "alternatives": {k: alternatives.get(k, "scalar") for k in alts},
                        "refused": refused, "bound_ms": bound_ms(nbytes),
                        "bound_bytes": nbytes,
                        "traffic_bound_ms": {v: bound_ms(traffic_bytes(pre, sgs,
                                                                       rp.element_size(), v))
                                             for v in ("window", "ring", "per-sweep", "scalar")},
                        "ring_plan": dataclasses.asdict(plan),
                        "ms": readings, "host_us_per_call": host_us}
                med = {k: statistics.median(v) for k, v in readings.items()}
                case["median_ms"] = med
                case["parent_over_this"] = med["parent"] / med["this"] if parent else None
                result["cases"][tag] = case
                print(f"{tag}: {variant} (tile {tile}, split {split}, halo {halo}; refused "
                      f"{refused or 'none'}), all bit for bit the plain version; "
                      f"bound {case['bound_ms']:.4f} ms; medians (ms) "
                      + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
                      + f"; parent / this {case['parent_over_this']}; this at "
                      f"{100 * case['bound_ms'] / med['this']:.0f}% of the bound; host us per "
                      f"call: wrapper {host_us['wrapper']:.1f}, bare C entry "
                      f"{host_us['this']:.1f}; readings {readings}")
                del pre, rp, want, calls
            del pre64
        del csr, dia64
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
