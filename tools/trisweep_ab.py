#!/usr/bin/env python3
"""Compare the fused sweep applies K4/K5 of two versions of
``sparse_matrix_math_tpu_torch/csrc/trisweep.cu`` on one CUDA card, and the
checkout's two variants and tiles against each other.

    python3 tools/trisweep_ab.py PARENT.cu [rounds] [sweeps] [SYSTEM ...]

PARENT.cu is an earlier version of the file with the per-sweep kernels and
no tile argument (for example the parent commit's, unpacked with ``git
archive`` into the git-ignored ``chip_checkout/``).  Both are built side by
side with nvcc, the port's flags (``ops/_build.py``) and ``-Xptxas -v`` into
the git-ignored ``sparse_matrix_math_tpu_torch/build/trisweep_ab/``; then

* ptxas's registers, shared memory and spill stores of every kernel;
* on each case, every call's result held bit for bit to the plain
  version's (``ops/trisweep.py``), then each timed from a captured CUDA graph
  of 20 applies (``chip_smoke.graph_ms``) in the order parent, this,
  alternatives, alternatives reversed, this, parent in each of ``rounds``
  rounds (3 by default).  "this" is the checkout's entry at the tile the
  rule of ``ops/trisweep.py:window_tile`` picks; the alternatives are the
  checkout's other choices on the same inputs: ``per_sweep`` (tile 0) where
  the rule picks the window kernels, ``window_split`` (the layout's chunks
  split over the SMs, the halo not considered) where it picks the per-sweep
  kernels, and ``window_halo_tile`` (a tile as long as the halo) where the
  halo outgrows the split; an alternative whose shared memory the C entry
  refuses is left out;
* the checkout's wrapper on the same inputs, timed as ``chip_smoke.median_ms``
  times it (CUDA events around back-to-back calls), and the host's
  microseconds per call of the wrapper and of the bare C entry.

Cases (``sweeps`` 4 by default), in float32 and float64: SGS, IC(0) and
ILU(0) on ``poisson_2d(1414)``, SGS and ILU(0) on
``convection_diffusion_2d(1414)``, SGS on ``poisson_3d(243)`` and
``poisson_3d_27pt(128)`` (rings over the shared memory), SGS and IC(0) on
``poisson_3d(40)`` and ``poisson_3d(100)``, SGS on ``poisson_3d(64)`` and
``poisson_3d_27pt(24)`` (halos longer than the split tile).  SYSTEM
arguments (e.g. ``poisson_3d(40)``) keep only those systems.  Each case
prints the variant and tile the rule takes, the bound (each input read
once, z written once) and the traffic of the two designs.  Prints the
card's name and power limit and, last, one JSON line.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
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
# out, sweeps, n_total, lead, n_rows, [tile,] stream
_ARGS = [_P, _P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _LL, _LL, _LL]


def entry(dll, sgs: bool, dtype_name: str, with_tile: bool):
    suffix = "f32" if dtype_name == "float32" else "f64"
    fn = getattr(dll, f"smm_{'sgs' if sgs else 'tri_pair'}_apply_{suffix}")
    fn.argtypes = _ARGS + ([_LL] if with_tile else []) + [_P]
    fn.restype = ctypes.c_int
    return fn


def caller(torch, fn, pre, rp, sgs: bool, tile):
    """A call of the bare C entry on fixed buffers (a graph replays it);
    ``tile`` None for an entry without the argument."""
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
    tail = [] if tile is None else [tile]

    def call():
        code = fn(rp.data_ptr(), first.data_ptr(), second.data_ptr(), ld, lo.ctypes.data, nl,
                  ud, uo.ctypes.data, nu, w0.data_ptr(), w1.data_ptr(), out.data_ptr(),
                  int(pre.sweeps), pre.n_total, pre.lead, pre.shape[0], *tail,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"CUDA error {code}")
        return out

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
    parent = os.path.abspath(sys.argv[1])
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sweeps = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    only = set(sys.argv[4:])
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.precond import PaddedSGS, PaddedTriPair

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    built = build({"parent": parent, "this": _SRC}, _OUT, "libtrisweep")
    for key, b in built.items():
        for name, info in b["ptxas"].items():
            print(f"ptxas {key} {name}: {info}")
    dlls = {k: ctypes.CDLL(v["lib"]) for k, v in built.items()}
    result = {"device": smi, "parent": parent, "sweeps": sweeps,
              "ptxas": {k: v["ptxas"] for k, v in built.items()}, "cases": {}}
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    systems = [("poisson_2d(1414)", smm.poisson_2d, (1414,), ("sgs", "ic0", "ilu0")),
               ("convection_diffusion_2d(1414)", smm.convection_diffusion_2d, (1414,),
                ("sgs", "ilu0")),
               ("poisson_3d(243)", smm.poisson_3d, (243,), ("sgs",)),
               ("poisson_3d_27pt(128)", smm.poisson_3d_27pt, (128,), ("sgs",)),
               ("poisson_3d(40)", smm.poisson_3d, (40,), ("sgs", "ic0")),
               ("poisson_3d(64)", smm.poisson_3d, (64,), ("sgs",)),
               ("poisson_3d(100)", smm.poisson_3d, (100,), ("sgs", "ic0")),
               ("poisson_3d_27pt(24)", smm.poisson_3d_27pt, (24,), ("sgs",))]
    if only:
        systems = [s for s in systems if s[0] in only]
    gen = torch.Generator(device=dev).manual_seed(5)
    for label, make, args, kinds in systems:
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
                name = str(dtype).removeprefix("torch.")
                pre = pre64.astype(dtype)
                rp = torch.zeros(pre.n_total, dtype=dtype, device=dev)
                rp[pre.lead:pre.lead + pre.shape[0]] = (
                    torch.rand(pre.shape[0], generator=gen, device=dev, dtype=torch.float64)
                    - 0.5).to(dtype)
                tile = T.window_tile(pre, sms, rp.element_size())
                variant = "window" if tile else "per-sweep"
                this_fn = entry(dlls["this"], sgs, name, True)
                calls = {"parent": caller(torch, entry(dlls["parent"], sgs, name, False), pre,
                                          rp, sgs, None),
                         "this": caller(torch, this_fn, pre, rp, sgs, tile)}
                split = -(-pre.n_total // (T.CHUNK * sms)) * T.CHUNK
                halo = max((T._levels(o, sweeps) - 1) * T._reach(o)
                           for o in (T._offsets(pre.p_lower), T._offsets(pre.p_upper)))
                halo_tile = -(-halo // T.CHUNK) * T.CHUNK
                alternatives = {"per_sweep": 0} if tile else {"window_split": split}
                if halo_tile > split:
                    alternatives["window_halo_tile"] = halo_tile
                refused = []
                for key, alt in alternatives.items():
                    call = caller(torch, this_fn, pre, rp, sgs, alt)
                    try:
                        call()
                    except RuntimeError:  # the C entry's shared-memory check
                        refused.append(key)
                        continue
                    calls[key] = call
                alts = [k for k in alternatives if k in calls]
                want = plain(pre, rp)
                for key, call in calls.items():
                    got = call()
                    torch.cuda.synchronize()
                    if not torch.equal(bits(torch, got), bits(torch, want)):
                        raise RuntimeError(f"{label} {kind} {name}: {key} differs from the "
                                           "plain version")
                order = ["parent", "this", *alts, *reversed(alts), "this", "parent"]
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
                        "alternatives": {k: alternatives[k] for k in alts},
                        "refused": refused, "bound_ms": bound_ms(nbytes),
                        "bound_bytes": nbytes,
                        "traffic_bound_ms": {v: bound_ms(traffic_bytes(pre, sgs,
                                                                       rp.element_size(), v))
                                             for v in ("window", "per-sweep")},
                        "ms": readings, "host_us_per_call": host_us}
                med = {k: statistics.median(v) for k, v in readings.items()}
                case["median_ms"] = med
                case["parent_over_this"] = med["parent"] / med["this"]
                result["cases"][tag] = case
                print(f"{tag}: {variant} (tile {tile}, split {split}, halo {halo}; refused "
                      f"{refused or 'none'}), all bit for bit the plain version; "
                      f"bound {case['bound_ms']:.4f} ms; medians (ms) "
                      + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
                      + f"; parent / this {case['parent_over_this']:.2f}; this at "
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
