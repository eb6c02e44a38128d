#!/usr/bin/env python3
"""Time the general-pattern solves of one checkout of the PyTorch port on one CUDA card.

    python3 tools/general_solve_ab.py ROOT

ROOT is the root of a checkout holding ``sparse_matrix_math_tpu_torch/`` (this
repo's root, or an unpacked ``git archive`` of another commit); the package is
imported from there, so two commits are compared by running this script on
each in turns within one machine (parent, change, change, parent).  On
``laplace_3d_jittered(113, symmetric=True, shift=0.25)`` (the JAX bench's
general-pattern system, b = A·ones/‖A·ones‖): CG f32 (eps 1e-4) and f64 (eps
1e-8) through the W-SELL route, PCG + IC0(4) (Jacobi sweeps, strict factors in
W-SELL) in both, and CG f32 on the ELL layout; each solve run once to warm
up, then timed 5 times (host clock, synchronized; median and least), then
once under ``torch.profiler`` for the device's kernel time per iteration and
its busy share of that run's wall.  Also the K7 and K6 products alone (CUDA
events, median of 11 × 20 calls).  Prints the card's name and power limit and
one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# the timing helper of this checkout's chip_smoke.py, whatever ROOT is
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import median_ms  # noqa: E402


def profiled(torch, solve):
    """Device kernel time (us) of one solve under torch.profiler, and the
    solve's wall (s) there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve()
        float(res.residual_norm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device's own events only: a CPU op's device time repeats its kernels'
    device = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not ev.is_user_annotation)
    return device, wall


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: general_solve_ab.py ROOT, on a machine with a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    out = {"root": sys.argv[1], "card": smi, "package": smm.__file__}
    for dt, eps in ((torch.float32, 1e-4), (torch.float64, 1e-8)):
        name = str(dt)[6:]
        csr = smm.laplace_3d_jittered(113, symmetric=True, shift=0.25, dtype=dt, device=dev)
        ws = smm.auto_route_for_solve(csr)
        ic = smm.IC0Preconditioner.from_matrix(csr, method="jacobi", sweeps=4)
        ab = ws @ torch.ones(csr.shape[1], dtype=dt, device=dev)
        b = ab / torch.linalg.norm(ab)
        cases = [(f"cg {name}", csr, {}), (f"pcg+ic0(4) {name}", csr, dict(preconditioner=ic))]
        if dt == torch.float32:
            ell = smm.ell_from_csr(csr)
            cases.append((f"cg ELL {name}", ell, {}))
            x = torch.rand(csr.shape[1], dtype=dt, device=dev) - 0.5
            out["k7_ms"] = median_ms(lambda: W.wsell_spmv(ws, x))
            out["k6_ms"] = median_ms(lambda: E.ell_spmv(ell, x))
        for label, a, kw in cases:
            walls = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = smm.cg(a, b, epsilon=eps, max_iterations=600, **kw)
                float(res.residual_norm)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            its = max(res.iterations, 1)
            device_us, prof_wall = profiled(torch, lambda: smm.cg(a, b, epsilon=eps,
                                                                  max_iterations=600, **kw))
            out[label] = {"status": int(res.status), "iterations": res.iterations,
                          "us_per_iteration": 1e6 * statistics.median(walls[1:]) / its,
                          "least_us_per_iteration": 1e6 * min(walls[1:]) / its,
                          "device_us_per_iteration": device_us / its,
                          "device_busy_share": device_us / (1e6 * prof_wall)}
        del csr, ws, ic, ab, b
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
