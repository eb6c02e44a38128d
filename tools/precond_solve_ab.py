#!/usr/bin/env python3
"""Time the preconditioned DIA solves of one checkout of the PyTorch port on one CUDA card.

    python3 tools/precond_solve_ab.py ROOT

ROOT is the root of a checkout holding ``sparse_matrix_math_tpu_torch/`` (this
repo's root, or an unpacked ``git archive`` of another commit); the package is
imported from there, so two commits are compared by running this script on
each in turns within one machine (parent, change, change, parent).  On the
bench system ``poisson_2d(1414)`` in float32, b = A·ones, eps 1e-4 (``chip_smoke.py``
phase P): CG with ``SGSPreconditioner`` (K4 every iteration) and with
``IC0Preconditioner`` (K5), both ``method="jacobi", sweeps=4``; each solve
run once to warm up, then timed 5 times (host clock, synchronized; median
and least), then once under ``torch.profiler`` for the device's kernel time
per iteration, its busy share of that run's wall, and the sweep kernels'
share of the device time (kernels named ``window_kernel``, ``scale_kernel``
or ``sweep_kernel``).  Then the host's microseconds per call of the K4 and
K5 wrappers (``sgs_apply_fused`` on the SGS layout, ``tri_pair_apply_fused``
on the IC(0) pair, sweeps 4): 200 calls back to back on the host clock,
without a sync inside, median and least of 5 samples.  Prints the card's
name and power limit and one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def profiled(torch, solve):
    """Device kernel time (us) of one solve under torch.profiler, the sweep
    kernels' part of it, and the solve's wall (s) there."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = solve()
        float(res.residual_norm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = sweeps = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation:
            continue
        device += ev.self_device_time_total
        if any(k in ev.key for k in ("window_kernel", "scale_kernel", "sweep_kernel")):
            sweeps += ev.self_device_time_total
    return device, sweeps, wall


def host_us_per_call(torch, fn, calls: int = 200, samples: int = 5):
    """Median and least host microseconds per call of ``fn``."""
    for _ in range(20):
        fn()
    times = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(times), min(times)


def wrapper_host_us(torch, smm, csr, dev):
    """Host µs per call of the K4 and K5 wrappers at the bench system."""
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.precond import PaddedSGS, PaddedTriPair

    dia = smm.dia_from_csr(csr)
    fac = smm.get_preconditioner(csr, "ic0", method="jacobi", sweeps=4, strict_layout="csr")
    out = {}
    for label, pre, fused in (
            ("sgs_apply", PaddedSGS.from_dia(dia, sweeps=4), T.sgs_apply_fused),
            ("tri_pair_apply ic0", PaddedTriPair.from_factors(fac.lower, fac.upper, dia),
             T.tri_pair_apply_fused)):
        rp = torch.zeros(pre.n_total, dtype=torch.float32, device=dev)
        rp[pre.lead:pre.lead + pre.shape[0]] = 1.0
        median, least = host_us_per_call(torch, lambda: fused(pre, rp))
        out[label] = {"host_us_per_call": median, "least_host_us_per_call": least}
        print(f"{label} wrapper f32: host {median:.1f} us per call (least {least:.1f})")
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print("usage: precond_solve_ab.py ROOT, on a machine with a CUDA card", file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import sparse_matrix_math_tpu_torch as smm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    out = {"root": sys.argv[1], "card": smi, "package": smm.__file__}
    csr = smm.poisson_2d(1414, dtype=torch.float32, device=dev)
    b = csr @ torch.ones(csr.shape[1], dtype=torch.float32, device=dev)
    for label, cls in (("cg+sgs(4) f32", smm.SGSPreconditioner),
                       ("pcg+ic0(4) f32", smm.IC0Preconditioner)):
        pre = cls.from_matrix(csr, method="jacobi", sweeps=4)

        def solve(pre=pre):
            return smm.cg(csr, b, epsilon=1e-4, max_iterations=6000, preconditioner=pre)

        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = solve()
            float(res.residual_norm)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        its = max(res.iterations, 1)
        device_us, sweep_us, prof_wall = profiled(torch, solve)
        out[label] = {"status": int(res.status), "iterations": res.iterations,
                      "us_per_iteration": 1e6 * statistics.median(walls[1:]) / its,
                      "least_us_per_iteration": 1e6 * min(walls[1:]) / its,
                      "device_us_per_iteration": device_us / its,
                      "sweep_kernels_us_per_iteration": sweep_us / its,
                      "device_busy_share": device_us / (1e6 * prof_wall)}
        print(label, out[label])
    out["wrappers"] = wrapper_host_us(torch, smm, csr, dev)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
