#!/usr/bin/env python3
"""K2 (the padded DIA product) as the solves see it, for the checkout at
ROOT on one CUDA card, so that two checkouts can be compared in one call.

    python3 tools/k2_solve_run.py ROOT

ROOT is a checkout of the repository (this one, or another commit's,
unpacked with ``git archive`` into the git-ignored ``chip_checkout/``); its
own package and ``chip_smoke.py`` are imported, and its kernels built into
its own ``sparse_matrix_math_tpu_torch/build/``.  Measures

* the wrapper ``dia_spmv_padded`` on ``poisson_2d(1414)`` in float32 and on
  bfloat16 diagonals: the host's microseconds per call (2,000 calls
  back to back, the host slower than the kernel) and the wrapper's time as
  ``chip_smoke.median_ms`` takes it;
* plain float32 ``cg`` (b = A @ ones, epsilon 1e-4) on ``poisson_2d(1000)``
  (28 MB of layout, which the card's 50 MB L2 could hold between products)
  and ``poisson_2d(1200)`` (40 MB): iterations, wall and device
  microseconds per iteration, kernels per iteration, and K2's own device
  microseconds per launch inside the solve (torch.profiler), beside K2
  timed alone from a CUDA graph of 20 products (``chip_smoke.graph_ms``).

Prints the card's name and power limit and, last, one line ``K2RUN
{json}``.  Run it on the parent's checkout and this one in turns (parent,
change, change, parent).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time


def solve_profile(torch, solve) -> dict:
    """One solve under torch.profiler: device microseconds and kernels in
    all, and K2's own launches and device microseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = solve()
        float(res.residual_norm)
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]
    k2 = [ev for ev in events if "dia_padded_kernel" in ev.key or "dia_staged_kernel" in ev.key]
    return {"device_us": sum(ev.self_device_time_total for ev in events),
            "kernels": sum(ev.count for ev in events),
            "k2_launches": sum(ev.count for ev in k2),
            "k2_device_us": sum(ev.self_device_time_total for ev in k2)}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K

    if not smm.__file__.startswith(root):
        raise RuntimeError(f"imported {smm.__file__}, not the checkout at {root}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.library()
    dev = torch.device("cuda", 0)

    def variant(p):
        return K.variant(p, dev) if hasattr(K, "variant") else "rows"

    out = {"root": root, "device": smi, "wrapper": {}, "solves": {}}
    gen = torch.Generator(device=dev).manual_seed(3)
    dia = smm.dia_from_csr(smm.poisson_2d(1414, dtype=torch.float32, device=dev))
    p32 = K.pad_dia(dia)
    xp = p32.to_padded(torch.rand(dia.shape[0], generator=gen, device=dev) - 0.5)
    for name, p in (("float32", p32),
                    ("bfloat16", dataclasses.replace(p32, diags_p=p32.diags_p.to(torch.bfloat16)))):
        def call(p=p):
            return K.dia_spmv_padded(p, xp)

        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        host_us = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
        case = {"variant": variant(p), "host_us_per_call": host_us,
                "wrapper_ms": chip_smoke.median_ms(call), "graph_ms": chip_smoke.graph_ms(torch, call)}
        out["wrapper"][f"poisson_2d(1414) {name}"] = case
        print(f"wrapper poisson_2d(1414) {name}: {case}", flush=True)
    del dia, p32, xp

    for m in (1000, 1200):
        label = f"poisson_2d({m})"
        dia = smm.dia_from_csr(smm.poisson_2d(m, dtype=torch.float32, device=dev))
        p = K.pad_dia(dia)
        xp = p.to_padded(torch.rand(dia.shape[0], generator=gen, device=dev) - 0.5)
        k2_graph_ms = chip_smoke.graph_ms(torch, lambda: K.dia_spmv_padded(p, xp))
        b = dia @ torch.ones(dia.shape[0], dtype=torch.float32, device=dev)
        kw = dict(epsilon=1e-4, max_iterations=6000)
        smm.cg(dia, b, **kw)  # warm
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = smm.cg(dia, b, **kw)
            float(res.residual_norm)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        prof = solve_profile(torch, lambda: smm.cg(dia, b, **kw))
        its = max(res.iterations, 1)
        case = {"variant": variant(p), "n_total": p.n_total,
                "layout_mb": p.n_total * (len(p.offsets) * 4 + 8) / 1e6,
                "status": res.status_enum().name, "iterations": res.iterations,
                "us_per_iteration": [1e6 * w / its for w in walls],
                "device_us_per_iteration": prof["device_us"] / its,
                "kernels_per_iteration": prof["kernels"] / its,
                "k2_us_per_launch_in_solve": prof["k2_device_us"] / max(prof["k2_launches"], 1),
                "k2_launches": prof["k2_launches"], "k2_graph_ms": k2_graph_ms}
        out["solves"][label] = case
        print(f"cg {label} f32: {case}", flush=True)
        del dia, p, xp, b, res
        torch.cuda.empty_cache()
    print(smi)
    print("K2RUN", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
