#!/usr/bin/env python3
"""Probe the distributed layer's costs at world size 1 over NCCL on one CUDA card.

    python3 tools/dist_probe.py [nx]

On ``poisson_2d(nx)`` (default 1414, the bench system) in float32:

* the host's microseconds per call of the layer's pieces, each called 1000
  times back to back with no sync inside (median and least of 5 samples):
  ``torch.dot``, ``torch.dot`` plus the ``all_reduce`` that ``dist_solve``
  puts after it, ``halo_exchange`` at world size 1, and one shard product of
  ``dist_solve`` (CSR, halo mode), ``dist_dia_solve`` and
  ``dist_stencil_solve`` beside the single-device DIA product (K1, the
  ``rmult`` of a ``DIAMatrix``) and the CSR product;
* the same products' device time per call from CUDA events (20 calls, median
  of 5);
* the CSR shard product's row sum four ways, on its own shard arrays: by
  ``index_add_`` (atomics on a card), by ``torch.segment_reduce`` over the
  vector, over a column with its checked lengths (it syncs with the host),
  and by ``ops/spmv.py``'s ``row_sum`` (over a column, the offsets unchecked):
  device time per call, and whether 8 runs give the same bits;
* CG's wall per iteration (512 iterations, median and least of 3 timed runs
  after a warm one) over the distributed CSR product and over K1, each with
  ``dist_solve``'s dot (``torch.dot``, then the ``all_reduce``) and with the
  plain ``torch.dot``: the all-reduce's part of the wall;
* how far rounding alone moves BiCGStab + SGS(4) in float64 (b = A·ones, eps
  1e-8): the single-device padded solve (K2, K4) and the generic one (the
  CSR with ``SMM_NO_AUTOROUTE=1``: index products, triangular sweeps), each on
  b and on three copies of b with every entry scaled by ``1 + 1e-15 g``
  (g standard normal, seeds 1-3; the generic one on b twice first), beside
  ``dist_solve`` on b twice (both repeat themselves) and on the first copy.

Prints the card's name and power limit, and one JSON line last.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def host_us(torch, fn, calls: int = 1000, samples: int = 5):
    """Median and least host µs per call of ``fn`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append(1e6 * (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return statistics.median(per), min(per)


def device_ms(torch, fn, calls: int = 20, samples: int = 5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch import parallel as par
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.parallel import dist as D
    from sparse_matrix_math_tpu_torch.ops import spmv as SP
    from sparse_matrix_math_tpu_torch.parallel import dist_dia as DD
    from sparse_matrix_math_tpu_torch.parallel import dist_stencil as DS
    from sparse_matrix_math_tpu_torch.parallel import mesh as M
    from sparse_matrix_math_tpu_torch.solvers.cg import cg_core

    nx = int(sys.argv[1]) if len(sys.argv) > 1 else 1414
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    _build.library()
    dev = torch.device("cuda", 0)
    store = tempfile.mkdtemp(prefix="smm_probe_")
    mesh = par.init_distributed(f"file://{store}/store", 1, 0, device=dev)
    out = {"card": smi, "nx": nx}
    try:
        p32 = smm.poisson_2d(nx, dtype=torch.float32, device=dev)
        dia = smm.dia_from_csr(p32)
        d = par.distribute_csr(p32, mesh)
        dd = par.distribute_dia(dia, mesh)
        ds = par.distribute_stencil(smm.try_grid_stencil_from_csr(p32), mesh)
        x = torch.rand(d.block_rows, device=dev)
        u = torch.rand(d.block_rows, device=dev)
        xn = x[: p32.shape[0]].contiguous()
        products = {
            "dist_solve CSR (halo)": D._matvec(d, mesh),
            "dist_dia_solve": lambda v: DD._local_dia_spmv(dd.diags, v, offsets=dd.offsets,
                                                           mesh=mesh, block_rows=dd.block_rows),
            "dist_stencil_solve": DS._matvec(ds, mesh),
        }
        host = {
            "torch.dot": host_us(torch, lambda: torch.dot(x, u)),
            "torch.dot + all_reduce": host_us(torch, lambda: M.all_reduce(torch.dot(x, u), mesh)),
            "halo_exchange (world size 1)": host_us(torch, lambda: M.halo_exchange(x, mesh)),
            "single-device DIA rmult (K1)": host_us(torch, lambda: dia @ xn, calls=200),
            "single-device CSR rmult": host_us(torch, lambda: p32 @ xn, calls=200),
        }
        dev_ms = {"single-device DIA rmult (K1)": device_ms(torch, lambda: dia @ xn),
                  "single-device CSR rmult": device_ms(torch, lambda: p32 @ xn)}
        for name, mv in products.items():
            host[name] = host_us(torch, lambda: mv(x), calls=200)
            dev_ms[name] = device_ms(torch, lambda: mv(x))
        vals = d.data * x.index_select(0, d.cols)
        lengths = d.row_ptr.diff()
        rows = torch.repeat_interleave(torch.arange(d.block_rows, device=dev), lengths)
        sums = {
            "index_add_": lambda: torch.zeros(d.block_rows, device=dev).index_add_(0, rows, vals),
            "segment_reduce, vector": lambda: torch.segment_reduce(
                vals, "sum", offsets=d.row_ptr, unsafe=True),
            "segment_reduce, column, checked lengths": lambda: torch.segment_reduce(
                vals[:, None], "sum", lengths=lengths)[:, 0],
            "segment_reduce, column (row_sum)": lambda: SP.row_sum(vals, d.row_ptr),
        }
        row_sum = {}
        for name, fn in sums.items():
            first = fn()
            row_sum[name] = {"device_ms": device_ms(torch, fn),
                             "same_bits_8_runs": all(torch.equal(first, fn()) for _ in range(7))}
            print(f"CSR shard row sum ({vals.numel():,} products, {d.block_rows:,} rows), "
                  f"{name}: {row_sum[name]['device_ms']:.4f} ms, the same bits in 8 runs "
                  f"{row_sum[name]['same_bits_8_runs']}")
        out["row_sum"] = row_sum
        out["host_us_per_call"] = host
        out["device_ms_per_call"] = dev_ms
        for k, v in host.items():
            print(f"host µs per call {k}: median {v[0]:.2f}, least {v[1]:.2f}"
                  + (f"; device {dev_ms[k]:.4f} ms" if k in dev_ms else ""))

        # the all-reduce's share of a CG iteration's wall: CG's core over the
        # distributed CSR product and over K1, each with dist_solve's dot (a
        # local dot, then the all-reduce) and with the plain local dot
        bn = p32 @ torch.ones(p32.shape[0], device=dev)
        bd = torch.zeros(d.block_rows, device=dev)
        bd[: p32.shape[0]] = bn
        cases = {"dist CSR product": (products["dist_solve CSR (halo)"], bd),
                 "K1 DIA product": (lambda v: dia @ v, bn)}
        walls = {}
        for pname, (mv, bb) in cases.items():
            for dname, dotfn in (("all_reduce dot", D._psum_dot(mesh)), ("plain dot", torch.dot)):
                def solve():
                    return cg_core(mv, dotfn, bb, torch.zeros_like(bb), 0.0, 512, False)
                solve()
                per = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    float(solve().residual_norm)
                    per.append(1e6 * (time.perf_counter() - t0) / 512)
                walls[f"{pname}, {dname}"] = (statistics.median(per), min(per))
        out["cg_wall_us_per_iteration"] = walls
        for k, v in walls.items():
            print(f"CG wall µs per iteration, {k}: median {v[0]:.1f}, least {v[1]:.1f}")
        del p32, dia, d, dd, ds, x, u, xn, products, cases, bd, bn

        p64 = smm.poisson_2d(nx, dtype=torch.float64, device=dev)
        b = p64 @ torch.ones(p64.shape[0], dtype=torch.float64, device=dev)
        sgs = smm.SGSPreconditioner.from_matrix(p64, method="jacobi", sweeps=4,
                                                strict_layout="csr")
        d64 = par.distribute_csr(p64, mesh)
        dsgs = par.distribute_preconditioner(sgs, d64)
        kw = dict(epsilon=1e-8, max_iterations=20000)
        rhs = [b] + [b * (1 + 1e-15 * torch.as_tensor(
            np.random.default_rng(s).standard_normal(b.shape[0]), device=dev)) for s in (1, 2, 3)]

        def runs(solve, bs):
            got = []
            for bb in bs:
                r = solve(bb)
                got.append((r.status_enum().name, r.iterations))
            return got

        spread = {"padded": runs(lambda bb: smm.bicgstab(p64, bb, preconditioner=sgs, **kw), rhs)}
        os.environ["SMM_NO_AUTOROUTE"] = "1"
        try:
            spread["generic"] = runs(lambda bb: smm.bicgstab(p64, bb, preconditioner=sgs, **kw),
                                     [b] + rhs)
        finally:
            del os.environ["SMM_NO_AUTOROUTE"]
        spread["dist_solve"] = runs(lambda bb: par.dist_solve(
            d64, bb, solver="bicgstab", preconditioner=dsgs, **kw), [b, b, rhs[1]])
        out["bicgstab_sgs4_f64"] = spread
        for k, v in spread.items():
            print(f"BiCGStab + SGS(4) f64 poisson_2d({nx}), {k}: {v}")
    finally:
        torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
