"""Command-line interface.

Port of ``sparse_matrix_math_tpu/__main__.py``: the same subcommands,
arguments, JSON keys and exit codes, plus ``--device`` (default ``cuda``),
the device the matrix is loaded onto and solved on.  Examples:

    python -m sparse_matrix_math_tpu_torch solve matrix.mtx --method cg --tol 1e-8
    python -m sparse_matrix_math_tpu_torch solve matrix.mtx --method bicgstab \\
        --preconditioner sgs --rhs ones --output x.npy
    python -m sparse_matrix_math_tpu_torch info matrix.mtx
    python -m sparse_matrix_math_tpu_torch --device cpu bench-spmv matrix.mtx
"""

from __future__ import annotations

import argparse
import json
import sys


def _load(args):
    import torch

    from .io.dispatch import load_matrix_csr

    dtype = {"f32": torch.float32, "f64": torch.float64}[args.dtype]
    return load_matrix_csr(args.matrix, dtype=dtype, device=args.device)


def cmd_info(args) -> int:
    a = _load(args)
    row_nnz = a.indptr.diff().cpu().numpy()
    offs = a.indices - a.row_ids
    print(json.dumps({
        "shape": list(a.shape),
        "nnz": a.nnz,
        "dtype": str(a.dtype).removeprefix("torch."),
        "row_nnz": {"min": int(row_nnz.min()), "max": int(row_nnz.max()),
                    "mean": float(row_nnz.mean())},
        "distinct_diagonals": int(offs.unique().numel()),
        "bandwidth": int(offs.abs().max()) if offs.numel() else 0,
        "symmetric_pattern": _pattern_symmetric(a),
    }))
    return 0


def _pattern_symmetric(a) -> bool:
    """Whether (c, r) is stored for every stored (r, c): each transposed
    key r + c * m (m = max(shape)) among the stored keys r * m + c, on the
    matrix's device (the JAX package's set comparison, vectorised)."""
    import torch

    m = max(a.shape)
    fwd = a.row_ids * m + a.indices
    bwd = a.indices * m + a.row_ids
    return bool(torch.isin(bwd, fwd).all())


def cmd_solve(args) -> int:
    import numpy as np
    import torch

    from . import solve
    from .solvers.types import SolverStatus

    a = _load(args)
    if args.rhs == "ones":
        b = a @ torch.ones(a.shape[0], dtype=a.dtype, device=a.device)
    else:
        b = torch.from_numpy(np.load(args.rhs)).to(a.device)

    res = solve(
        a, b,
        method=args.method,
        epsilon=args.tol,
        max_iterations=args.max_iterations,
        preconditioner=args.preconditioner,
    )
    out = {
        "status": SolverStatus(int(res.status)).name,
        "iterations": int(res.iterations),
        "residual_norm": float(res.residual_norm),
    }
    if args.output:
        np.save(args.output, res.x.cpu().numpy())
        out["output"] = args.output
    print(json.dumps(out))
    return 0 if int(res.status) == SolverStatus.SUCCESS else 1


def cmd_bench_spmv(args) -> int:
    from .formats.dia import try_dia_from_csr
    from .formats.ell import ell_from_csr
    from .utils.profiling import spmv_throughput

    a = _load(args)
    report = {"csr": spmv_throughput(a, iters=args.iters)}
    dia = try_dia_from_csr(a)
    if dia is not None:
        report["dia"] = spmv_throughput(dia, iters=args.iters)
    report["ell"] = spmv_throughput(ell_from_csr(a), iters=args.iters)
    try:
        from .formats.wsell import wsell_from_csr

        report["wsell"] = spmv_throughput(
            wsell_from_csr(a), iters=args.iters
        )
    except ValueError:
        report["wsell"] = None  # pattern pads beyond the W-SELL cap
    if args.routed:
        from .formats.rsell import try_routed_from_csr

        rmat = try_routed_from_csr(a)
        # None: the chain would pad beyond the R-SELL cap
        report["rsell"] = (
            spmv_throughput(rmat, iters=args.iters)
            if rmat is not None else None
        )
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sparse_matrix_math_tpu_torch")
    p.add_argument("--dtype", choices=["f32", "f64"], default="f64")
    p.add_argument("--device", default="cuda",
                   help="torch device to load and solve on (default: cuda)")
    sub = p.add_subparsers(dest="command", required=True)

    pi = sub.add_parser("info", help="matrix statistics")
    pi.add_argument("matrix")
    pi.set_defaults(fn=cmd_info)

    ps = sub.add_parser("solve", help="solve A x = b")
    ps.add_argument("matrix")
    ps.add_argument("--method", default="cg",
                    choices=["cg", "bicg_symmetric", "cgs", "bicgstab",
                             "gmres"])
    ps.add_argument("--preconditioner", default="none",
                    choices=["none", "jacobi", "sgs", "ilu0", "ic0",
                             "chebyshev", "multigrid"])
    ps.add_argument("--tol", type=float, default=1e-8)
    ps.add_argument("--max-iterations", type=int, default=-1)
    ps.add_argument("--rhs", default="ones",
                    help="'ones' (row-sum oracle) or a .npy path")
    ps.add_argument("--output", default=None, help=".npy path for x")
    ps.set_defaults(fn=cmd_solve)

    pb = sub.add_parser("bench-spmv", help="SpMV throughput per format")
    pb.add_argument("matrix")
    pb.add_argument("--iters", type=int, default=20)
    pb.add_argument("--routed", action="store_true",
                    help="also time the routed (R-SELL) chain — its "
                         "build is minutes at 10M+ nnz, so it is opt-in")
    pb.set_defaults(fn=cmd_bench_spmv)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
