"""Example: a distributed solve over a row mesh of processes, with the PyTorch
port (twin of ``distributed_solve.py``).

    python -m torch.distributed.run --nproc_per_node=N examples/torch_distributed_solve.py
    python examples/torch_distributed_solve.py --cpu N

The first runs one process per CUDA card over NCCL; ``--cpu N`` starts N
gloo ranks on the CPU.  Rank 0 prints the result.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.parallel import (
    collect,
    dist_solve,
    distribute_csr,
    distribute_preconditioner,
    init_distributed,
    spawn_cpu_world,
)
from sparse_matrix_math_tpu_torch.utils.generate import poisson_2d


def run(mesh) -> list:
    """Every rank's part of the solve; returns the lines to print."""
    # the same global matrix on every rank; float32, as the JAX package's
    # example runs (JAX's default, without x64)
    a = poisson_2d(64, dtype=torch.float32, device="cpu")
    da = distribute_csr(a, mesh)  # halo mode auto-detected
    b = a.to_dense().sum(dim=1).numpy()

    # explicit small sweep count: the standard approximate triangular
    # solve (sweeps="exact" would cost depth~127 SpMVs per apply here); eps
    # sits above the f32 true-residual floor (~1e-6 at this n)
    pre = distribute_preconditioner(
        smm.get_preconditioner(a, "sgs", method="jacobi", sweeps=4), da)
    res = dist_solve(da, b, solver="bicgstab", preconditioner=pre, epsilon=1e-5)
    x = collect(res.x, da)
    return [f"mesh: {mesh}", f"exchange mode: {da.mode}",
            f"{res} | max|x-1| = {float(np.abs(x - 1).max())}"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, help="run N gloo ranks on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        lines = spawn_cpu_world(run, args.cpu)[0]
    else:
        mesh = init_distributed()
        try:
            lines = run(mesh)
            if mesh.rank != 0:
                lines = []
        finally:
            torch.distributed.destroy_process_group()
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
