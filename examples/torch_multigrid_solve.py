"""Geometric-multigrid-preconditioned CG with the PyTorch port (twin of
``multigrid_solve.py``; solvers/multigrid.py).

    python examples/torch_multigrid_solve.py [nx] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.solvers.multigrid import PoissonMultigrid
from sparse_matrix_math_tpu_torch.utils.generate import poisson_2d


def main(device: str = None):
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    nx = int(args[0]) if args else 256
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    a = poisson_2d(nx, dtype=torch.float32, device=device)
    b = a @ torch.ones(a.shape[0], dtype=torch.float32, device=device)  # all-ones oracle

    mg = PoissonMultigrid.for_grid(nx, device=device)
    res = smm.cg(a, b, epsilon=1e-4, preconditioner=mg)
    print(
        f"n={a.shape[0]}: PCG+V-cycle {int(res.iterations)} iterations, "
        f"status={int(res.status)}, max|x-1|={float((res.x - 1).abs().max()):.2e}"
    )

    plain = smm.cg(a, b, epsilon=1e-4)
    print(f"plain CG for comparison: {int(plain.iterations)} iterations")


if __name__ == "__main__":
    main()
