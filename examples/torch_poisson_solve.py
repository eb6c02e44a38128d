"""Example: solve a 2-D Poisson system end-to-end on one CUDA card, with the
PyTorch port (twin of ``poisson_solve.py``).

    python examples/torch_poisson_solve.py [nx] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.formats.dia import dia_from_csr
from sparse_matrix_math_tpu_torch.utils.generate import poisson_2d
from sparse_matrix_math_tpu_torch.utils.profiling import solve_with_stats


def main(nx: int = 256, device: str = None) -> None:
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    a_csr = poisson_2d(nx, dtype=torch.float32, device=device)
    a = dia_from_csr(a_csr)  # stencil layout -> the DIA kernel on a card
    x_true = torch.ones(a.shape[0], dtype=torch.float32, device=device)
    b = a @ x_true

    stats = solve_with_stats(
        smm.cg, a, b, solver_name="cg", epsilon=1e-5, record_residuals=True
    )
    print(stats)
    print("max |x - 1| =", float((smm.cg(a, b, epsilon=1e-5).x - 1.0).abs().max()))

    # preconditioned variant through the unified front-end (CSR input)
    res = smm.solve(a_csr, b, method="cg", preconditioner="ic0", epsilon=1e-5)
    print("PCG+IC0:", res)


if __name__ == "__main__":
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    main(int(args[0]) if args else 256)
