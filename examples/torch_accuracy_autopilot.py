"""Example: precision floors and automatic accuracy escalation with the
PyTorch port (twin of ``accuracy_autopilot.py``).

A single-precision Krylov solve cannot push its TRUE residual below
~u_f32 * ||A|| * ||x|| no matter how many iterations it runs:

* every verified-convergence solver reports ``floor_hit`` on its
  SolveResult — a MAX_ITERATIONS_REACHED exit that was a measured precision
  floor, so raising ``max_iterations`` cannot help;
* the :func:`~sparse_matrix_math_tpu_torch.solve` front door reads it (plus
  an epsilon-vs-f32-representability pre-check) and re-routes the request
  through the double-word refinement (``cg_ir_df64`` /
  ``bicgstab_ir_df64``).  Opt out with ``auto_escalate=False``.

    python examples/torch_accuracy_autopilot.py [nx] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.utils.generate import poisson_2d


def main(nx: int = 64, device: str = None) -> None:
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    a64 = poisson_2d(nx, dtype=torch.float64, device="cpu")
    data = a64.data.numpy()
    indptr = a64.indptr.numpy()
    indices = a64.indices.numpy()
    b64 = np.add.reduceat(data, indptr[:-1])  # row sums -> x = ones

    a32 = poisson_2d(nx, dtype=torch.float32, device=device)
    b32 = torch.from_numpy(b64.astype(np.float32)).to(device)

    # 1. an f32 solve asked for more than f32 can deliver, escalation off:
    #    it stops honestly at its floor and SAYS it was a floor
    res = smm.solve(a32, b32, method="cg", epsilon=1e-8,
                    auto_escalate=False)
    print(f"f32 pass: {res.status_enum().name}, "
          f"||b-Ax|| = {float(res.residual_norm):.2e}, "
          f"floor_hit = {res.hit_precision_floor}")

    # 2. the same request through the front door: routed to the
    #    double-word refinement, genuine 1e-8 true residual
    res = smm.solve(a32, b32, method="cg", epsilon=1e-8)
    x = res.x_f64()
    data32 = a32.data.cpu().numpy().astype(np.float64)  # the operator as handed in
    ax = np.add.reduceat(data32 * x[indices], indptr[:-1])
    true = float(np.linalg.norm(b32.cpu().numpy().astype(np.float64) - ax))
    print(f"escalated: {type(res).__name__} {res.status_enum().name}, "
          f"true ||b-Ax|| = {true:.2e}, "
          f"max|x-1| = {float(np.abs(x - 1).max()):.2e}")


if __name__ == "__main__":
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    main(int(args[0]) if args else 64)
