"""Example: unstructured and multi-RHS solves through the front-end, with
the PyTorch port (twin of ``unstructured_solve.py``).

* ``auto_format=True`` — best_format picks the layout (DIA for stencils,
  W-SELL for general patterns, RCM+W-SELL for scattered numberings, R-SELL
  for zero-locality patterns);
* multi-RHS panels — ``solve(a, B)`` with B of shape (n, m) runs one
  batched (optionally preconditioned) CG: one SpMM per iteration feeds
  every column;
* nonsymmetric systems — BiCGStab/CGS/GMRES run over any layout.

    python examples/torch_unstructured_solve.py [n] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.utils.generate import (
    convection_diffusion_2d,
    laplace_3d_jittered,
)


def main(n: int = 40, device: str = None) -> None:
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    # -- general (banded-broken) SPD pattern, auto-selected layout -----
    a = laplace_3d_jittered(n, symmetric=True, shift=0.25, dtype=torch.float32, device=device)
    b = a @ torch.ones(a.shape[0], dtype=torch.float32, device=device)
    res = smm.solve(a, b, method="cg", epsilon=1e-4, auto_format=True)
    print(f"auto-format CG: status={int(res.status)} "
          f"iters={int(res.iterations)} "
          f"max|x-1|={float((res.x - 1.0).abs().max()):.2e}")

    # -- multi-RHS panel: one preconditioned batched CG ----------------
    rng = np.random.default_rng(0)
    a2 = convection_diffusion_2d(n, cx=0.0, cy=0.0, dtype=torch.float64, device=device)
    B = torch.from_numpy(rng.standard_normal((a2.shape[0], 4))).to(device)
    multi = smm.solve(a2, B, method="cg", preconditioner="sgs",
                      epsilon=1e-10)
    print(f"multi-RHS PCG+SGS: statuses={[int(s) for s in multi.status]} "
          f"iters={[int(i) for i in multi.iterations]}")

    # -- nonsymmetric system (upwind convection-diffusion) -------------
    a3 = convection_diffusion_2d(n, cx=0.8, cy=0.3, dtype=torch.float64, device=device)
    b3 = a3 @ torch.ones(a3.shape[0], dtype=torch.float64, device=device)
    res3 = smm.solve(a3, b3, method="bicgstab", preconditioner="sgs",
                     epsilon=1e-10, auto_format=True)
    print(f"nonsymmetric BiCGStab+SGS: status={int(res3.status)} "
          f"iters={int(res3.iterations)} "
          f"max|x-1|={float((res3.x - 1.0).abs().max()):.2e}")

    # -- the minimal-residual alternative: restarted GMRES + ILU(0) ----
    res4 = smm.solve(a3, b3, method="gmres", preconditioner="ilu0",
                     epsilon=1e-10)
    print(f"nonsymmetric GMRES+ILU0: status={int(res4.status)} "
          f"iters={int(res4.iterations)}")


if __name__ == "__main__":
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    main(int(args[0]) if args else 40)
