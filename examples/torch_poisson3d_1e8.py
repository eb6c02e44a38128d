"""Example: the reference's f64/1e-8 contract at scale, in one call, with the
PyTorch port (twin of ``poisson3d_1e8.py``).

A matrix-free 3-D Poisson stencil, the geometric multigrid V-cycle, and the
double-word refinement, all wired through the ``solve()`` front door:

    solve(stencil, b, method="cg", epsilon=1e-8,
          preconditioner="multigrid")

    python examples/torch_poisson3d_1e8.py [m] [--cpu]    # grid side, default 31
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.utils.generate import poisson_3d


def main(m: int = 31, device: str = None) -> None:
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    # host f64 oracle (for the independent residual check + exact b)
    a64 = poisson_3d(m, dtype=torch.float64, device="cpu")
    data = a64.data.numpy()
    indptr = a64.indptr.numpy()
    indices = a64.indices.numpy()
    b64 = np.add.reduceat(data, indptr[:-1])  # row sums -> x_true = ones

    # the matrix-free operator: 7 coefficients + the grid shape
    st = smm.GridStencilMatrix(
        coeffs=torch.tensor([6.0, -1, -1, -1, -1, -1, -1], dtype=torch.float32,
                            device=device),
        doffs=((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0),
               (0, 1, 0), (0, 0, -1), (0, 0, 1)),
        dims=(m, m, m), shape=a64.shape, nnz=int(a64.nnz),
    )

    res = smm.solve(
        st, torch.from_numpy(b64).to(device), method="cg", epsilon=1e-8,
        preconditioner="multigrid",
    )
    # A float32 request below its floor comes back as a DfSolveResult from
    # the double-word refinement; a float64 solve that meets the bar comes
    # back as a SolveResult.  Both satisfy the same contract.
    escalated = hasattr(res, "x_f64")
    x64 = res.x_f64() if escalated else res.x.cpu().numpy().astype(np.float64)
    true = float(np.linalg.norm(
        b64 - np.add.reduceat(data * x64[indices], indptr[:-1])
    ))
    rounds = (
        f", refinement rounds {int(res.outer_rounds)}" if escalated else ""
    )
    print(
        f"{m}^3 Poisson ({a64.nnz} nnz): {res.status_enum().name}, "
        f"iterations {int(res.iterations)}{rounds}, "
        f"f64 true residual {true:.2e} (target 1e-8), "
        f"max|x - 1| = {np.abs(x64 - 1.0).max():.2e}"
    )


if __name__ == "__main__":
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    main(int(args[0]) if args else 31)
