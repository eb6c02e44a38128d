"""Example: f64-grade solves from float32 pairs with the PyTorch port (twin of
``df64_solve.py``).

* ``load_matrix_df`` / ``df_operator_from_host_csr`` — the operator's
  float64 values split exactly into (hi, lo) f32 planes (a DfDiaMatrix for
  stencils — its product is the double-word DIA kernel on a card — or a
  DfEllMatrix otherwise);
* ``cg_df64`` — the whole CG recurrence (SpMV, dots, scalar updates) in
  double-word f32 arithmetic (~2^-47 per op);
* the result recombines to host float64 via ``DfSolveResult.x_f64()``.

    python examples/torch_df64_solve.py [nx] [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

import sparse_matrix_math_tpu_torch as smm
from sparse_matrix_math_tpu_torch.utils.generate import poisson_2d


def main(nx: int = None, device: str = None) -> None:
    args = [s for s in sys.argv[1:] if s != "--cpu"]
    if nx is None:
        nx = int(args[0]) if args else 128
    device = device or ("cpu" if "--cpu" in sys.argv else "cuda")
    a = poisson_2d(nx, dtype=torch.float64, device="cpu")
    n = a.shape[0]

    # host-side f64 CSR arrays: what load_matrix_df produces from .mtx
    data = a.data.numpy()
    indices = a.indices.numpy()
    indptr = a.indptr.numpy()

    # exact double-word operator (DIA auto-selected for the stencil)
    dfa = smm.df_operator_from_host_csr(data, indices, indptr, a.shape, device=device)
    print(f"operator: {type(dfa).__name__}  n={n}  nnz={dfa.nnz}")

    # manufactured solution in full f64
    x_true = np.random.default_rng(0).standard_normal(n)
    b = np.add.reduceat(data * x_true[indices], indptr[:-1])

    # eps=1e-10 — far past plain f32's representable resolution
    res = smm.cg_df64(dfa, b, epsilon=1e-10)
    x = res.x_f64()
    true_res = np.linalg.norm(b - np.add.reduceat(data * x[indices], indptr[:-1]))
    print(
        f"cg_df64: status={res.status_enum().name} "
        f"iterations={int(res.iterations)}"
    )
    print(f"true residual (host f64): {true_res:.3e}")
    print(f"x error vs manufactured:  "
          f"{np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}")

    # the fast path to the same bar: f32 inner CG + double-word
    # true-residual refinement, multigrid-preconditioned inner solves
    from sparse_matrix_math_tpu_torch.solvers.multigrid import PoissonMultigrid

    mg = PoissonMultigrid.for_grid(nx, device=device)
    ir = smm.cg_ir_df64(dfa, b, epsilon=1e-10, preconditioner=mg)
    xi = ir.x_f64()
    ir_res = np.linalg.norm(
        b - np.add.reduceat(data * xi[indices], indptr[:-1])
    )
    print(
        f"cg_ir_df64 (+mg inner): status={ir.status_enum().name} "
        f"inner={int(ir.iterations)} outer={int(ir.outer_rounds)} "
        f"true residual {ir_res:.3e}"
    )

    # the same solve in plain f32 floors orders of magnitude higher
    a32 = poisson_2d(nx, dtype=torch.float32, device=device)
    r32 = smm.cg(a32, torch.from_numpy(b.astype(np.float32)).to(device), epsilon=1e-10)
    x32 = r32.x.cpu().numpy().astype(np.float64)
    f32_res = np.linalg.norm(
        b - np.add.reduceat(data * x32[indices], indptr[:-1])
    )
    print(
        f"plain f32 cg for comparison: status={r32.status_enum().name} "
        f"true residual {f32_res:.3e}"
    )


if __name__ == "__main__":
    main()
