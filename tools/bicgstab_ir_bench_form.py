#!/usr/bin/env python3
"""Where the JAX bench's nonsymmetric refinement ends, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/bicgstab_ir_bench_form.py 100 200 300

For each grid size n it solves ``convection_diffusion_2d(n)`` to 1e-8 with
``bicgstab_ir_df64`` and an f32 ``PaddedSGS(sweeps=4)`` inner preconditioner,
as the JAX package's bench does (bench.py:836-867), once with the bench's
right-hand side (the row sums: x = ones) and once with a seeded
standard-normal x_true, in the JAX package and in the PyTorch port, and
prints one line per solve: status, inner iterations, refinement rounds and
the final ||b - A x||.  Both packages run on the CPU (the port's kernels as
their plain versions), with the test suite's JAX settings (x64, CPU).
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import sparse_matrix_math_tpu as jsmm  # noqa: E402
import sparse_matrix_math_tpu_torch as smm  # noqa: E402
from sparse_matrix_math_tpu.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_math_tpu.ops.df32 import df_operator_from_host_csr  # noqa: E402
from sparse_matrix_math_tpu.precond import PaddedSGS as JaxPaddedSGS  # noqa: E402
from sparse_matrix_math_tpu.utils.generate import convection_diffusion_2d  # noqa: E402
from sparse_matrix_math_tpu_torch.precond import PaddedSGS  # noqa: E402


def main(sizes) -> None:
    for n in sizes:
        a = convection_diffusion_2d(n, dtype=np.float64)
        data, indices, indptr = (np.asarray(a.data), np.asarray(a.indices, np.int64),
                                 np.asarray(a.indptr, np.int64))
        x_true = np.random.default_rng(0).standard_normal(a.shape[0])
        jax_op = df_operator_from_host_csr(data, indices, indptr, a.shape)
        jax_pre = JaxPaddedSGS.from_dia(try_dia_from_csr(convection_diffusion_2d(
            n, dtype=np.float32)), sweeps=4)
        port_op = smm.df_operator_from_host_csr(data, indices, indptr, a.shape, device="cpu")
        port_pre = PaddedSGS.from_dia(smm.dia_from_csr(smm.convection_diffusion_2d(
            n, dtype=torch.float32, device="cpu")), sweeps=4)
        for form, b in (("rowsums", np.add.reduceat(data, indptr[:-1])),
                        ("x_true", np.add.reduceat(data * x_true[indices], indptr[:-1]))):
            for package, solver, op, pre in (("jax", jsmm.bicgstab_ir_df64, jax_op, jax_pre),
                                             ("port", smm.bicgstab_ir_df64, port_op, port_pre)):
                t0 = time.perf_counter()
                res = solver(op, b, max_iterations=30000, epsilon=1e-8, preconditioner=pre)
                x = res.x_f64()
                true = np.linalg.norm(b - np.add.reduceat(data * x[indices], indptr[:-1]))
                print(f"n={n} b={form} {package}: {res.status_enum().name} "
                      f"inner={int(res.iterations)} rounds={int(res.outer_rounds)} "
                      f"||b-Ax||={true:.3e} ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main([int(v) for v in sys.argv[1:]] or [100, 200, 300])
