"""The benchmark's inputs, made on the device from the configuration and the seed.

The operator is built by the module under ``operators/`` that the
configuration names (:func:`operator_csr`).  The right-hand sides are
``b_k = A x_k`` with ``x_k = 1 + p U(-1, 1)`` (HPCG's exact solution of
ones, perturbed so that no two solves are alike), each drawn by a device
generator seeded from ``(seed, k)``.
"""

from __future__ import annotations

import torch

from solvebench import reference

# 2**64 / golden ratio: spreads (seed, k) over the generator's seed space
_MIX = 0x9E3779B97F4A7C15


def rhs_seed(seed: int, k: int) -> int:
    """The generator seed of right-hand side ``k`` of a run seeded ``seed``."""
    return (int(seed) * _MIX + 2 * int(k) + 1) % (1 << 63)


def operator_csr(cfg: dict, device, dtype, csr_type):
    """The configuration's operator as a ``csr_type`` (the port's CSRMatrix)
    built on ``device`` in ``dtype``."""
    return reference.operator(cfg).csr(cfg, device, dtype, csr_type)


def rhs_pool(cfg: dict, seed: int, count: int, perturbation: float, device, dtype):
    """``count`` right-hand sides ``b_k = A x_k`` in ``dtype`` (A applied in
    float64 by the plain reference, then rounded), and their float64 norms."""
    n = reference.operator(cfg).rows(cfg)
    pool, norms = [], []
    for k in range(count):
        gen = torch.Generator(device=device)
        gen.manual_seed(rhs_seed(seed, k))
        u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
        x = 1.0 + perturbation * (2.0 * u - 1.0)
        b = reference.apply(cfg, x).to(dtype)
        pool.append(b)
        norms.append(torch.linalg.vector_norm(b.to(torch.float64)))
    return pool, torch.stack(norms).tolist()
