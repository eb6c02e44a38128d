"""The benchmark's inputs, made on the device from the configuration and the seed.

The operator is built by the module under ``operators/`` that the
configuration names (:func:`operator_csr`; one rank's rows of it,
:func:`operator_rows`).  The right-hand sides are the members of one set,
``b_m = A x_m`` with ``x_m = 1 + p U(-1, 1)`` (HPCG's exact solution of
ones, perturbed so that no two solves are alike), each drawn by a device
generator seeded from ``m`` alone.  The seed orders the set
(:func:`rhs_order`) and does not redraw it: the port's solvers stop within
a few iterations of convergence by a rule that reads the residual's history,
so the iterations a solve executes depend on its b, and a set drawn anew
for every seed would give every seed another amount of work.
"""

from __future__ import annotations

import random

import torch

from solvebench import reference

# 2**64 / golden ratio: spreads the members over the generator's seed space
_MIX = 0x9E3779B97F4A7C15


def rhs_seed(m: int) -> int:
    """The generator seed of member ``m`` of the set of right-hand sides."""
    return (int(m) + 1) * _MIX % (1 << 63)


def rhs_order(seed: int, count: int) -> list:
    """The order in which a run seeded ``seed`` takes the ``count`` members
    of the set: entry ``i`` is the member that is its ``i``-th right-hand side."""
    order = list(range(count))
    random.Random(seed).shuffle(order)
    return order


def operator_csr(cfg: dict, device, dtype, csr_type):
    """The configuration's operator as a ``csr_type`` (the port's CSRMatrix)
    built on ``device`` in ``dtype``."""
    return reference.operator(cfg).csr(cfg, device, dtype, csr_type)


def operator_rows(cfg: dict, lo: int, hi: int, device, dtype, csr_type):
    """Rows ``[lo, hi)`` of the configuration's operator, with their global
    columns, as a ``csr_type`` of shape ``(hi - lo, n)``."""
    return reference.operator(cfg).csr_rows(cfg, lo, hi, device, dtype, csr_type)


def rhs(cfg: dict, m: int, perturbation: float, device, dtype):
    """Member ``m`` of the set: ``b_m = A x_m`` in ``dtype`` (A applied in
    float64 by the plain reference, then rounded)."""
    n = reference.operator(cfg).rows(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(rhs_seed(m))
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    x = 1.0 + perturbation * (2.0 * u - 1.0)
    return reference.apply(cfg, x).to(dtype)


def rhs_pool(cfg: dict, seed: int, count: int, perturbation: float, device, dtype,
             rows=None):
    """The ``count`` members of the set (:func:`rhs`), in the seed's order
    (:func:`rhs_order`), and their float64 norms.  With ``rows``,
    ``(lo, hi)``, each is cut to those rows after it is made whole, so the
    blocks of any split, concatenated, are the whole pool bit for bit; the
    norms stay those of the whole vectors."""
    pool, norms = [], []
    for m in rhs_order(seed, count):
        b = rhs(cfg, m, perturbation, device, dtype)
        norms.append(torch.linalg.vector_norm(b.to(torch.float64)))
        pool.append(b if rows is None else b[rows[0]:rows[1]].clone())
    return pool, torch.stack(norms).tolist()
