"""One rank of a multi-rank cell, as ``run.launch`` starts it, over the
port's distributed CSR path, with a fault to plant: test code.

    python3 solvebench/tests/ranks.py --cell <cell.json> [--fault <fault>]
        [--control] [--backend gloo|nccl]
        --workload <name> --seed <n> --seconds <s> --trace <0|1>

``cell.json`` holds ``{"workload": ..., "config": ..., "manifest": ...}``.
The workload names its layout ``parallel.gathered_layout``, which this
process sets on the port's ``parallel`` module: :func:`gathered_layout`
all-gathers the ranks' rows into the whole CSR and calls
``parallel.distribute_csr`` (the port has no layout of a rank's own rows
yet).  Its call is the port's ``parallel.dist_solve``.  A fault is planted
on the last rank alone (:data:`FAULTS`).
"""

import argparse
import dataclasses
import json
import sys
import threading
import time
import types
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

FAULTS = {
    "perturbed": "each solution's block has one entry moved by 1e-3",
    "status": "each solve reports MAX_ITERATIONS_REACHED, its solution sound",
    "raises": "the second solve raises",
    "hangs": "the second solve never returns",
    "jax": "a module named jax is loaded (a stand-in: nothing of JAX is imported)",
    "slow": "each solve takes 0.05 s more",
}


def gathered_layout(local, mesh):
    """Every rank's rows as one CSR on each rank, laid out by the port's
    ``distribute_csr``."""
    import torch
    import torch.distributed as dist

    from sparse_matrix_math_tpu_torch import CSRMatrix, parallel

    def gathered(t, lengths):
        top = max(lengths)
        padded = torch.zeros(top, dtype=t.dtype, device=mesh.device)
        padded[:t.shape[0]] = t
        parts = [torch.empty_like(padded) for _ in range(mesh.size)]
        dist.all_gather(parts, padded, group=mesh.group)
        return torch.cat([p[:k] for p, k in zip(parts, lengths)])

    nnz = torch.tensor([local.nnz], device=mesh.device)
    sizes = [torch.empty_like(nnz) for _ in range(mesh.size)]
    dist.all_gather(sizes, nnz, group=mesh.group)
    sizes = [int(s) for s in sizes]
    rows, n = local.shape
    counts = gathered(torch.diff(local.indptr), [rows] * mesh.size)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=mesh.device)
    torch.cumsum(counts, 0, out=indptr[1:])
    whole = CSRMatrix(data=gathered(local.data, sizes), indices=gathered(local.indices, sizes),
                      indptr=indptr, shape=(n, n),
                      row_ids=torch.repeat_interleave(
                          torch.arange(n, device=mesh.device), counts))
    return parallel.distribute_csr(whole, mesh)


def plant(fault: str, parallel) -> None:
    """Put ``fault`` into this process's ``parallel.dist_solve``."""
    if fault == "jax":
        sys.modules["jax"] = types.ModuleType("jax")
        return
    raw, calls = parallel.dist_solve, [0]

    def faulty(operator, b, **options):
        res = raw(operator, b, **options)
        calls[0] += 1
        if fault == "perturbed":
            x = res.x.clone()
            x[0] += 1e-3
            return dataclasses.replace(res, x=x)
        if fault == "status":
            return dataclasses.replace(res, status=2)
        if fault == "raises" and calls[0] > 1:
            raise RuntimeError("a planted fault")
        if fault == "hangs" and calls[0] > 1:
            threading.Event().wait()
        if fault == "slow":
            time.sleep(0.05)
        return res

    parallel.dist_solve = faulty


def main() -> int:
    import os

    import torch

    from solvebench import reference, run
    from sparse_matrix_math_tpu_torch import parallel

    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--control", action="store_true")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    mine, rest = p.parse_known_args()
    cell = json.loads(Path(mine.cell).read_text())
    torch.set_num_threads(1)
    if mine.backend == "nccl":
        run.pin_caches()
    parallel.gathered_layout = gathered_layout
    if mine.fault and int(os.environ["RANK"]) == int(os.environ["WORLD_SIZE"]) - 1:
        plant(mine.fault, parallel)
    return run.rank_main(run.parse_args(rest), cell["manifest"],
                         solver_for=reference.control_solver if mine.control else None,
                         backend=mine.backend, cell=(cell["workload"], cell["config"]))


if __name__ == "__main__":
    sys.exit(main())
