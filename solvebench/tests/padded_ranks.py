"""One rank of a multi-rank cell whose call is the port's
``parallel.dist_padded_solve``, as ``run.launch`` starts it, with a fault
to plant: test code.

    python3 solvebench/tests/padded_ranks.py --cell <cell.json> [--fault <fault>]
        [--control] --workload <name> --seed <n> --seconds <s> --trace <0|1>

``cell.json`` holds ``{"workload": ..., "config": ..., "manifest": ...}``;
the ranks join over gloo on the CPU.  Every solution of the window is held
to the reference, not a sample of 8, so that a fault that spares some
solves is caught on every run.  A fault is planted on the last rank alone
(:data:`FAULTS`).
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[2])

FAULTS = {
    "unchanged": "each solve returns its block as it came in: x0, zeros",
    "half": "every second solve after the warm one returns the block of the solve before it",
}


def plant(fault: str, parallel) -> None:
    """Put ``fault`` into this process's ``parallel.dist_padded_solve``."""
    raw, calls, last = parallel.dist_padded_solve, [0], [None]

    def faulty(operator, b, **options):
        res = raw(operator, b, **options)
        calls[0] += 1
        x = res.x
        if fault == "unchanged":
            x = x.new_zeros(x.shape)
        elif fault == "half" and calls[0] % 2 == 1 and last[0] is not None:
            x = last[0]
        last[0] = res.x
        return dataclasses.replace(res, x=x)

    parallel.dist_padded_solve = faulty


def main() -> int:
    import os

    import torch

    from solvebench import reference, run
    from sparse_matrix_math_tpu_torch import parallel

    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--fault", choices=sorted(FAULTS))
    p.add_argument("--control", action="store_true")
    mine, rest = p.parse_known_args()
    cell = json.loads(Path(mine.cell).read_text())
    torch.set_num_threads(1)
    run.SAMPLE = 10 ** 6
    if mine.fault and int(os.environ["RANK"]) == int(os.environ["WORLD_SIZE"]) - 1:
        plant(mine.fault, parallel)
    return run.rank_main(run.parse_args(rest), cell["manifest"],
                         solver_for=reference.control_solver if mine.control else None,
                         backend="gloo", cell=(cell["workload"], cell["config"]))


if __name__ == "__main__":
    sys.exit(main())
