"""The control of a cell: a run in which the plain reference's CG, computed
in the precision below the configuration's, takes the program's place.  Its
result has to come out not correct; its worst residual is the upper reading
the cell's limit is set below (PERF.md).  The benchmark's runs never run it.

    python3 solvebench/control.py --workload <cell> --seed <n> --seconds <s>
"""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from solvebench import reference, run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(solver_for=reference.control_solver))
