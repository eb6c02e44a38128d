#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase H (the mixed-precision path) for the
checkout at ROOT on one CUDA card, so that two checkouts can be compared
in one call.

    python3 tools/phase_h_run.py ROOT

ROOT is a checkout of the repository (this one, or another commit's,
unpacked with ``git archive`` into the git-ignored ``chip_checkout/``); its
own ``chip_smoke.py`` and package are imported, and its kernels built into
its own ``sparse_matrix_math_tpu_torch/build/``.  Prints phase H's lines
and, last, one line ``PHASE_H {json}`` with the root, the solves (device µs
per iteration of ``mixed_cg`` and plain ``cg``, walls, iterations, rounds,
launches) and the K2 cases.  Run it on the parent's checkout and this one
in turns (parent, change, change, parent).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.solvers import _loop

    if not smm.__file__.startswith(root):
        raise RuntimeError(f"imported {smm.__file__}, not the checkout at {root}")
    _build.library()
    stats = chip_smoke.phase_h(smm, K, _loop, torch, torch.device("cuda", 0))
    print("PHASE_H", json.dumps({"root": root, "solves": stats["solves"],
                                 "cases": stats["cases"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
