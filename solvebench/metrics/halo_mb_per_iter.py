"""Megabytes (10^6 bytes) this rank sent in halo exchanges per executed
iteration: the program's counter ``parallel/mesh.py:collectives
["halo_bytes"]`` over ``solvers/_loop.py:chunk_counts["passes"]``, both
counted since the process started (the warm solve, the window, and the one
exchange of coefficient rows at the first solve's layout).  A whole-block
exchange would read the block's bytes a product.  Nothing where the
program has no such counter or ran no pass."""

import importlib


def read(run):
    try:
        sent = importlib.import_module("sparse_matrix_math_tpu_torch.parallel.mesh").collectives
        passes = importlib.import_module("sparse_matrix_math_tpu_torch.solvers._loop").chunk_counts
    except (ImportError, AttributeError):
        return None
    if "halo_bytes" not in sent or not passes.get("passes"):
        return None
    return 1e-6 * sent["halo_bytes"] / passes["passes"]
