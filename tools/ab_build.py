"""Build versions of one CUDA source side by side for the A/B tools.

    from ab_build import build
    built = build({"parent": "old.cu", "this": "new.cu"}, out_dir, "libdia")

Each source is compiled by its own ``nvcc`` process, all started together,
with the port's flags (``ops/_build.py``) and ``-Xptxas -v``, into
``out_dir/{prefix}_{key}.so``.  Returns, per key, the library's path and
ptxas's report per kernel: registers, static shared memory, stack frame and
spill stores.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import os
import re
import subprocess


def _ptxas(text: str) -> dict:
    out = {}
    for chunk in text.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]

        def num(pattern):
            m = re.search(pattern, chunk)
            return int(m.group(1)) if m else None

        if num(r"Used (\d+) registers") is not None:
            out[name] = {"registers": num(r"Used (\d+) registers"),
                         "static_smem_bytes": num(r"(\d+) bytes smem") or 0,
                         "stack_frame_bytes": num(r"(\d+) bytes stack frame"),
                         "spill_store_bytes": num(r"(\d+) bytes spill stores")}
    return out


def build(sources: dict, out_dir: str, prefix: str) -> dict:
    """``{key: {"lib": path, "ptxas": {kernel: report}}}`` for ``{key:
    source path}``."""
    from sparse_matrix_math_tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for key, src in sources.items():
        lib = os.path.join(out_dir, f"{prefix}_{key}.so")
        cmd = [_build._nvcc(), *_build._COMPILE_FLAGS, "-shared", "-Xptxas", "-v", "-o", lib,
               src]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        out[key] = {"lib": lib, "ptxas": _ptxas(text)}
    return out
