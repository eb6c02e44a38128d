"""Both packages build W-SELL and R-SELL layouts with the same layout code.

A port test that builds a layout with each package and compares them, or
compares what each package's ``best_format`` picks, imports
:func:`same_layout_code` into its module: an autouse fixture, so it holds
for every test of that module.

Under pytest-xdist the workers race to build the JAX package's native
library: a JAX process whose first build lost the race loses the library
(the winner's build step deletes the other processes' temporary files, and
a failed load is never retried), and then builds its layouts with NumPy
while the port uses its own native code.  The slot ratios, and with them
the layouts ``best_format`` chooses, can then differ.
"""

import time

import pytest

import sparse_matrix_math_tpu.native as jax_native
from sparse_matrix_math_tpu_torch import native

# the port's native layout routines, each bound in native.py
LAYOUT_NATIVES = ("wsell_plan", "wsell_color", "wsell_emit")


def jax_native_loaded(tries: int = 5) -> bool:
    """Whether the JAX package's native library is loaded, retrying its
    load.  The library exists once the winning build is done, so a fresh
    load then finds it."""
    for attempt in range(tries):
        if jax_native.available():
            return True
        jax_native._tried = False
        time.sleep(0.2 * (attempt + 1))
    return jax_native.available()


@pytest.fixture(autouse=True, scope="module")
def same_layout_code():
    """Both packages build W-SELL planes with the same code (the JAX
    library's load retried, :func:`jax_native_loaded`).  If it still fails,
    the port takes the NumPy layout code too."""
    if native.available() == jax_native_loaded():
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        for name in LAYOUT_NATIVES:
            mp.setattr(native, name, lambda *a, **k: None)
        yield
