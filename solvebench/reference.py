"""The plain reference: the float64 true residual that decides ``correct``,
and the control solver.

Nothing here imports the program.  The operator is the module under
``operators/`` that the configuration names in its ``operator`` key, which
rebuilds it from the configuration's own description (for a stencil: grid,
points, coefficients); the program's CSR, DIA or stencil objects are never
read.
"""

from __future__ import annotations

import importlib
import math
import re

import torch

__all__ = ["operator", "apply", "relative_residual", "control_solver", "LOWER_PRECISION"]

# the nearest precision below a configuration's: what the control computes in
LOWER_PRECISION = {"float64": torch.float32, "float32": torch.bfloat16}


def operator(cfg: dict):
    """The module ``operators/<cfg["operator"]>.py``."""
    name = cfg["operator"]
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"operator {name!r}: not a module name")
    return importlib.import_module(f"solvebench.operators.{name}")


def apply(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``A x`` in x's dtype, by the configuration's plain operator."""
    return operator(cfg).apply(cfg, x)


def relative_residual(cfg: dict, x: torch.Tensor, b: torch.Tensor) -> float:
    """``||b - A x|| / ||b||`` in float64; infinity for a non-finite or
    misshapen ``x``."""
    if tuple(x.shape) != tuple(b.shape):
        return math.inf
    x64, b64 = x.to(torch.float64), b.to(torch.float64)
    r = torch.linalg.vector_norm(b64 - apply(cfg, x64))
    value = float(r / torch.linalg.vector_norm(b64))
    return value if math.isfinite(value) else math.inf


class _ControlResult:
    def __init__(self, x, status, iterations):
        self.x, self.status, self.iterations = x, status, iterations
        self.residual_norm = torch.zeros((), dtype=torch.float64)


def control_solver(cfg: dict, max_iterations: int = 1000):
    """The control: plain CG on the reference operator, every vector and
    scalar in the precision below the configuration's, stopping when its
    recurrence residual passes ``epsilon`` (status 0) or at
    ``max_iterations`` (status 2).  It takes the program's place in a run:
    the same call, the program's operator ignored."""
    low = LOWER_PRECISION[cfg["dtype"]]
    op = operator(cfg)

    def solve(_operator, b, epsilon, **_options):
        b = b.to(low)
        x = torch.zeros_like(b)
        r = b.clone()
        p = r.clone()
        rr = torch.dot(r, r)
        eps2 = float(epsilon) ** 2
        k, status = 0, 2
        while k < max_iterations:
            if float(rr) < eps2:
                status = 0
                break
            ap = op.apply(cfg, p)
            alpha = rr / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            new_rr = torch.dot(r, r)
            p = r + (new_rr / rr) * p
            rr = new_rr
            k += 1
        return _ControlResult(x, status, k)

    return solve
