from .bicgstab import bicgstab
from .cg import cg, conjugate_gradient
from .types import SolveResult, SolverStatus

__all__ = ["bicgstab", "cg", "conjugate_gradient", "SolveResult", "SolverStatus"]
