from .api import SOLVERS, SolverConfig, solve
from .bicg_symmetric import bicg_symmetric
from .bicgstab import bicgstab
from .block import MultiSolveResult, cg_multi
from .cg import cg, conjugate_gradient
from .cgs import cgs, conjugate_gradient_squared
from .df64 import DfSolveResult, bicgstab_df64, cg_df64
from .ir_df64 import bicgstab_ir_df64, cg_ir_df64
from .types import SolveResult, SolverStatus

__all__ = ["bicgstab", "cg", "conjugate_gradient", "bicg_symmetric", "cgs",
           "conjugate_gradient_squared", "solve", "SolverConfig", "SOLVERS", "SolveResult",
           "SolverStatus", "DfSolveResult", "bicgstab_df64", "cg_df64", "bicgstab_ir_df64",
           "cg_ir_df64", "cg_multi", "MultiSolveResult"]
