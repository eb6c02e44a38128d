from .bicgstab import bicgstab
from .cg import cg, conjugate_gradient
from .df64 import DfSolveResult, bicgstab_df64, cg_df64
from .ir_df64 import bicgstab_ir_df64, cg_ir_df64
from .types import SolveResult, SolverStatus

__all__ = ["bicgstab", "cg", "conjugate_gradient", "SolveResult", "SolverStatus",
           "DfSolveResult", "bicgstab_df64", "cg_df64", "bicgstab_ir_df64", "cg_ir_df64"]
