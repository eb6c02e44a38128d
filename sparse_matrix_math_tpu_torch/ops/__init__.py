from .df32 import (
    DfDiaMatrix,
    DfEllMatrix,
    DfGridStencil,
    df_from_host,
    df_operator_from_host_csr,
    df_to_host,
)
from .spmv import as_operator, matvec_fn, rmult, rmult_add, rmult_sub
from .vector import axpy, dot, fill, norm2, norm2_squared, xpay

__all__ = [
    "as_operator", "matvec_fn", "rmult", "rmult_add", "rmult_sub",
    "axpy", "dot", "fill", "norm2", "norm2_squared", "xpay",
    "DfDiaMatrix", "DfEllMatrix", "DfGridStencil", "df_from_host", "df_operator_from_host_csr", "df_to_host",
]
