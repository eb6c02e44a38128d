from .dispatch import load_matrix, load_matrix_csr, load_matrix_df
from .matrix_market import (
    MatrixLoadStatus,
    MatrixMarketError,
    load_matrix_market,
    load_matrix_market_coo,
)
from .smmdt import load_smmdt, save_dense_text

__all__ = ["load_matrix", "load_matrix_csr", "load_matrix_df", "MatrixLoadStatus",
           "MatrixMarketError", "load_matrix_market", "load_matrix_market_coo", "load_smmdt",
           "save_dense_text"]
