from .dispatch import load_matrix_csr, load_matrix_df
from .matrix_market import MatrixLoadStatus, MatrixMarketError, load_matrix_market_coo

__all__ = ["load_matrix_csr", "load_matrix_df", "MatrixLoadStatus", "MatrixMarketError",
           "load_matrix_market_coo"]
