from .dispatch import load_matrix_csr
from .matrix_market import MatrixLoadStatus, MatrixMarketError, load_matrix_market_coo

__all__ = ["load_matrix_csr", "MatrixLoadStatus", "MatrixMarketError",
           "load_matrix_market_coo"]
