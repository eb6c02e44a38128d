from ._factorize import FactorizationError
from .cheby_poly import ChebyshevPreconditioner
from .padded_sgs import PaddedSGS
from .padded_tri import PaddedTriPair
from .preconditioners import (
    IC0Preconditioner,
    IdentityPreconditioner,
    ILU0Preconditioner,
    JacobiPreconditioner,
    SGSPreconditioner,
    SolverPreconditioner,
    get_preconditioner,
)
from .trisolve import TriangularMatrix, triangular_from_csr_arrays

__all__ = [
    "FactorizationError", "IdentityPreconditioner", "JacobiPreconditioner",
    "SGSPreconditioner", "ILU0Preconditioner", "IC0Preconditioner", "SolverPreconditioner",
    "get_preconditioner", "ChebyshevPreconditioner", "PaddedSGS", "PaddedTriPair", "TriangularMatrix",
    "triangular_from_csr_arrays",
]
