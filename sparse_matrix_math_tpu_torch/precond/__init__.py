from .preconditioners import (
    FactorizationError,
    IdentityPreconditioner,
    JacobiPreconditioner,
)

__all__ = ["FactorizationError", "IdentityPreconditioner", "JacobiPreconditioner"]
