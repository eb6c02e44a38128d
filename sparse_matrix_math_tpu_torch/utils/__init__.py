from .generate import (
    convection_diffusion_2d,
    laplace_1d,
    poisson_2d,
    poisson_3d,
    poisson_3d_27pt,
)

__all__ = ["convection_diffusion_2d", "laplace_1d", "poisson_2d", "poisson_3d",
           "poisson_3d_27pt"]
