from .generate import (
    convection_diffusion_2d,
    laplace_1d,
    laplace_3d_jittered,
    poisson_2d,
    poisson_3d,
    poisson_3d_27pt,
    random_spd_csr,
    sherman1_tiled,
    uniform_random_csr,
)

__all__ = ["convection_diffusion_2d", "laplace_1d", "laplace_3d_jittered", "poisson_2d",
           "poisson_3d", "poisson_3d_27pt", "random_spd_csr", "sherman1_tiled",
           "uniform_random_csr"]
