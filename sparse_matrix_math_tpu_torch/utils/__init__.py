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
from .checkpoint import (
    checkpointed_solve,
    load_checkpoint,
    load_csr_npz,
    save_checkpoint,
    save_csr_npz,
)
from .profiling import SolveStats, solve_with_stats, spmv_throughput

__all__ = ["convection_diffusion_2d", "laplace_1d", "laplace_3d_jittered", "poisson_2d",
           "poisson_3d", "poisson_3d_27pt", "random_spd_csr", "sherman1_tiled",
           "uniform_random_csr", "checkpointed_solve", "load_checkpoint", "save_checkpoint",
           "load_csr_npz", "save_csr_npz", "SolveStats", "solve_with_stats", "spmv_throughput"]
