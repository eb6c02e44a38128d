"""The benchmark of the PyTorch and CUDA port (``sparse_matrix_math_tpu_torch``):
preconditioned 3-D solves to tolerance, one run of one cell per process
(``run.py``).  It imports neither JAX nor the JAX package."""
