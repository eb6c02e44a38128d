"""One torch intra-op thread per test process; every ``test_torch_*.py`` imports this.

Several pytest-xdist workers each running torch's thread pool on a machine
with few cores slow the small-tensor solves of the port's tests about tenfold
(six workers on eight cores: 606 s against 73 s for six of these files).
Elementwise results do not depend on the thread count, and every case passes
either way.  A test file run alone gets the same setting as the whole run,
because each file imports this module itself.
"""

import torch

torch.set_num_threads(1)
