"""Peaks of the card and the least work of each operation, for roofline shares.

The least bytes of an operation count each input vector read once and the
output written once, plus the operator's values only where they are not
constant per diagonal (the operator module's ``value_bytes``: none for a
constant-coefficient stencil).  So a product or a preconditioner apply needs
``2 n itemsize`` bytes or more, whatever layout or kernel implements it: a
matrix-free or diagonal-resident kernel cannot read over 100%.  The flops
are those of the operation's definition.  The least time is the larger of
bytes over the memory bandwidth and flops over the dtype's peak.  Vectors
that fit in the card's 50 MB L2 could beat the bandwidth of HBM; the cells'
vectors do not (PERF.md).  Where a cell's rows are split over ranks, each
rank's least work is its share of the rows times the whole's.
"""

from __future__ import annotations

from solvebench import reference

# NVIDIA H100 SXM5 80GB data sheet, dense rates, at its 700 W power limit.
# float64 takes the FP64 tensor-core rate, the higher of its two peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
ITEMSIZE = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def rows(cfg: dict) -> int:
    return reference.operator(cfg).rows(cfg)


def product_flops(cfg: dict) -> int:
    """``y = A x``: a multiply and an add per point of a row."""
    return 2 * reference.operator(cfg).points(cfg) * rows(cfg)


def sgs_flops(cfg: dict, sweeps: int) -> int:
    """A truncated symmetric Gauss-Seidel apply: ``sweeps`` Jacobi sweeps of
    ``(D + L) y = r``, the product ``D y``, then ``sweeps`` sweeps of
    ``(D + U) z = D y``.  A sweep of a triangle with ``k`` strict points
    takes ``2 k + 1`` flops a row (its products and sums, then the scaling
    by ``1 / d``)."""
    strict = (reference.operator(cfg).points(cfg) - 1) // 2
    return (2 * sweeps * (2 * strict + 1) + 1) * rows(cfg)


def least_seconds(cfg: dict, flops: int, share=1) -> float:
    """The least time of an operation that reads one vector of the
    configuration's dtype and writes one, over ``share`` of the rows: a
    rank's share of them, its block over the whole, when the rows are split
    over ranks (1 on one card)."""
    itemsize = ITEMSIZE[cfg["dtype"]]
    nbytes = 2 * rows(cfg) * itemsize + reference.operator(cfg).value_bytes(cfg, itemsize)
    return max(share * nbytes / HBM_BYTES_PER_S, share * flops / PEAK_FLOPS[cfg["dtype"]])
