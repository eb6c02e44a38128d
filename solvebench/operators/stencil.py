"""A constant-coefficient stencil on a tensor-product grid with a zero
Dirichlet boundary (``"operator": "stencil"``).

The configuration gives the ``grid``, ``[nx, ny]`` or ``[nx, ny, nz]`` with x
fastest, and the ``stencil``: its ``points``, ``2 d + 1`` (the centre and its
face neighbours) or ``3 ** d`` (every neighbour) on a grid of ``d`` axes, the
``diagonal`` and the ``neighbour`` coefficient.  The CSR that :func:`csr`
builds is, entry for entry, what the port's ``utils/generate.py``
``poisson_2d`` / ``poisson_3d`` / ``poisson_3d_27pt`` build on the host (the
tests hold it to them), without their host sort: each row's points are laid
out in ascending column order to begin with.  :func:`csr_rows` builds a
block of those rows alone.  :func:`apply` is the plain product: one shifted
slice of the zero-padded grid per point.
"""

from __future__ import annotations

import itertools
import math

import torch


def grid(cfg: dict):
    """The axes' sizes, x first."""
    sizes = tuple(int(v) for v in cfg["grid"])
    if not sizes or min(sizes) < 1:
        raise ValueError(f"grid {cfg['grid']}: every axis needs a point")
    return sizes


def offsets(cfg: dict):
    """``[(offset, coefficient)]`` with each offset slowest axis first, in
    ascending flat-offset order."""
    d = len(grid(cfg))
    st = cfg["stencil"]
    if st["points"] not in (2 * d + 1, 3 ** d):
        raise ValueError(f"a {d}-axis stencil of {st['points']} points: "
                         f"{2 * d + 1} or {3 ** d}")
    out = []
    for off in itertools.product((-1, 0, 1), repeat=d):
        reach = sum(map(abs, off))
        if st["points"] == 2 * d + 1 and reach > 1:
            continue
        out.append((off, float(st["diagonal"] if reach == 0 else st["neighbour"])))
    return out


def rows(cfg: dict) -> int:
    return math.prod(grid(cfg))


def points(cfg: dict) -> int:
    """Points a row of the definition holds."""
    return len(offsets(cfg))


def value_bytes(cfg: dict, itemsize: int) -> int:
    """Bytes of values an implementation has to read: none, the
    coefficients being constant per diagonal."""
    return 0


def _shape(cfg: dict):
    return tuple(reversed(grid(cfg)))  # slowest axis first


def csr(cfg: dict, device, dtype, csr_type):
    """The operator as a ``csr_type`` (the port's CSRMatrix) built on
    ``device`` in ``dtype``: rows ascending, columns ascending within a row."""
    return csr_rows(cfg, 0, rows(cfg), device, dtype, csr_type)


def csr_rows(cfg: dict, lo: int, hi: int, device, dtype, csr_type):
    """Rows ``[lo, hi)`` of :func:`csr`, with their global columns, as a
    ``csr_type`` of shape ``(hi - lo, n)``: for a grid, the slab of the
    slowest axis's planes those rows span.  Nothing outside the rows is
    built."""
    shape = _shape(cfg)
    pts = offsets(cfg)
    n = math.prod(shape)
    if not 0 <= lo <= hi <= n:
        raise ValueError(f"rows [{lo}, {hi}) of an operator of {n}")
    m = hi - lo
    strides = [math.prod(shape[a + 1:]) for a in range(len(shape))]
    idx = torch.arange(lo, hi, dtype=torch.int64, device=device)
    coord = [(idx // s) % size for s, size in zip(strides, shape)]
    cols = torch.empty((m, len(pts)), dtype=torch.int64, device=device)
    valid = torch.ones((m, len(pts)), dtype=torch.bool, device=device)
    for p, (off, _) in enumerate(pts):
        for c, o, size in zip(coord, off, shape):
            if o:
                valid[:, p] &= (c + o >= 0) & (c + o < size)
        cols[:, p] = idx + sum(o * s for o, s in zip(off, strides))
    del coord
    coeffs = torch.tensor([c for _, c in pts], dtype=dtype, device=device)
    counts = valid.sum(dim=1)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    flat = valid.reshape(-1)
    indices = cols.reshape(-1)[flat]
    del cols
    data = coeffs.expand(m, len(pts)).reshape(-1)[flat]
    local = idx - lo if lo else idx
    row_ids = torch.repeat_interleave(local, counts, output_size=indices.shape[0])
    return csr_type(data=data, indices=indices, indptr=indptr, row_ids=row_ids,
                    shape=(m, n))


def apply(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``A x`` in x's dtype."""
    shape = _shape(cfg)
    xp = torch.nn.functional.pad(x.reshape(shape), (1, 1) * len(shape))
    y = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for off, c in offsets(cfg):
        y.add_(xp[tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, shape))], alpha=c)
    return y.reshape(-1)
