"""Bandwidth-reducing reordering onto W-SELL, and the solver front door.

Port of ``sparse_matrix_math_tpu/formats/reorder.py`` (the whole file).  A
scattered pattern (a shuffled mesh, an arbitrary node numbering) pads
beyond W-SELL's ratio cap; a reverse Cuthill-McKee (RCM) renumbering makes
it banded again, and W-SELL then packs it tightly:

1. :func:`rcm_permutation`: RCM on the symmetrised pattern (SciPy's
   ``reverse_cuthill_mckee`` when SciPy imports, else a NumPy BFS);
2. :func:`permute_csr`: ``A' = A[p, :][:, p]``;
3. the W-SELL layout of ``A'``, or None when even that pads past the cap.

:class:`ReorderedMatrix` acts as the original ``A``.  :func:`reorder_hoisted`
wraps the solver entry points: a large CSR matrix on a CUDA device is routed
first (:func:`~.auto_route_for_solve`), and a ``ReorderedMatrix`` is solved
in the permuted domain: b and x0 are permuted once, x un-permuted once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .csr import CSRMatrix, csr_from_coo
from .triplet import COOArrays
from .wsell import try_wsell_from_csr

__all__ = ["ReorderedMatrix", "rcm_permutation", "permute_csr", "reorder_to_wsell",
           "reorder_hoisted"]


def _rcm_numpy(indptr: np.ndarray, indices: np.ndarray, n: int) -> np.ndarray:
    """RCM on a symmetric adjacency (CSR indptr/indices): BFS from a
    minimum-degree seed per component, neighbours visited in degree order,
    the order reversed."""
    degree = np.diff(indptr)
    visited = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u]: indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)  # sorted: a stable tie-break
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos: pos + nbrs.size] = nbrs
                pos += nbrs.size
    return order[::-1].copy()


def rcm_permutation(csr: CSRMatrix) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a square matrix's pattern:
    ``perm`` (int64, host) such that ``A[perm, :][:, perm]`` has small
    bandwidth.  The pattern is symmetrised first."""
    n_rows, n_cols = csr.shape
    if n_rows != n_cols:
        raise ValueError("rcm_permutation needs a square matrix")
    r = csr.row_ids.cpu().numpy().astype(np.int64)
    c = csr.indices.cpu().numpy().astype(np.int64)
    rs = np.concatenate([r, c])
    cs = np.concatenate([c, r])
    keep = rs != cs
    key = np.unique(rs[keep] * n_rows + cs[keep])
    rs, cs = key // n_rows, key % n_rows
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rs, minlength=n_rows), out=indptr[1:])
    try:
        from scipy.sparse import csr_matrix
        from scipy.sparse.csgraph import reverse_cuthill_mckee
    except ImportError:
        return _rcm_numpy(indptr, cs, n_rows)
    g = csr_matrix((np.ones(cs.shape[0], np.int8), cs.astype(np.int32), indptr),
                   shape=(n_rows, n_rows))
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True), dtype=np.int64)


def permute_csr(csr: CSRMatrix, perm: np.ndarray) -> CSRMatrix:
    """Symmetric permutation on the CSR's device: ``A'[i, j] = A[perm[i], perm[j]]``."""
    perm = torch.as_tensor(np.asarray(perm, dtype=np.int64), device=csr.device)
    iperm = torch.empty_like(perm)
    iperm[perm] = torch.arange(perm.shape[0], device=csr.device)
    return csr_from_coo(COOArrays(rows=iperm[csr.row_ids], cols=iperm[csr.indices],
                                  vals=csr.data, shape=csr.shape), needs_sort=True)


@dataclasses.dataclass(frozen=True)
class ReorderedMatrix:
    """A sparse operator stored in a bandwidth-reduced ordering; it acts as
    the ORIGINAL matrix.  ``inner`` is the operator of ``A' = A[perm][:, perm]``
    (a :class:`~.wsell.WSellMatrix`), ``inner_csr`` the permuted CSR."""

    inner: object
    inner_csr: Optional[CSRMatrix]
    perm: torch.Tensor   # (n,) int64: new index i holds old index perm[i]
    iperm: torch.Tensor  # (n,) int64: the inverse permutation
    shape: Tuple[int, int]
    nnz: int

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    def to_permuted(self, x: torch.Tensor) -> torch.Tensor:
        """Old order -> permuted order (``x[perm]``), along the first axis."""
        return x.index_select(0, self.perm)

    def from_permuted(self, xp: torch.Tensor) -> torch.Tensor:
        """Permuted order -> old order."""
        return xp.index_select(0, self.iperm)

    def rmult(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops import spmv

        return spmv.rmult(self, x)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmult(x)

    def to_dense(self) -> torch.Tensor:
        return self.inner.to_dense()[self.iperm][:, self.iperm]


def reorder_to_wsell(csr: CSRMatrix, *, max_slot_ratio: float = 8.0
                     ) -> Optional[ReorderedMatrix]:
    """RCM-permute ``csr`` and lay the result out as W-SELL, on the CSR's
    device; None when even the permuted pattern pads beyond the cap."""
    perm = rcm_permutation(csr)
    permuted = permute_csr(csr, perm)
    ws = try_wsell_from_csr(permuted, max_slot_ratio=max_slot_ratio)
    if ws is None:
        return None
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0])
    return ReorderedMatrix(inner=ws, inner_csr=permuted,
                           perm=torch.as_tensor(perm, device=csr.device),
                           iperm=torch.as_tensor(iperm, device=csr.device),
                           shape=csr.shape, nnz=int(csr.nnz))


def reorder_hoisted(solver_fn):
    """Wrap a solver entry ``f(a, b, x0=None, **kw) -> SolveResult``: a large
    CSR matrix on a CUDA device is routed to a fast layout first, and a
    :class:`ReorderedMatrix` is solved in the permuted domain (b and x0
    permuted once, x un-permuted once).  Residuals, iterations and status
    are permutation-invariant and pass through unchanged."""

    @functools.wraps(solver_fn)
    def wrapped(a, b, x0=None, *args, **kwargs):
        if isinstance(a, CSRMatrix):
            from . import auto_route_for_solve

            a = auto_route_for_solve(
                a, has_preconditioner=kwargs.get("preconditioner") is not None
            )
        if not isinstance(a, ReorderedMatrix):
            return solver_fn(a, b, x0, *args, **kwargs)
        x0p = None if x0 is None else a.to_permuted(x0)
        res = solver_fn(a.inner, a.to_permuted(b), x0p, *args, **kwargs)
        return dataclasses.replace(res, x=a.from_permuted(res.x))

    return wrapped
