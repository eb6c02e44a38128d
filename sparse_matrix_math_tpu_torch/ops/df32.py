"""Double-word f32 ("df32") arithmetic: f64-grade values as pairs of float32.

Port of ``sparse_matrix_math_tpu/ops/df32.py:80-577``.  Every value is an
unevaluated pair ``(hi, lo)`` of float32 with ``|lo| <= ulp(hi)/2``: a
48-bit significand, ~2^-47 relative error per operation with the accurate
double-word algorithms (Dekker 1971, Knuth TAOCP 4.2.2, Joldes-Muller-Popescu
2017):

* ``two_sum`` / ``_fast_two_sum`` — exact ``a + b = s + e``;
* ``two_prod`` — exact ``a * b = p + e`` by Dekker's split;
* ``df_add`` / ``df_mul`` / ``df_div`` / ``df_scale_add`` — double-word ops;
* ``df_dot`` / ``df_norm2`` — elementwise ``two_prod``, then a zero-padded
  power-of-two tree of ``df_add`` (the tree fixes the summation order);
* :class:`DfEllMatrix` and :class:`DfDiaMatrix` — the operator's float64
  values split exactly into (hi, lo) planes.  The DIA product is the Hopper
  kernel K9 (``ops/dia_spmv_df.py``); the ELL product is plain PyTorch, a
  gather per slot in slot order, as the JAX package computes it in XLA
  (df32.py:309-334) with no Pallas kernel;
* :class:`DfGridStencil` — the double-word twin of the matrix-free grid
  stencil (formats/stencil.py): a few (hi, lo) coefficient pairs and the
  shifted-slice pass in double-word arithmetic, plain PyTorch as the JAX
  package's is plain XLA (df32.py:488-550).

The error-free transforms need every float32 operation rounded on its own:
no multiply contracted with an add into an FMA, no reassociation.  The JAX
package computes them through one float64 operation on its CPU backend
(``_via_f64``, df32.py:83-108), because XLA:CPU contracts multiplies and adds
inside its fusions.  That switch is not ported: eager PyTorch runs each
operation as a kernel of its own that rounds its result to float32 in memory
before the next one reads it, on the CPU and on CUDA alike, so the pure-f32
sequences below are exact as written.  Never run them under
``torch.compile`` (it fuses, and its code generators may contract), and use
no operation that fuses a multiply with an add (``addcmul``,
``add(..., alpha=)``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "two_sum", "two_prod", "df_add", "df_sub", "df_add_f", "df_mul", "df_mul_f", "df_div",
    "df_scale_add", "df_dot", "df_dots", "df_norm2", "df_from_host", "df_to_host", "DfEllMatrix",
    "DfDiaMatrix", "DfGridStencil", "df_matvec_fn", "df_operator_from_host_csr",
]

Df = Tuple[torch.Tensor, torch.Tensor]

_SPLIT = 4097.0  # 2^12 + 1: Dekker's split point for a 24-bit significand


def two_sum(a, b) -> Df:
    """Exact a + b = s + e (Knuth; branch-free, any magnitudes)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _fast_two_sum(a, b) -> Df:
    """Exact a + b = s + e, requiring |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a) -> Df:
    """Dekker's split: a = hi + lo with hi, lo of 12-bit significands."""
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b) -> Df:
    """Exact a * b = p + e by Dekker's split (no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(a: Df, b: Df) -> Df:
    """Accurate double-word + double-word (AccurateDWPlusDW, ~2^-47)."""
    sh, sl = two_sum(a[0], b[0])
    th, tl = two_sum(a[1], b[1])
    c = sl + th
    vh, vl = _fast_two_sum(sh, c)
    w = tl + vl
    return _fast_two_sum(vh, w)


def df_sub(a: Df, b: Df) -> Df:
    return df_add(a, (-b[0], -b[1]))


def df_add_f(a: Df, f) -> Df:
    """double-word + plain f32."""
    sh, sl = two_sum(a[0], f)
    return _fast_two_sum(sh, sl + a[1])


def df_mul(a: Df, b: Df) -> Df:
    """Accurate double-word * double-word."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return _fast_two_sum(p, e)


def df_mul_f(a: Df, f) -> Df:
    """double-word * plain f32."""
    p, e = two_prod(a[0], f)
    return _fast_two_sum(p, e + a[1] * f)


def df_div(a: Df, b: Df) -> Df:
    """double-word / double-word (one Newton-style correction)."""
    q1 = a[0] / b[0]
    r = df_sub(a, df_mul_f(b, q1))
    q2 = r[0] / b[0]
    r = df_sub(r, df_mul_f(b, q2))
    q3 = r[0] / b[0]
    q, e = _fast_two_sum(q1, q2)
    return _fast_two_sum(q, e + q3)


def df_scale_add(y: Df, alpha: Df, x: Df) -> Df:
    """y + alpha * x over double-word vectors, with a double-word scalar
    ``alpha`` (the axpy of the solvers)."""
    p, e = two_prod(alpha[0], x[0])
    e = e + (alpha[0] * x[1] + alpha[1] * x[0])
    return df_add(y, _fast_two_sum(p, e))


def _df_pairwise_reduce(hi: torch.Tensor, lo: torch.Tensor) -> Df:
    """Pairwise double-word sum of elementwise pairs along the last axis, the
    JAX package's tree: zero-padded to a power of two, then halved level by
    level."""
    n = hi.shape[-1]
    p2 = 1 if n == 0 else 1 << (n - 1).bit_length()
    if p2 != n:
        hi = torch.nn.functional.pad(hi, (0, p2 - n))
        lo = torch.nn.functional.pad(lo, (0, p2 - n))
    while hi.shape[-1] > 1:
        m = hi.shape[-1] // 2
        hi, lo = df_add((hi[..., :m], lo[..., :m]), (hi[..., m:], lo[..., m:]))
    return hi[..., 0], lo[..., 0]


def df_dot(x: Df, y: Df) -> Df:
    """Compensated double-word dot product of double-word vectors."""
    p, e = two_prod(x[0], y[0])
    e = e + (x[0] * y[1] + x[1] * y[0])
    return _df_pairwise_reduce(p, e)


def df_dots(x: Df, ys) -> list:
    """``[df_dot(x, y) for y in ys]``, bit for bit, through one tree over the
    stacked ys: the same pairing in every row, a third of the launches for
    two dots."""
    hi, lo = df_dot(x, (torch.stack([y[0] for y in ys]), torch.stack([y[1] for y in ys])))
    return [(hi[i], lo[i]) for i in range(len(ys))]


def df_norm2(x: Df) -> Df:
    """||x||^2 as a double-word scalar."""
    return df_dot(x, x)


def df_from_host(v, *, device) -> Df:
    """Split float64 values (a NumPy array, or a tensor on any device)
    exactly into an (hi, lo) float32 pair on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.asarray(v, dtype=np.float64))
    v = v.to(device=device, dtype=torch.float64)
    hi = v.to(torch.float32)
    return hi, (v - hi.to(torch.float64)).to(torch.float32)


def df_to_host(x: Df) -> np.ndarray:
    """Recombine a (hi, lo) pair into host float64."""
    return (x[0].cpu().numpy().astype(np.float64)
            + x[1].cpu().numpy().astype(np.float64))


def _split_planes(values: np.ndarray, device) -> Df:
    hi = values.astype(np.float32)
    lo = (values - hi.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device)


def _host_csr(data, indices, indptr):
    return (np.asarray(data, dtype=np.float64), np.asarray(indices, dtype=np.int64),
            np.asarray(indptr, dtype=np.int64))


@dataclasses.dataclass(frozen=True)
class DfEllMatrix:
    """Double-word ELL matrix: the float64 values split exactly into (hi, lo)
    float32 planes, ``(rows_padded, K)`` as :class:`~..formats.ell.ELLMatrix`.

    The product computes, per slot: ``two_prod`` of the hi parts exactly,
    plus the f32 cross terms hi·x_lo + lo·x_hi, accumulated over the slots
    in double-word.  Padding slots carry hi = lo = 0 and column 0: exact
    no-ops.
    """

    vals_hi: torch.Tensor  # (rows_padded, K) float32
    vals_lo: torch.Tensor  # (rows_padded, K) float32
    cols: torch.Tensor     # (rows_padded, K) int32
    shape: Tuple[int, int]
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.vals_hi.device

    @classmethod
    def from_host_csr(cls, data, indices, indptr, shape: Tuple[int, int], *,
                      device) -> "DfEllMatrix":
        """Build on ``device`` from host CSR arrays (values in float64)."""
        data, indices, indptr = _host_csr(data, indices, indptr)
        n_rows, n_cols = shape
        row_nnz = np.diff(indptr)
        k = max(int(row_nnz.max()) if row_nnz.size else 0, 1)
        rows_p = max(-(-n_rows // 8) * 8, 8)
        vals = np.zeros((rows_p, k), np.float64)
        cols = np.zeros((rows_p, k), np.int32)
        r = np.repeat(np.arange(n_rows, dtype=np.int64), row_nnz)
        slot = np.arange(indptr[-1], dtype=np.int64) - np.repeat(indptr[:-1], row_nnz)
        vals[r, slot] = data
        cols[r, slot] = indices
        hi, lo = _split_planes(vals, device)
        return cls(vals_hi=hi, vals_lo=lo, cols=torch.from_numpy(cols).to(device),
                   shape=(int(n_rows), int(n_cols)), nnz=int(data.shape[0]))

    @classmethod
    def from_csr(cls, csr) -> "DfEllMatrix":
        """Build on the CSR matrix's device from its values; a float32 CSR
        gives zero lo planes (an f32-accurate operator)."""
        return cls.from_host_csr(csr.data.cpu().numpy(), csr.indices.cpu().numpy(),
                                 csr.indptr.cpu().numpy(), csr.shape, device=csr.device)

    def rmult_df(self, x: Df) -> Df:
        """y = A @ x with x, y double-word vectors (reference rMult,
        h:1458-1478, at f64 accuracy from f32 words)."""
        x_hi, x_lo = x
        rows_p, k = self.vals_hi.shape
        y = (x_hi.new_zeros(rows_p), x_hi.new_zeros(rows_p))
        for j in range(k):
            a_hi, a_lo, c = self.vals_hi[:, j], self.vals_lo[:, j], self.cols[:, j]
            xh, xl = x_hi.index_select(0, c), x_lo.index_select(0, c)
            p, e = two_prod(a_hi, xh)
            e = e + (a_hi * xl + a_lo * xh)
            y = df_add(y, _fast_two_sum(p, e))
        n_rows = self.shape[0]
        return y[0][:n_rows], y[1][:n_rows]


@dataclasses.dataclass(frozen=True)
class DfDiaMatrix:
    """Double-word DIA matrix: the layout of :class:`~..formats.dia.DIAMatrix`
    (``diags[d, i]`` is the entry at ``(i, i + offsets[d])``, slots outside
    the matrix hold 0) with the values split into (hi, lo) float32 planes.
    Its product is the padded kernel K9 (ops/dia_spmv_df.py)."""

    diags_hi: torch.Tensor  # (ndiags, rows) float32
    diags_lo: torch.Tensor  # (ndiags, rows) float32
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.diags_hi.device

    @classmethod
    def from_host_csr(cls, data, indices, indptr, shape: Tuple[int, int], *,
                      device) -> "DfDiaMatrix":
        """Build on ``device`` from host CSR arrays (values in float64), one
        (hi, lo) plane pair per populated diagonal."""
        data, indices, indptr = _host_csr(data, indices, indptr)
        n_rows, n_cols = shape
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        offs = indices - rows
        uniq = np.unique(offs)
        diags = np.zeros((uniq.shape[0], n_rows), np.float64)
        diags[np.searchsorted(uniq, offs), rows] = data
        hi, lo = _split_planes(diags, device)
        return cls(diags_hi=hi, diags_lo=lo, offsets=tuple(int(o) for o in uniq),
                   shape=(int(n_rows), int(n_cols)), nnz=int(data.shape[0]))

    def rmult_df(self, x: Df) -> Df:
        """y = A @ x, double-word in and out.  One-shot: the padded layout is
        built per call; solver loops build it once with :func:`df_matvec_fn`."""
        return df_matvec_fn(self)(x)


@dataclasses.dataclass(frozen=True)
class DfGridStencil:
    """Double-word matrix-free grid stencil, the twin of
    :class:`~..formats.stencil.GridStencilMatrix`: a few (hi, lo) scalar
    pairs, applied by the same zero-pad and shifted-slice sum in double-word
    arithmetic."""

    coeffs_hi: torch.Tensor  # (npoints,) float32
    coeffs_lo: torch.Tensor  # (npoints,) float32
    doffs: Tuple[Tuple[int, ...], ...]
    dims: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def device(self) -> torch.device:
        return self.coeffs_hi.device

    @classmethod
    def from_stencil(cls, st, coeffs64=None) -> "DfGridStencil":
        """From a GridStencilMatrix, on its device; ``coeffs64`` (host
        float64) overrides the coefficient values.  By default the stencil's
        own values are split exactly, so a float64 stencil keeps its
        precision in the lo words and a float32 one gives zero lo words."""
        c64 = np.asarray(st.coeffs.cpu().numpy() if coeffs64 is None else coeffs64, np.float64)
        hi, lo = _split_planes(c64, st.device)
        return cls(coeffs_hi=hi, coeffs_lo=lo, doffs=st.doffs, dims=st.dims, shape=st.shape,
                   nnz=int(st.nnz))

    def rmult_df(self, x: Df) -> Df:
        """y = A @ x, (hi, lo) in and out: the shifted slices of
        ``GridStencilMatrix.apply_grid`` accumulated in double-word, in the
        stencil's point order."""
        dims = self.dims
        nd = len(dims)
        lo_pad = [max(-min(o[d] for o in self.doffs), 0) for d in range(nd)]
        hi_pad = [max(max(o[d] for o in self.doffs), 0) for d in range(nd)]
        pad = []
        for d in reversed(range(nd)):  # F.pad counts from the last axis
            pad += [lo_pad[d], hi_pad[d]]
        xph = torch.nn.functional.pad(x[0].reshape(dims), pad)
        xpl = torch.nn.functional.pad(x[1].reshape(dims), pad)
        y = None
        for k, off in enumerate(self.doffs):
            sl = tuple(slice(lo_pad[d] + off[d], lo_pad[d] + off[d] + dims[d])
                       for d in range(nd))
            wh, wl = xph[sl], xpl[sl]
            c_hi, c_lo = self.coeffs_hi[k], self.coeffs_lo[k]
            p, e = two_prod(c_hi, wh)
            e = e + (c_hi * wl + c_lo * wh)
            t = _fast_two_sum(p, e)
            y = t if y is None else df_add(y, t)
        return y[0].reshape(-1), y[1].reshape(-1)


def df_matvec_fn(a):
    """The double-word matvec ``x_df -> A @ x_df`` of ``a``, with what it
    needs built once: for a :class:`DfDiaMatrix` the padded layout, so each
    call lifts the two words, launches K9 and drops the padding."""
    if isinstance(a, (DfEllMatrix, DfGridStencil)):
        return a.rmult_df
    if not isinstance(a, DfDiaMatrix):
        raise TypeError(f"no double-word matvec for {type(a).__name__}")
    if not a.offsets:  # no stored diagonal: A == 0
        return lambda x: (x[0].new_zeros(a.shape[0]), x[0].new_zeros(a.shape[0]))
    from .dia_spmv_df import dia_spmv_padded_df, pad_dia_df

    p = pad_dia_df(a)

    def mv(x: Df) -> Df:
        yh, yl = dia_spmv_padded_df(p, p.to_padded(x[0]), p.to_padded(x[1]))
        return p.from_padded(yh), p.from_padded(yl)

    return mv


# Diagonal budget for choosing DfDiaMatrix (the DIA format's max_diags): past
# it the dense (ndiags, n) planes cost more bytes than ELL's gather.
_DF_DIA_MAX_DIAGS = 64


def df_operator_from_host_csr(data, indices, indptr, shape: Tuple[int, int], *, device):
    """The double-word operator for the pattern, on ``device``: DIA when the
    matrix has at most 64 diagonals filled to at least a quarter (fill <= 4),
    ELL otherwise."""
    data, indices, indptr = _host_csr(data, indices, indptr)
    n_rows = shape[0]
    if data.size:
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        ndiags = np.unique(indices - rows).shape[0]
        fill = ndiags * n_rows / max(data.size, 1)
        if ndiags <= _DF_DIA_MAX_DIAGS and fill <= 4.0:
            return DfDiaMatrix.from_host_csr(data, indices, indptr, shape, device=device)
    return DfEllMatrix.from_host_csr(data, indices, indptr, shape, device=device)
