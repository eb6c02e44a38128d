"""Distributed padded DIA: each rank's own rows, K3 and K4 over plane-deep halos.

The port's own layer (the JAX package has no counterpart): a DIA solve of a
banded operator whose rows are split in contiguous blocks over the row mesh,
each rank laying out and holding only its own block.

* :func:`distribute_dia_rows` takes a rank's rows ``[lo, hi)`` as a
  ``CSRMatrix`` of shape ``(hi - lo, n)`` with global columns.  It finds the
  block's offsets (column minus global row) on the device, agrees the
  offset set over the ranks, and lays the block's diagonals out as
  ``(ndiags, hi - lo)``.  No rank holds another rank's rows.
* :func:`dist_padded_solve` runs the single-device CG and PCG cores
  (``solvers/cg.py``) over the shard.  Each solve's
  layout (built at the first solve of a sweep count, then kept) puts the
  block in the flat padded layout of ``ops/dia_spmv.py:PaddedDIA``, with
  guards of ``depth + reach`` rows (``reach`` the largest ``|offset|``),
  and, for SGS, the neighbours' coefficient rows of ``depth`` rows each
  side, exchanged once there.
* The product is K3 (``dia_spmv_padded``) over the shard's rows.  Its halo,
  ``reach`` rows of each neighbour's block, is received straight into the
  multiplicand's guard rows (:func:`~.mesh.open_halo_rows`) and the guards
  are zeroed again after the launch.  Every solver vector therefore keeps
  exact zeros in its guards between operations, and the dots cover the own
  rows alone; neither the core nor the dots copy a vector.
* The SGS(s) apply is one launch of the single-card K4 (``sgs_apply_fused``)
  over a window ``[depth rows of the previous rank | own rows | depth rows
  of the next rank]`` of the same layout, ``depth`` the truncated sweeps'
  reach ``(s - 1) * reach`` rounded up to 128 rows: one exchange an apply
  fills the residual's guards, the kernel sweeps the window, and the
  window's halo rows of the result and the residual's guards are zeroed.  A
  row of the forward iterate ``s - 1`` sweeps deep depends on the residual
  ``(s - 1) * reach`` rows behind it, and a row of the backward one on the
  forward result as far ahead, so the own rows come out as the single-card
  apply on the whole system computes them, bit for bit.  The window's halo
  rows, which the neighbours compute as their own, are swept again here:
  ``2 * depth`` rows beside the ``hi - lo`` own ones, in each direction.
  The first and last ranks have no halo on their outer side, where the
  window ends at the system's boundary as a single card's does.  Where the
  window's values are those of a constant-coefficient grid stencil (HPCG's
  operator), the window's strict parts are held as one value a diagonal, at
  the window's row phase, and K4 reads them as scalars, as on one card.

On CUDA tensors the product and the apply are the kernels or raise; on the
CPU (gloo) their plain versions run the same index math.  Every dot is a
``torch.dot`` over the own rows and one ``mesh.all_reduce``, so every host
read of the cores sees all-reduced values and the ranks take the same
branches and chunk lengths.  A solve's ``x`` is the rank's ``hi - lo`` rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..formats.csr import CSRMatrix
from ..ops.dia_spmv import _BLOCK, _MAX_DIAGS, PaddedDIA, dia_spmv_padded
from ..ops.trisweep import constant_stencil, sgs_apply_fused
from ..precond._factorize import FactorizationError
from ..precond.padded_sgs import PaddedSGS
from ..precond.preconditioners import _SGS_MIN_DIAG
from ..solvers.api import _SGS_KINDS
from ..solvers.cg import cg_core, pcg_core
from ..solvers.types import SolveResult, resolve_max_iterations
from ..utils.profiling import span, spanned
from .mesh import RowMesh, all_reduce, open_halo_rows, resolve_mesh

__all__ = ["DistPaddedDIA", "distribute_dia_rows", "dist_padded_spmv", "dist_padded_solve"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(eq=False)
class DistPaddedDIA:
    """This rank's rows of a row-block-partitioned DIA operator.

    ``diags[d, i]`` is the entry at global ``(row_start + i, row_start + i
    + offsets[d])``; ``offsets`` ascend and are every rank's.  ``blocks``
    holds every rank's row count, in rank order.  ``layout`` keeps the
    padded layout of the last solve, with its sweep count: one at a time,
    since each holds the operator again."""

    diags: torch.Tensor  # (ndiags, rows)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    row_start: int
    blocks: Tuple[int, ...]
    nnz: int
    mesh: RowMesh
    layout: Optional[Tuple[Optional[int], "_Layout"]] = dataclasses.field(default=None,
                                                                            repr=False)

    @property
    def rows(self) -> int:
        return self.blocks[self.mesh.rank]

    @property
    def reach(self) -> int:
        return max(abs(o) for o in self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.diags.dtype


def distribute_dia_rows(local: CSRMatrix, mesh: Optional[RowMesh] = None) -> DistPaddedDIA:
    """This rank's DIA shard of its own rows ``local`` (a ``CSRMatrix`` of
    shape ``(rows, n)``, global columns, row ids local to the block), the
    ranks' blocks contiguous in rank order.  Raises ValueError, on every
    rank alike, where the blocks do not add up to a square system, the
    ranks' offsets number more than 64, or the reach exceeds a block."""
    mesh = resolve_mesh(mesh)
    rows, n = local.shape
    offs = local.indices - local.row_ids  # column minus the row within the block
    everyone = [None] * mesh.size
    torch.distributed.all_gather_object(
        everyone, (int(rows), int(local.nnz), torch.unique(offs).tolist()), group=mesh.group)
    blocks = tuple(e[0] for e in everyone)
    starts = [sum(blocks[:r]) for r in range(mesh.size)]
    offsets = tuple(sorted({o - start for (_, _, own), start in zip(everyone, starts)
                            for o in own}))
    if sum(blocks) != n:
        raise ValueError(f"the ranks' blocks hold {sum(blocks)} rows of an operator of {n} "
                         "columns: distribute_dia_rows takes square systems")
    if not 1 <= len(offsets) <= _MAX_DIAGS:
        raise ValueError(f"the operator has {len(offsets)} diagonals; the DIA kernels take "
                         f"1..{_MAX_DIAGS}")
    reach = max(abs(o) for o in offsets)
    if mesh.size > 1 and reach > min(blocks):
        raise ValueError(f"the reach {reach} exceeds a rank's block of {min(blocks)} rows: "
                         "a halo comes from the neighbours' blocks alone")
    row_start = starts[mesh.rank]
    offs.sub_(row_start)
    uniq = torch.tensor(offsets, dtype=offs.dtype, device=offs.device)
    diags = torch.zeros((len(offsets), rows), dtype=local.dtype, device=local.device)
    diags[torch.searchsorted(uniq, offs), local.row_ids] = local.data
    return DistPaddedDIA(diags=diags, offsets=offsets, shape=(int(n), int(n)),
                         row_start=row_start, blocks=blocks,
                         nnz=sum(e[1] for e in everyone), mesh=mesh)


@dataclasses.dataclass(frozen=True)
class _Layout:
    """A solve's padded layout of the shard: the product's ``PaddedDIA``
    (own rows from ``lead``), the SGS window's ``PaddedSGS`` (None without
    one) and its halo ``depth``."""

    pdia: PaddedDIA
    psgs: Optional[PaddedSGS]
    depth: int

    @property
    def lead(self) -> int:
        return self.pdia.lead


def _layout(op: DistPaddedDIA, sweeps: Optional[int]) -> _Layout:
    """The padded layout for ``sweeps`` SGS sweeps (None: the product
    alone, which any layout serves), kept on ``op`` until a solve asks for
    another sweep count; an SGS layout's build opens an
    ``smm.precond_build`` span."""
    if op.layout is not None and sweeps in (op.layout[0], None):
        return op.layout[1]
    if sweeps is None:
        return _build_layout(op, None)
    with span("precond_build"):
        return _build_layout(op, sweeps)


def _build_layout(op: DistPaddedDIA, sweeps: Optional[int]) -> _Layout:
    mesh, m, reach = op.mesh, op.rows, op.reach
    depth = _round_up((sweeps - 1) * reach, _BLOCK) if sweeps else 0
    if mesh.size > 1 and depth > min(op.blocks):
        raise ValueError(f"SGS({sweeps}) reaches {depth} rows into a neighbour's block of "
                         f"{min(op.blocks)}; take fewer sweeps or fewer ranks")
    guard = max(_round_up(depth + reach, _BLOCK), _BLOCK)
    n_total = 2 * guard + _round_up(m, _BLOCK)
    nd = len(op.offsets)
    diags_p = torch.zeros((nd, n_total), dtype=op.dtype, device=op.diags.device)
    diags_p[:, guard:guard + m] = op.diags
    if depth:
        # the neighbours' coefficient rows that the window's halo sweeps read
        into_prev = diags_p.new_zeros((nd, depth))
        into_next = diags_p.new_zeros((nd, depth))
        open_halo_rows(op.diags[:, :depth].contiguous(), op.diags[:, m - depth:].contiguous(),
                       into_prev, into_next, mesh)
        diags_p[:, guard - depth:guard] = into_prev
        diags_p[:, guard + m:guard + m + depth] = into_next
    pdia = PaddedDIA(diags_p=diags_p, offsets=op.offsets, shape=(m, m), nnz=op.nnz,
                     n_total=n_total, lblk=guard // _BLOCK, nblk=-(-m // _BLOCK))
    psgs = _window_sgs(op, diags_p, guard, depth, sweeps) if sweeps else None
    lay = _Layout(pdia, psgs, depth)
    op.layout = (sweeps, lay)
    return lay


def _window_sgs(op: DistPaddedDIA, diags_p: torch.Tensor, guard: int, depth: int,
                sweeps: int) -> PaddedSGS:
    """The shard's SGS factors over its window ``[guard - before, guard +
    rows + after)`` of the padded diagonals (:func:`window_sgs`)."""
    mesh, m = op.mesh, op.rows
    if 0 not in op.offsets:
        raise FactorizationError("SGS requires a stored main diagonal")
    main = op.offsets.index(0)
    small = (op.diags[main].abs() < _SGS_MIN_DIAG).any().to(op.dtype)
    if float(all_reduce(small, mesh)) > 0:
        raise FactorizationError(f"SGS requires |diagonal| >= {_SGS_MIN_DIAG} on every row")
    before = depth if mesh.rank > 0 else 0
    after = depth if mesh.rank + 1 < mesh.size else 0
    return window_sgs(diags_p, op.offsets, guard - before, m + before + after, sweeps,
                      op.row_start - before, op.shape[0], op.nnz)


def window_sgs(diags_p: torch.Tensor, offsets: Tuple[int, ...], lead: int, rows: int,
               sweeps: int, row0: int, n_global: int, nnz: int) -> PaddedSGS:
    """SGS factors over the window ``[lead, lead + rows)`` of padded
    diagonals ``diags_p`` (``offsets`` ascending, the main one among them;
    ``lead`` a whole number of blocks), whose rows are global rows from
    ``row0`` of a system of ``n_global``: the diagonal and its inverse, 0
    outside the window, and the strict parts as one value a diagonal where
    the window holds a constant-coefficient stencil
    (:func:`~..ops.trisweep.constant_stencil`), else views of their rows."""
    main = offsets.index(0)
    window = slice(lead, lead + rows)
    diag_p = torch.zeros_like(diags_p[main])
    diag_p[window] = diags_p[main, window]
    inv_diag_p = torch.zeros_like(diag_p)
    inv_diag_p[window] = 1.0 / diag_p[window]
    n_total = diags_p.shape[1]
    found = constant_stencil(diags_p, offsets, inv_diag_p, lead, rows, row0, n_global,
                             lead=lead, n_total=n_total)

    def strict(sign: int, part: slice):
        if found is not None:
            return found[sign > 0]
        if not offsets[part]:
            return None
        return PaddedDIA(diags_p=diags_p[part], offsets=offsets[part], shape=(rows, rows),
                         nnz=nnz, n_total=n_total, lblk=lead // _BLOCK,
                         nblk=-(-rows // _BLOCK))

    return PaddedSGS(p_lower=strict(-1, slice(0, main)), p_upper=strict(1, slice(main + 1, None)),
                     inv_diag_p=inv_diag_p, diag_p=diag_p, shape=(rows, rows),
                     sweeps=int(sweeps), lead=lead, n_total=n_total)


def _fill_halo(v: torch.Tensor, lay: _Layout, mesh: RowMesh, depth: int) -> None:
    """The neighbours' ``depth`` boundary rows into ``v``'s guards."""
    lead, m = lay.lead, lay.pdia.shape[0]
    if depth:
        open_halo_rows(v[lead:lead + depth], v[lead + m - depth:lead + m],
                       v[lead - depth:lead], v[lead + m:lead + m + depth], mesh)


def _clear_halo(v: torch.Tensor, lay: _Layout, mesh: RowMesh, depth: int) -> None:
    """``v``'s ``depth`` rows beside the own rows back to zero, on the
    sides that have a neighbour."""
    lead, m = lay.lead, lay.pdia.shape[0]
    if depth and mesh.rank > 0:
        v[lead - depth:lead].zero_()
    if depth and mesh.rank + 1 < mesh.size:
        v[lead + m:lead + m + depth].zero_()


def _product(lay: _Layout, mesh: RowMesh, reach: int):
    """The shard's ``y = A v`` on padded vectors: K3 over the own rows with
    the neighbours' ``reach`` rows in ``v``'s guards for the launch."""

    def matvec(v: torch.Tensor) -> torch.Tensor:
        with span("spmv"):
            _fill_halo(v, lay, mesh, reach)
            y = dia_spmv_padded(lay.pdia, v)
            _clear_halo(v, lay, mesh, reach)
            return y

    return matvec


def _sgs_apply(lay: _Layout, mesh: RowMesh):
    """The shard's ``z = M^{-1} r``: K4 over the window, the residual's
    guards holding the neighbours' ``depth`` rows for the launch."""
    depth = lay.depth

    def apply(r: torch.Tensor) -> torch.Tensor:
        _fill_halo(r, lay, mesh, depth)
        z = sgs_apply_fused(lay.psgs, r)
        _clear_halo(r, lay, mesh, depth)
        _clear_halo(z, lay, mesh, depth)
        return z

    return apply


def _own_dot(lay: _Layout, mesh: RowMesh):
    """The global inner product: ``torch.dot`` over the own rows, then one
    all-reduce."""
    own = slice(lay.lead, lay.lead + lay.pdia.shape[0])

    def dotfn(u, v):
        return all_reduce(torch.dot(u[own], v[own]), mesh)

    return dotfn


def _sweeps_of(preconditioner, options) -> Optional[int]:
    """The SGS sweep count a solve asks for (4 by default, as a single-card
    DIA solve), or None for no preconditioner."""
    if preconditioner is None or str(preconditioner).lower() == "none":
        return None
    if str(preconditioner).lower() not in _SGS_KINDS:
        raise ValueError(f"dist_padded_solve takes preconditioner 'sgs' or None, got "
                         f"{preconditioner!r}")
    extra = set(options) - {"sweeps"}
    if extra:
        raise ValueError(f"unknown SGS options {sorted(extra)}; it takes 'sweeps'")
    sweeps = int(options.get("sweeps", 4))
    if sweeps < 1:
        raise ValueError("sweeps must be >= 1")
    return sweeps


def dist_padded_spmv(op: DistPaddedDIA, x_local: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``y = A @ x``; ``x_local`` is this rank's rows."""
    lay = _layout(op, None)
    y = _product(lay, op.mesh, op.reach)(lay.pdia.to_padded(x_local))
    return lay.pdia.from_padded(y).clone()


def dist_padded_solve(
    op: DistPaddedDIA,
    b_local: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    max_iterations: int = -1,
    epsilon: float = 1e-8,
    *,
    method: str = "cg",
    preconditioner: Optional[str] = None,
    preconditioner_options: Optional[dict] = None,
) -> SolveResult:
    """Solve ``A x = b`` over the mesh by CG (``method="cg"``), with
    ``preconditioner="sgs"`` (``preconditioner_options`` ``{"sweeps": s}``,
    4 by default) or none: the keywords of the single-card ``solve``.
    ``b_local`` and ``x0`` are this rank's rows; ``epsilon`` bounds the whole
    system's true residual norm.  As on one card, SUCCESS means the true
    residual ``||b - A x||``, all-reduced, passed.  The result's ``x`` is
    this rank's rows; status, iterations and the residual are the same on
    every rank."""
    with span("solve"):
        method = method.lower()
        if method != "cg":
            raise ValueError(f"dist_padded_solve takes method 'cg', got {method!r}")
        mesh = op.mesh
        m = op.rows
        if tuple(b_local.shape) != (m,):
            raise ValueError(f"b_local has shape {tuple(b_local.shape)}; this rank holds {m} "
                             "rows")
        sweeps = _sweeps_of(preconditioner, dict(preconditioner_options or {}))
        lay = _layout(op, sweeps)
        pdia = lay.pdia
        bp = pdia.to_padded(b_local.to(op.dtype))
        x0p = pdia.to_padded(torch.zeros_like(b_local) if x0 is None else x0.to(op.dtype))
        maxiter = resolve_max_iterations(max_iterations, op.shape[0])
        matvec = _product(lay, mesh, op.reach)
        dotfn = _own_dot(lay, mesh)
        apply_ = spanned("precond_apply", _sgs_apply(lay, mesh)) if sweeps else None
        if apply_ is not None:
            res = pcg_core(matvec, apply_, dotfn, bp, x0p, epsilon, maxiter, False)
        else:
            res = cg_core(matvec, dotfn, bp, x0p, epsilon, maxiter, False)
        return dataclasses.replace(res, x=pdia.from_padded(res.x).clone())
