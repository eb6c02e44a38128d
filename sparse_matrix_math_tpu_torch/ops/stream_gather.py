"""One R-SELL routing pass: the Hopper stream-gather kernel and its plain version.

The counterpart of ``sparse_matrix_math_tpu/ops/pallas_rsell.py``.  The kernel
is ``csrc/stream_gather.cu`` (its header gives the bytes model and the
design): :func:`stream_gather` (K11, TPU ``_stream_kernel`` and
``_stream_kernel_hbm``) reads a value table, the x vector or the previous
pass's output stream, and emits a new stream whose slots are the table's
values rearranged and duplicated into the pass's bucket order
(formats/rsell.py).  Per vreg ``v`` and slot ``(p, L)`` (row ``8v + p`` and
lane ``L`` of the planes), with ``sw_bits = max(3, bitlen(8F - 1))``:

    m     = meta[8v + p, L]
    lsrc  = (m >> sw_bits) & 127
    sw    = meta[8v + p, lsrc] & (2**sw_bits - 1)
    out[(8v + p) * 128 + L] = vals[8v + p, L] * table[(base[v] + sw) * 128 + lsrc]

with the table read as 0 at and past its length (the JAX wrapper pads it with
zeros to ``x_rows * 128``, pallas_rsell.py:114).  It is the W-SELL gather
(ops/wsell_spmv.py) without the slab accumulate: each slot is one product,
rounded once, so the kernel and the plain version agree bit for bit.

The TPU's VMEM-resident and HBM-streamed variants (``_VMEM_TABLE_BYTES``,
``force_hbm``, pallas_rsell.py:80-82, 116) are one kernel here: a vreg's reads
fall into one window stack, which the 50 MB L2 holds.  The wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel or
raises.  Each launch adds one to :data:`launches`.
"""

from __future__ import annotations

import torch

from ..formats.wsell import LANE, SLAB

__all__ = ["stream_gather", "stream_gather_plain", "stream_sources", "launches",
           "reset_launch_counts"]

_DTYPES = (torch.float32, torch.float64)

# Kernel launches per wrapper, counted where the kernel is launched.
launches = {"stream_gather": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _sw_bits(window_f: int) -> int:
    return max(3, (8 * window_f - 1).bit_length())


def stream_gather_plain(base: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                        table: torch.Tensor, *, x_rows: int, window_f: int) -> torch.Tensor:
    """Plain K11: the kernel's index math in PyTorch ops, one gather of the
    zero-padded table and one multiply; returns the ``(n_vregs * 1024,)``
    stream."""
    v = int(base.shape[0])
    sw_bits = _sw_bits(window_f)
    xt = torch.zeros(x_rows * LANE, dtype=vals.dtype, device=vals.device)
    xt[:table.shape[0]] = table
    m = meta.reshape(v, 8, LANE).to(torch.int64)
    lsrc = (m >> sw_bits) & (LANE - 1)
    sw = torch.gather(m, 2, lsrc) & ((1 << sw_bits) - 1)
    idx = (base.to(torch.int64).reshape(v, 1, 1) + sw) * LANE + lsrc
    return (vals.reshape(v, 8, LANE) * xt[idx]).reshape(-1)


def stream_gather(base: torch.Tensor, meta: torch.Tensor, vals: torch.Tensor,
                  table: torch.Tensor, *, x_rows: int, window_f: int) -> torch.Tensor:
    """K11, one routing pass: gather the flat ``table`` into stream order.

    ``vals`` and ``meta`` are a pass's ``(n_vregs * 8, 128)`` planes (``vals``
    1.0 at real slots and 0 in padding), ``base`` its ``(n_vregs,)`` int32
    window-stack bases; ``x_rows`` is the rows of 128 the table pads to and
    ``window_f`` the stack width.  Returns the ``(n_vregs * 1024,)`` stream
    in the planes' dtype."""
    n_vregs = int(base.shape[0])
    devices = {t.device for t in (base, meta, vals, table)}
    if len(devices) != 1:
        raise ValueError(f"planes and table on different devices: {sorted(map(str, devices))}")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {table.device}")
    if vals.dtype != table.dtype or vals.dtype not in _DTYPES:
        raise TypeError(f"planes ({vals.dtype}) and table ({table.dtype}) must both be "
                        "float32 or both float64")
    if meta.dtype != torch.int32 or base.dtype != torch.int32:
        raise TypeError("meta and base must be int32")
    if not 1 <= window_f <= 16:
        raise ValueError(f"window_f must be in [1, 16], got {window_f}")
    if vals.shape != (n_vregs * 8, LANE) or meta.shape != vals.shape:
        raise ValueError(f"planes of shapes {tuple(vals.shape)} and {tuple(meta.shape)} for "
                         f"{n_vregs} vregs")
    if table.ndim != 1 or table.shape[0] > x_rows * LANE:
        raise ValueError(f"table of shape {tuple(table.shape)} does not fit x_rows={x_rows}")
    if not all(t.is_contiguous() for t in (base, meta, vals, table)):
        raise ValueError("planes and table must be contiguous")
    if table.device.type == "cpu":
        return stream_gather_plain(base, meta, vals, table, x_rows=x_rows, window_f=window_f)
    if n_vregs == 0:  # nothing to launch, so nothing to count
        return torch.empty(0, dtype=vals.dtype, device=vals.device)
    from . import _build

    lib = _build.library()
    fn = lib.smm_stream_gather_f32 if vals.dtype == torch.float32 else lib.smm_stream_gather_f64
    out = torch.empty(n_vregs * SLAB, dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        code = fn(vals.data_ptr(), meta.data_ptr(), base.data_ptr(), table.data_ptr(),
                  out.data_ptr(), n_vregs, table.shape[0], _sw_bits(window_f),
                  torch.cuda.current_stream().cuda_stream)
    _build.check(code, "stream_gather")
    launches["stream_gather"] += 1
    return out


def stream_sources(passes, n_cols: int, device) -> torch.Tensor:
    """The column of x that each slot of the last pass's stream carries, -1
    where it carries padding: the chain run once over the index table
    ``1 .. n_cols`` through :func:`stream_gather` (K11 on a card, one launch
    per pass; the plain version on the CPU).  The planes are taken in
    float64, where their 1.0 and 0 and every index below 2**53 are exact, so
    a slot holds its source's index + 1, or 0 in padding.  Returns an int64
    tensor of the last stream's length (``arange(n_cols)`` with no pass)."""
    if n_cols >= 1 << 53:
        raise ValueError(f"{n_cols} columns do not fit float64's exact integers")
    t = torch.arange(1, n_cols + 1, dtype=torch.float64, device=device)
    for p in passes:
        t = stream_gather(p.base, p.meta, p.vals.to(torch.float64), t, x_rows=p.x_rows,
                          window_f=p.window_f)
    return t.to(torch.int64) - 1
