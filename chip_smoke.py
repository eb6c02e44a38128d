#!/usr/bin/env python3
"""Drive the PyTorch port's DIA, general-pattern, double-word, routed and
mixed-precision solve paths and its front door once on one CUDA card.

    python3 chip_smoke.py

It builds the hand-written kernels (``csrc/dia_spmv.cu``, ``csrc/trisweep.cu``,
``csrc/sell_spmv.cu``, ``csrc/dia_spmv_df.cu``, ``csrc/stream_gather.cu``) with
nvcc, one process per source, and the native
factorizations and W-SELL / R-SELL layout routines (``csrc/smm_native.cpp``)
with g++, side by side.  Phase A holds each DIA kernel wrapper against its plain
PyTorch version on the card, in f32 and f64, at the systems the solve paths
meet (up to the 243^3 Poisson system, 14.3M rows and 100M nnz; K2/K3 bit
for bit), with
timings: the DIA SpMV kernels (K2/K3 from a captured CUDA graph, with the
kernel and tile the rule of ``ops/dia_spmv.py:staged_plan`` takes: the
staged kernel or one thread per row), then the fused SGS (K4) and IC(0)/ILU(0) (K5)
sweep applies at 1, 2 and 4 sweeps, each with the variant the rule of
``ops/trisweep.py:window_tile`` takes (halo-window kernels or the
large-reach per-sweep kernels), timed from a captured CUDA graph.  Phase B resets the launch counters,
then solves at full width through the public entry points on a CUDA
``CSRMatrix`` (auto-route to DIA, padded solve, kernel matvec), checks each
result against an independent host residual computed with scipy, and checks
the counters.  Phase P does the same for the preconditioned path: SGS,
IC(0) and ILU(0) built by ``from_matrix(csr, method="jacobi", sweeps=4)``,
every apply one launch of K4 or K5.  Phase W does both for the
general-pattern path: the JAX bench's unstructured system
(``laplace_3d_jittered(113)``, 17.5M nnz) routed to W-SELL, its IC(0)
strict factors in W-SELL, a shuffled ``poisson_2d(1414)`` routed through
RCM to W-SELL, and ELL: kernels K6 (ELL), K7 (W-SELL, one column) and K8
(2-8 columns; on the system and, at 4 columns, on both IC(0) strict
factors), one kernel over the slab-sorted SELL-32 layout derived with
each matrix, against their plain versions beside the
``torch.sparse_csr_tensor`` product, K8 also against the planes' product and
against K7 launched on each column (bit for bit, and timed), with the
layout's bound, the planes' bound, slots per nonzero and the layout's
derivation time, then the solves with the counters reset just before them,
and one panel launch serving up to 8 columns of a W-SELL or ELL ``rmult``.
Phase M does both for the multi-RHS path: ``cg_multi`` on the jittered
system through W-SELL with 4 columns in f32 and f64, and with IC(0)(4) in
f32 (K8 for the panel product and every strict-factor product), each column
held to the host's residual and to a single-column ``cg``, K8's launches to
the loop's count; and ``solve(csr, B, auto_format=True)`` on
``poisson_2d(1414)`` through the grid stencil.  Phase D does both for the
double-word path (values as pairs of float32, hi + lo): the double-word DIA
kernel K9/K10 against its plain version, both words bit for bit, on
``poisson_2d(1414)``, ``poisson_3d(243)`` and ``poisson_3d_27pt(128)``, then
``cg_df64``, ``bicgstab_df64``, ``cg_ir_df64`` and ``bicgstab_ir_df64`` with
``PaddedSGS(4)`` on the bench's systems and ``cg_df64`` on the jittered
system's ELL operator, each held to 1e-8 by a float64 host residual, with
the launch counters reset just before the solves.  Phase R does both for the
front door and the routed path: the JAX bench's zero-locality system
(``uniform_random_csr(2_000_000, per_row=5)``, 12M nnz) laid out as the routed
R-SELL chain, the stream-gather kernel K11 against its plain version on every
routing pass in f32 and f64, the whole chain (K11 per pass, then K7) beside
the port's CSR product and ``torch.sparse_csr_tensor``, then
``solve(csr, b, method="bicgstab", auto_format=True)`` in f32 and f64, which
must go through a ``RoutedMatrix``; ``solve(..., auto_format=True)`` on
``poisson_2d(1414)``, which must go through the matrix-free grid stencil, and
its pre-route to the double-word refinement at eps 1e-8 on f32 data; and
``bicg_symmetric`` and ``cgs`` on the padded path.  Phase H does both for
the mixed-precision path: K2's bfloat16-diagonal instantiation against its
plain version (bit for bit, guard rows 0) on ``poisson_2d(1414)`` and
``poisson_3d_27pt(128)``, timed from a CUDA graph beside float32 K2, then
``mixed_cg`` on each (b = A @ ones; epsilon 1.05 x plain ``cg``'s true
residual, and 1e-4 * ||b||) held to the host's float64 residual, with the
counters reset just before it (K2-bf16 launches at least the inner
iterations, float32 K2 launches 1 + 2 x rounds), beside plain ``cg`` at the
same epsilon (wall, device time per iteration), and ``solve(csr, b,
auto_format=True, matrix_dtype="bfloat16")``, which must keep DIA and warn
on the 5-point stencil only.  Phase G runs the solver tail.  Phase U drives
the last single-process modules at the bench system's size: ``spmv_throughput``
for CSR, DIA (K1), ELL (K6), W-SELL (K7) and phase R's routed chain (K11,
then K7), each beside the same product's CUDA-graph time, ``solve_with_stats``
beside a plain ``cg``, ``checkpointed_solve`` stopped after two chunks and
resumed from its file against an uninterrupted run, ``trace`` (its Chrome
trace must name K2), the command line (``python -m
sparse_matrix_math_tpu_torch info / solve / bench-spmv --routed``) on a
``.mtx`` written in the run, and the six ``examples/torch_*.py`` at their
default sizes.  Phase C solves a small system and compares
the solution with scipy's direct solve.  Phase X drives the distributed
layer (``parallel/``) in a world of one rank over NCCL at the same sizes:
``dist_solve`` on ``poisson_2d(1414)`` in halo mode (CG in f32 and f64,
BiCGStab + distributed SGS(4) in f64), ``dist_dia_solve`` (CG f32, f64),
``dist_stencil_solve`` (CG f64) and ``dist_wsell_solve`` on the jittered
system (CG f32, K7 in the shard: one launch per product, one shard product
bit for bit its plain version), each held to the single-device solve of the
same system (status, iterations, the host's float64 residual) with wall and
device microseconds per iteration and collectives per iteration beside it;
then ``examples/torch_distributed_solve.py`` under ``torch.distributed.run``
and, as a CPU run, at ``--cpu 2``.

Prints the card's name and power limit, a JSON line of the kernels, and
last ``{"ok": true, "device": {...}}``.  Any failed check exits nonzero
without that last line; so does a machine without a CUDA card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

_ROOT = os.path.dirname(os.path.abspath(__file__))
_PALLAS = "sparse_matrix_math_tpu/ops/pallas_spmv.py"
_SOURCE = "sparse_matrix_math_tpu_torch/csrc/dia_spmv.cu"
_TRI_PALLAS = "sparse_matrix_math_tpu/ops/pallas_trisweep.py"
_TRI_SOURCE = "sparse_matrix_math_tpu_torch/csrc/trisweep.cu"
_WSELL_PALLAS = "sparse_matrix_math_tpu/ops/pallas_wsell.py"
_SELL_SOURCE = "sparse_matrix_math_tpu_torch/csrc/sell_spmv.cu"
_DF_SOURCE = "sparse_matrix_math_tpu_torch/csrc/dia_spmv_df.cu"
_RSELL_PALLAS = "sparse_matrix_math_tpu/ops/pallas_rsell.py"
_STREAM_SOURCE = "sparse_matrix_math_tpu_torch/csrc/stream_gather.cu"
# the card's memory rate, for each kernel's bound: bytes / rate (H100 SXM
# data sheet; the kernels here are bound by bytes, not operations)
_HBM_BYTES_PER_S = 3.35e12
_SWEEPS = (1, 2, 4)
# relative error bounds of kernel against plain version: the summation
# order is the same, so these hold with a wide margin (the kernel rounds
# every product and sum as the plain version does and is expected exact)
_TOL = {"float32": 1e-6, "float64": 1e-14}


class CheckFailed(Exception):
    pass


def require(cond: bool, msg: str, quiet: bool = False) -> None:
    """Raise CheckFailed unless ``cond``; print the passed check unless ``quiet``."""
    if not cond:
        raise CheckFailed(msg)
    if not quiet:
        print(f"  ok: {msg}")


def bound_ms(nbytes: int) -> float:
    """The least time the card takes to move ``nbytes`` of device memory."""
    return nbytes / _HBM_BYTES_PER_S * 1e3


def k2_bytes(p, x_itemsize: int) -> int:
    """Device bytes one K2/K3 product must move, in every dtype: each active
    row's diagonal values and x once, y written over the whole layout
    (guard rows are written as zeros)."""
    n = p.shape[0]
    return (len(p.offsets) * n * p.diags_p.element_size() + n * x_itemsize
            + p.n_total * x_itemsize)


def library_csr(torch, data, indices, indptr, shape):
    """The same matrix as ``torch.sparse_csr_tensor``, the yardstick whose
    ``@`` is timed beside a kernel (the port never calls it)."""
    return torch.sparse_csr_tensor(indptr.to(torch.int32), indices.to(torch.int32), data,
                                   size=shape)


def median_ms(fn, samples: int = 11, calls: int = 20) -> float:
    """Median over ``samples`` of the mean time of ``calls`` back-to-back
    calls between two CUDA events: the queue stays full, so the host's
    launch cost is hidden as it is inside a solve."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_a(smm, K, torch, dev):
    """Kernels against their plain versions."""
    print("== phase A: kernels against plain versions")
    systems = [
        ("poisson_2d(1414)", smm.poisson_2d, (1414,)),
        ("poisson_3d(243)", smm.poisson_3d, (243,)),
        ("poisson_3d_27pt(128)", smm.poisson_3d_27pt, (128,)),
        ("convection_diffusion_2d(1414)", smm.convection_diffusion_2d, (1414,)),
    ]
    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {k: {"err": 0.0} for k in ("dia_spmv", "dia_spmv_padded", "sgs_apply",
                                        "tri_pair_apply")}
    stats["dia_spmv_padded"]["cases"] = {}
    for label, make, args in systems:
        t0 = time.perf_counter()
        csr = make(*args, device=dev)
        dia64 = smm.dia_from_csr(csr)
        print(f"{label}: n={dia64.shape[0]} ndiags={len(dia64.offsets)} nnz={dia64.nnz} "
              f"(built in {time.perf_counter() - t0:.1f} s)")
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            a = dia64.astype(dtype)
            n_rows, n_cols = a.shape
            x = torch.rand(n_cols, generator=gen, device=dev, dtype=torch.float64).to(dtype) - 0.5
            p = K.pad_dia(a)
            xp = p.to_padded(x)
            before = dict(K.launches)
            cases = {
                "dia_spmv": (lambda: K.dia_spmv(a, x),
                             lambda: K.dia_spmv_plain(a.diags, a.offsets, a.shape, x)),
                "dia_spmv_padded": (
                    lambda: K.dia_spmv_padded(p, xp),
                    lambda: K.dia_spmv_padded_plain(p.diags_p, p.offsets, p.lead, n_rows, xp)),
            }
            if label.startswith("poisson_3d(243)"):
                # the TPU's streamed size: the same kernel under its K3 name
                cases["dia_spmv_streamed"] = (
                    lambda: K.dia_spmv_streamed(p, xp), cases["dia_spmv_padded"][1])
            for kname, (kern, plain) in cases.items():
                y, y_ref = kern(), plain()
                torch.cuda.synchronize()
                abs_err = (y - y_ref).abs().max().item()
                rel_err = abs_err / max(y_ref.abs().max().item(), 1e-300)
                if kname == "dia_spmv":
                    require(bool(torch.isfinite(y).all()) and rel_err <= _TOL[name],
                            f"{kname} {name}: max rel err {rel_err:.3e} <= {_TOL[name]:.0e}"
                            f" (max abs err {abs_err:.3e})")
                else:
                    # K2/K3: the kernel the rule took, bit for bit its plain version
                    require(bool(torch.isfinite(y).all()) and bits_equal(torch, y, y_ref),
                            f"{kname} {name}: bit for bit its plain version (max rel err "
                            f"{rel_err:.3e}, max abs err {abs_err:.3e})")
                    lead = p.lead
                    require(bool((y[:lead] == 0).all()) and bool((y[lead + n_rows:] == 0).all()),
                            f"{kname} {name}: guard rows exactly 0")
                bucket = "dia_spmv" if kname == "dia_spmv" else "dia_spmv_padded"
                stats[bucket]["err"] = max(stats[bucket]["err"], abs_err)
                plain_ms = median_ms(plain)
                if kname == "dia_spmv":
                    # K1 from a CUDA graph, the wrapper beside it
                    ms, wrapper_ms = graph_ms(torch, kern), median_ms(kern)
                    nbytes = (len(a.offsets) + 2) * n_rows * a.diags.element_size()
                    extra = {"wrapper_ms": wrapper_ms}
                    print(f"  {kname} {name}: graph {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s, "
                          f"{100 * bound_ms(nbytes) / ms:.0f}% of the {bound_ms(nbytes):.4f} ms "
                          f"bound), through the wrapper {wrapper_ms:.4f} ms, plain "
                          f"{plain_ms:.4f} ms")
                else:
                    # K2/K3 from a CUDA graph, the wrapper beside it; the
                    # kernel and tile the rule of ops/dia_spmv.py staged_plan took
                    ms, wrapper_ms = graph_ms(torch, kern), median_ms(kern)
                    nbytes = k2_bytes(p, a.diags.element_size())
                    extra = {"wrapper_ms": wrapper_ms, "variant": K.variant(p, dev)}
                    print(f"  {kname} {name}: {extra['variant']}: graph {ms:.4f} ms "
                          f"({nbytes / ms / 1e6:.1f} GB/s, {100 * bound_ms(nbytes) / ms:.0f}% "
                          f"of the {bound_ms(nbytes):.4f} ms bound), through the wrapper "
                          f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms")
                    stats[bucket]["cases"][f"{kname} {label} {name}"] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes), **extra}
                if label == "poisson_2d(1414)" and name == "float32" and kname in stats:
                    stats[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                                        **extra)
            if name == "float32" and label in ("poisson_2d(1414)", "poisson_3d(243)"):
                lib = library_csr(torch, csr.data.to(dtype), csr.indices, csr.indptr, csr.shape)
                lib_ms = median_ms(lambda: lib @ x)
                print(f"  torch.sparse_csr_tensor @ x {name}: {lib_ms:.4f} ms")
                if label == "poisson_2d(1414)":
                    for kname in ("dia_spmv", "dia_spmv_padded"):
                        stats[kname]["library_ms"] = lib_ms
                del lib
            for kname in ("dia_spmv", "dia_spmv_padded"):
                require(K.launches[kname] > before[kname], f"{kname} {name}: launch counter rose")
            del a, p, x, xp
        sweep_cases(smm, torch, dev, label, csr, dia64, stats)
        del csr, dia64
        torch.cuda.empty_cache()
    return stats


def apply_bytes(pre, sgs: bool, itemsize: int) -> int:
    """Device bytes one apply must move, each input read once and the
    output written once: r, the inverse diagonal (one for SGS, two for a
    factor pair), D (SGS), the strict L and U diagonals, and z."""
    nd = sum(0 if p is None else len(p.offsets) for p in (pre.p_lower, pre.p_upper))
    return (nd + 4) * pre.shape[0] * itemsize


def traffic_bytes(pre, sgs: bool, itemsize: int, variant: str) -> int:
    """Device bytes one apply moves by a design's traffic model.  The
    per-sweep kernels (the large-reach variant, and K4/K5 before the window
    kernels): per direction the init step reads the rhs and the inverse
    diagonal and writes x, and each of the sweeps - 1 sweeps reads the
    strict diagonals, the rhs, the inverse diagonal and x and writes x;
    SGS's middle scale also reads D and writes the scaled rhs.  The window
    kernels: per direction the rhs, the inverse diagonal, the strict
    diagonals (where there is a sweep) and, backward in SGS, D are read once
    and x is written once; the forward result is read back by the backward
    launch (halo rows read again by a neighbouring tile not counted)."""
    per_row = 0
    for p, mid in ((pre.p_lower, False), (pre.p_upper, sgs)):
        nd = 0 if p is None else len(p.offsets)
        if variant == "window":
            per_row += 3 + (nd if nd and pre.sweeps > 1 else 0) + mid
        else:
            per_row += 3 + 2 * mid + (0 if p is None else (pre.sweeps - 1) * (nd + 4))
    return per_row * pre.shape[0] * itemsize


def graph_ms(torch, fn, calls: int = 20, samples: int = 5) -> float:
    """Median over ``samples`` replays of a CUDA graph that captured
    ``calls`` calls of ``fn``, per call: the kernels' own time, without the
    host's dispatch between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: builds, opts in to shared memory, fills the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def sweep_cases(smm, torch, dev, label, csr, dia64, stats):
    """K4 and K5 against their plain versions at 1, 2 and 4 sweeps: SGS on
    every system, IC(0) on the symmetric ones but the 14.3M-row system, and
    ILU(0) on the same ones and the convection-diffusion system."""
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.precond import PaddedSGS, PaddedTriPair

    cases = [("sgs_apply", "sgs", lambda: PaddedSGS.from_dia(dia64, sweeps=1))]
    if not label.startswith("poisson_3d("):

        def pair(kind):
            t0 = time.perf_counter()
            # the padded layout alone is checked here, so the factors skip
            # the W-SELL layout of their strict parts (phase W times it)
            fac = smm.get_preconditioner(csr, kind, method="jacobi", sweeps=1,
                                         strict_layout="csr")
            out = PaddedTriPair.from_factors(fac.lower, fac.upper, dia64)
            print(f"  {kind} factors of {label} on the host in "
                  f"{time.perf_counter() - t0:.2f} s")
            return out

        kinds = ["ilu0"] if label.startswith("convection") else ["ic0", "ilu0"]
        cases += [("tri_pair_apply", k, lambda k=k: pair(k)) for k in kinds]
    fns = {"sgs_apply": (T.sgs_apply_fused, T.sgs_apply_plain),
           "tri_pair_apply": (T.tri_pair_apply_fused, T.tri_pair_apply_plain)}
    gen = torch.Generator(device=dev).manual_seed(1)
    for kname, kind, build in cases:
        fused, plain = fns[kname]
        pre64 = build()
        for dtype in (torch.float32, torch.float64):
            name = str(dtype).removeprefix("torch.")
            base = pre64.astype(dtype)
            n_rows = base.shape[0]
            rp = torch.zeros(base.n_total, dtype=dtype, device=dev)
            rp[base.lead:base.lead + n_rows] = (
                torch.rand(n_rows, generator=gen, device=dev, dtype=torch.float64) - 0.5
            ).to(dtype)
            for sweeps in _SWEEPS:
                pre = dataclasses.replace(base, sweeps=sweeps)
                before = T.launches[kname]
                z, z_ref = fused(pre, rp), plain(pre, rp)
                torch.cuda.synchronize()
                abs_err = (z - z_ref).abs().max().item()
                tag = f"{kname} {kind} {name} sweeps={sweeps}"
                require(bool(torch.isfinite(z).all()) and abs_err == 0.0,
                        f"{tag}: max abs err {abs_err:.3e} == 0")
                require(bool((z[:pre.lead] == 0).all())
                        and bool((z[pre.lead + n_rows:] == 0).all()),
                        f"{tag}: guard rows exactly 0")
                require(T.launches[kname] == before + 1, f"{tag}: launch counter rose")
                stats[kname]["err"] = max(stats[kname]["err"], abs_err)
                variant = T.variant(pre, dev)
                stats[kname].setdefault("variants", {})[f"{label} {kind} {name} "
                                                         f"sweeps={sweeps}"] = variant
                if sweeps != 4:
                    continue  # timed at the main path's sweep count
                sgs = kname == "sgs_apply"
                ms = graph_ms(torch, lambda: fused(pre, rp))
                wrapper_ms = median_ms(lambda: fused(pre, rp), samples=5, calls=10)
                plain_ms = median_ms(lambda: plain(pre, rp), samples=5, calls=10)
                nbytes = apply_bytes(pre, sgs, rp.element_size())
                moved = traffic_bytes(pre, sgs, rp.element_size(), variant)
                b_ms = bound_ms(nbytes)
                print(f"  {tag}: {variant} kernels {ms:.4f} ms from a CUDA graph "
                      f"({100 * b_ms / ms:.0f}% of the {b_ms:.4f} ms bound, {nbytes / 1e6:.0f} "
                      f"MB; the design's traffic {moved / 1e6:.0f} MB, {moved / ms / 1e6:.1f} "
                      f"GB/s), through the wrapper {wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms")
                if label == "poisson_2d(1414)" and name == "float32" and kind != "ilu0":
                    # no single PyTorch call computes a Jacobi-sweep apply
                    stats[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                        library_ms=None, wrapper_ms=wrapper_ms,
                                        traffic_bound_ms=bound_ms(moved))
            del base, rp, z, z_ref
        del pre64


def host_residuals(csr, b, x, precond=None):
    """||b - A x|| on the host with scipy: in float64, and in the solve's
    own precision (scipy's CSR product sums each row in ascending column
    order, the kernel's order).  With ``precond``, the norms are of
    ``precond(b - A x)``: what a preconditioned BiCGStab reports."""
    import numpy as np
    import scipy.sparse as sp

    data = csr.data.cpu().numpy()
    shape = csr.shape
    a = sp.csr_matrix((data, csr.indices.cpu().numpy(), csr.indptr.cpu().numpy()), shape=shape)
    b_h, x_h = b.cpu().numpy(), x.cpu().numpy()
    r64 = b_h.astype(np.float64) - a.astype(np.float64) @ x_h.astype(np.float64)
    r_same = b_h - a @ x_h
    if precond is not None:
        r64, r_same = precond(r64), precond(r_same)
    return (float(np.linalg.norm(r64)), float(np.linalg.norm(r_same.astype(np.float64))))


def plain_precond(T, pre, op):
    """r -> M^{-1} r on the card by the plain version of the kernel that the
    padded solve of ``op`` runs for ``pre``, in ``op``'s precision; host
    arrays in and out.  The plain version counts no launches."""
    import numpy as np
    import torch

    from sparse_matrix_math_tpu_torch.precond import PaddedSGS
    from sparse_matrix_math_tpu_torch.solvers._padded import padded_preconditioner

    pre = padded_preconditioner(pre, op)
    plain = T.sgs_apply_plain if isinstance(pre, PaddedSGS) else T.tri_pair_apply_plain
    rows = slice(pre.lead, pre.lead + op.shape[0])

    def apply(r: np.ndarray) -> np.ndarray:
        rp = torch.zeros(pre.n_total, dtype=op.dtype, device=op.device)
        rp[rows] = torch.as_tensor(r, device=op.device).to(op.dtype)
        return plain(pre, rp)[rows].cpu().numpy()

    return apply


def solve_and_check(smm, loop, torch, dev, label, solver, csr, x_true, kw, launches, kname,
                    per_iteration, precond=None, may_diverge=False):
    """Solve ``csr x = A @ x_true`` twice through the public entry (the
    second run is timed warm), hold the result against the host residual
    (of ``precond(b - A x)`` when given), and check that kernel ``kname``
    launched at least ``per_iteration`` times per iteration in the timed
    run.  ``x_true`` None means ones.  With ``may_diverge`` a DIVERGED
    status passes when the returned best iterate cut the residual 1000-fold.
    Returns the result and the warm run's wall seconds."""
    op = smm.auto_route_for_solve(csr)
    require(isinstance(op, smm.DIAMatrix), f"{label}: CSR auto-routed to DIA")
    x_true = (torch.ones(csr.shape[0], dtype=csr.dtype, device=dev) if x_true is None
              else torch.as_tensor(x_true, device=dev).to(csr.dtype))
    b = op @ x_true
    walls = []
    for _ in range(2):
        before = launches[kname]
        syncs0 = loop.host_syncs["count"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver(csr, b, **kw)
        float(res.residual_norm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched = launches[kname] - before
        syncs = loop.host_syncs["count"] - syncs0
    status = res.status_enum()
    reported = float(res.residual_norm)
    true64, same = host_residuals(csr, b, res.x, precond)
    its = res.iterations
    print(f"{label}: {status.name} iterations={its} floor_hit={res.floor_hit} "
          f"residual_norm={reported:.6e} host f64 {true64:.6e} host same-precision "
          f"{same:.6e}; wall {walls[0]:.4f} s then {walls[1]:.4f} s, "
          f"{1e6 * walls[1] / max(its, 1):.2f} us/iteration, {syncs} host syncs, "
          f"{launched} {kname} launches")
    f64 = csr.dtype == torch.float64
    ok_status = status == smm.SolverStatus.SUCCESS or (
        not f64 and status == smm.SolverStatus.MAX_ITERATIONS_REACHED and res.floor_hit)
    if may_diverge and status == smm.SolverStatus.DIVERGED:
        initial = host_residuals(csr, b, torch.zeros_like(b), precond)[1]
        ok_status = reported <= 1e-3 * initial
        print(f"  {label}: DIVERGED, best iterate {reported:.4e} from {initial:.4e}")
    require(ok_status, f"{label}: status {status.name} (floor_hit={res.floor_hit})")
    require(tuple(res.x.shape) == (csr.shape[0],) and bool(torch.isfinite(res.x).all()),
            f"{label}: x finite, shape {tuple(res.x.shape)}")
    # In f64 the host's float64 residual is the reference.  An f32
    # residual evaluation carries rounding noise of ~sqrt(n) * 1e-7
    # (~1e-4 at n=2M, the size of eps itself), so an f32 solve is held
    # to the host residual evaluated in float32 and its float64 one is
    # printed beside it.
    ref, ref_name = (true64, "float64") if f64 else (same, "float32")
    require(abs(reported - ref) <= 0.01 * ref,
            f"{label}: residual_norm within 1% of the host {ref_name} residual "
            f"(float64 one {true64:.6e}, {100 * (reported - true64) / true64:+.2f}%)")
    require(launched >= per_iteration * its,
            f"{label}: {launched} {kname} launches >= {per_iteration} x {its} iterations")
    return res, walls[1]


def phase_b(smm, K, loop, torch, dev):
    """The main path at full width: CSR -> auto-route -> DIA -> padded solve."""
    import numpy as np

    print("== phase B: solves at full width through the public entry points")
    K.reset_launch_counts()
    p32 = smm.poisson_2d(1414, dtype=torch.float32, device=dev)
    cd32 = smm.convection_diffusion_2d(1414, dtype=torch.float32, device=dev)
    p64 = smm.poisson_2d(1414, dtype=torch.float64, device=dev)
    # b = A @ x_true.  CG takes the bench's all-ones x_true.  Plain BiCGStab
    # on the convection-diffusion system is unstable: at this size b = A @ ones
    # makes it explode (DIVERGED) in f32 and f64, as it does in both packages
    # in f64 at n=400 on the CPU, and a uniform [0, 1) x_true does in f32.
    # A standard-normal x_true made from a seed reaches the f32 floor and
    # converges in f64.
    x_rand = np.random.default_rng(0).standard_normal(cd32.shape[0])
    cd64 = smm.convection_diffusion_2d(1414, dtype=torch.float64, device=dev)
    solves = [
        ("cg poisson_2d(1414) f32", smm.cg, p32, None, dict(epsilon=1e-4, max_iterations=6000)),
        ("cg+jacobi poisson_2d(1414) f32", smm.cg, p32, None,
         dict(epsilon=1e-4, max_iterations=6000,
              preconditioner=smm.JacobiPreconditioner.from_matrix(p32))),
        ("bicgstab convection_diffusion_2d(1414) f32", smm.bicgstab, cd32, x_rand,
         dict(epsilon=1e-4, max_iterations=6000)),
        ("cg poisson_2d(1414) f64", smm.cg, p64, None, dict(epsilon=1e-8, max_iterations=20000)),
        ("bicgstab convection_diffusion_2d(1414) f64", smm.bicgstab, cd64, x_rand,
         dict(epsilon=1e-8, max_iterations=20000)),
    ]
    solved = {}
    for label, solver, csr, x_true, kw in solves:
        res, wall = solve_and_check(smm, loop, torch, dev, label, solver, csr, x_true, kw,
                                    K.launches, "dia_spmv_padded", 1)
        solved[label] = (res.iterations, wall)
    counts = dict(K.launches)
    for kname in ("dia_spmv", "dia_spmv_padded"):
        require(counts[kname] > 0, f"main path launched {kname} {counts[kname]} times")
    return counts, solved



def phase_p(smm, K, T, loop, torch, dev):
    """The preconditioned path at full width: CSR -> auto-route -> DIA ->
    padded solve, every SGS apply one K4 launch and every IC(0)/ILU(0)
    apply one K5 launch."""
    import numpy as np

    from sparse_matrix_math_tpu_torch.precond import PaddedSGS

    print("== phase P: preconditioned solves at full width through the public entry points")
    K.reset_launch_counts()
    T.reset_launch_counts()
    p32 = smm.poisson_2d(1414, dtype=torch.float32, device=dev)
    p64 = smm.poisson_2d(1414, dtype=torch.float64, device=dev)
    cd32 = smm.convection_diffusion_2d(1414, dtype=torch.float32, device=dev)
    cd64 = smm.convection_diffusion_2d(1414, dtype=torch.float64, device=dev)

    def build(cls, csr, label):
        t0 = time.perf_counter()
        pre = cls.from_matrix(csr, method="jacobi", sweeps=4)
        print(f"{cls.__name__}.from_matrix({label}, method='jacobi', sweeps=4) in "
              f"{time.perf_counter() - t0:.2f} s")
        return pre

    sgs32 = build(smm.SGSPreconditioner, p32, "poisson_2d(1414) f32")
    sgs64 = build(smm.SGSPreconditioner, p64, "poisson_2d(1414) f64")
    ic32 = build(smm.IC0Preconditioner, p32, "poisson_2d(1414) f32")
    ic64 = build(smm.IC0Preconditioner, p64, "poisson_2d(1414) f64")
    ilu32 = build(smm.ILU0Preconditioner, cd32, "convection_diffusion_2d(1414) f32")
    ilu64 = build(smm.ILU0Preconditioner, cd64, "convection_diffusion_2d(1414) f64")
    # the bench's form: a PaddedSGS built from the routed DIA matrix
    psgs = PaddedSGS.from_dia(smm.auto_route_for_solve(p32), sweeps=4)
    f32 = dict(epsilon=1e-4, max_iterations=6000)
    f64 = dict(epsilon=1e-8, max_iterations=20000)
    # BiCGStab+ILU(0)(4) on convection-diffusion with b = A @ ones diverges
    # within 100 iterations in f32 and f64 on the card; a standard-normal
    # x_true made from a seed reaches the f32 floor and converges in f64.
    x_cd = np.random.default_rng(0).standard_normal(cd32.shape[0])
    # The bench's f32 BiCGStab+SGS(4) at eps 1e-4 diverges (explodes out of
    # its f32 stagnation) after ~1136 iterations, on the card and in the
    # JAX package on the CPU (1137 iterations): it may end DIVERGED, held to
    # an honest best iterate.  Its f64 twin must succeed.
    solves = [
        ("bicgstab+sgs(4) poisson_2d(1414) f32", smm.bicgstab, p32, None, sgs32, f32,
         "sgs_apply", True),
        ("bicgstab+PaddedSGS(4) poisson_2d(1414) f32", smm.bicgstab, p32, None, psgs, f32,
         "sgs_apply", True),
        ("bicgstab+sgs(4) poisson_2d(1414) f64", smm.bicgstab, p64, None, sgs64, f64,
         "sgs_apply", False),
        ("cg+sgs(4) poisson_2d(1414) f32", smm.cg, p32, None, sgs32, f32, "sgs_apply", False),
        ("cg+ic0(4) poisson_2d(1414) f32", smm.cg, p32, None, ic32, f32, "tri_pair_apply",
         False),
        ("cg+ic0(4) poisson_2d(1414) f64", smm.cg, p64, None, ic64, f64, "tri_pair_apply",
         False),
        ("bicgstab+ilu0(4) convection_diffusion_2d(1414) f32", smm.bicgstab, cd32, x_cd, ilu32,
         f32, "tri_pair_apply", False),
        ("bicgstab+ilu0(4) convection_diffusion_2d(1414) f64", smm.bicgstab, cd64, x_cd, ilu64,
         f64, "tri_pair_apply", False),
    ]
    results = {}
    for label, solver, csr, x_true, pre, kw, kname, may_diverge in solves:
        # BiCGStab reports the norm of the preconditioned residual, CG the
        # plain one
        bicg = solver is smm.bicgstab
        precond = plain_precond(T, pre, smm.auto_route_for_solve(csr)) if bicg else None
        results[label], _ = solve_and_check(
            smm, loop, torch, dev, label, solver, csr, x_true, dict(kw, preconditioner=pre),
            T.launches, kname, 2 if bicg else 1, precond, may_diverge)
    via_sgs, direct = (results[f"bicgstab+{k}(4) poisson_2d(1414) f32"] for k in ("sgs", "PaddedSGS"))
    require(direct.status == via_sgs.status and direct.iterations == via_sgs.iterations
            and bool(torch.equal(direct.x, via_sgs.x)),
            "a PaddedSGS passed in directly solves exactly as the SGSPreconditioner it re-lays")
    counts = {**K.launches, **T.launches}
    for kname in ("dia_spmv_padded", "sgs_apply", "tri_pair_apply"):
        require(counts[kname] > 0, f"preconditioned path launched {kname} {counts[kname]} times")
    return counts

def wsell_bytes(ws, k: int, itemsize: int, per_vreg: int = 8) -> int:
    """K7/K8's bytes model: each slot's value and meta word, ``per_vreg``
    bytes of base/slab per vreg, x and y once per column."""
    n_rows, n_cols = ws.shape
    return ws.n_vregs * (1024 * (itemsize + 4) + per_vreg) + k * (n_cols + n_rows) * itemsize


def ell_bytes(ell, itemsize: int) -> int:
    """The ELL planes' bytes model (what a kernel over the planes reads):
    each slot's value and int32 column, x and y once."""
    return ell.rows_padded * ell.slots * (itemsize + 4) + sum(ell.shape) * itemsize


def sell_bytes(s, itemsize: int, padded: bool = False, k: int = 1) -> int:
    """K6's, K7's and (``k`` columns) K8's bytes model over the slab-sorted
    SELL-32 layout: each stored entry's value and column word, the chunk
    pointers and the row map once, X and Y once.  ``padded`` counts every
    slot of the layout, its padding too: what the kernel reads, where the
    function needs the entries."""
    entries = s.n_slots if padded else s.nnz
    return (entries * (itemsize + 4) + s.chunk_ptr.numel() * 8 + s.row_of.numel() * 2
            + k * sum(s.shape) * itemsize)


def bits_equal(torch, a, b) -> bool:
    """Bit for bit, the sign of a zero included."""
    word = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(a.view(word),
                                                                          b.view(word)))


def sell_layout_info(smm, torch, a, planes_bytes: int) -> dict:
    """What the slab-sorted SELL-32 layout of an ELL or W-SELL matrix costs:
    slots per nonzero beside the planes' ratio, the bytes it adds on the
    device, the bytes the kernel reads over it (padding slots included), the
    planes' bound, and the seconds its derivation takes on the
    card (derived again here from the planes, where a padding slot is told
    from a stored zero by rule; ``same_as_built`` says whether that gives the
    layout the builder made)."""
    from sparse_matrix_math_tpu_torch.formats import sell as S

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if isinstance(a, smm.ELLMatrix):
        again = S.sell_from_ell(a.vals, a.cols, a.shape, a.nnz)
        ratio = a.rows_padded * a.slots / max(a.nnz, 1)
    else:
        again = S.sell_from_wsell(a.vals, a.meta, a.base, a.slab, a.shape, a.nnz,
                                  max(3, (8 * a.window_f - 1).bit_length()), a.nway)
        ratio = a.slot_ratio
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    same = all(bool(torch.equal(getattr(again, f), getattr(a.sell, f)))
               for f in ("vals", "cols", "chunk_ptr", "row_of"))
    return {"slots_per_nonzero": a.sell.slots_per_nonzero, "planes_slots_per_nonzero": ratio,
            "layout_device_bytes": a.sell.device_bytes,
            "layout_bytes": sell_bytes(a.sell, a.sell.vals.element_size(), padded=True),
            "layout_build_s": build_s,
            "same_as_built": same, "planes_bound_ms": bound_ms(planes_bytes)}


def kernel_case(torch, stats, key, label, kern, plain, lib, nbytes, n_rows, counter, calls=20,
                planes_plain=None, info=None):
    """One kernel against its plain version on the card, timed beside its
    bound and the library call; one printed line.  Expects bit equality, and
    equality with ``planes_plain`` (the planes' product) where given.
    Returns the case's numbers."""
    before = counter()
    y, y_ref = kern(), plain()
    torch.cuda.synchronize()
    err = (y - y_ref).abs().max().item()
    require(counter() == before + 1, f"{label}: launch counter rose", quiet=True)
    require(y.shape[0] == n_rows and bool(torch.isfinite(y).all()) and err == 0.0
            and bits_equal(torch, y, y_ref),
            f"{label}: {n_rows} finite rows, bit for bit its plain version", quiet=True)
    if planes_plain is not None:
        require(bool(torch.equal(y, planes_plain())),
                f"{label}: equal to the planes' plain version", quiet=True)
    ms = median_ms(kern, calls=calls)
    plain_ms = median_ms(plain, samples=3, calls=2)
    lib_ms = median_ms(lib, calls=calls)
    b_ms = bound_ms(nbytes)
    info = dict(info or {})
    extra = "".join(f", {k} {v:.4g}" if isinstance(v, float) else f", {k} {v}"
                    for k, v in info.items())
    print(f"  {label}: err 0, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
          f"{100 * b_ms / ms:.0f}% of the {b_ms:.4f} ms bound), plain {plain_ms:.3f} ms, "
          f"torch.sparse_csr_tensor {lib_ms:.4f} ms{extra}")
    entry = stats.setdefault(key, {"err": 0.0})
    entry["err"] = max(entry["err"], err)
    if "ms" not in entry:  # the first case of each kernel is its main-path shape
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, library_ms=lib_ms, **info)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "library_ms": lib_ms}


def general_solve(smm, loop, torch, label, solver, a, b, csr, kw, launches, kname,
                  per_iteration, route=None):
    """Solve through the public entry twice (the second timed warm); hold
    the status, the residual against scipy's host residual on ``csr`` and
    the launches of ``kname`` per iteration.  One printed line."""
    walls = []
    for _ in range(2):
        before = launches[kname]
        syncs0 = loop.host_syncs["count"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solver(a, b, **kw)
        float(res.residual_norm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched, syncs = launches[kname] - before, loop.host_syncs["count"] - syncs0
    if route is not None:
        require(isinstance(smm.auto_route_for_solve(
            csr, has_preconditioner="preconditioner" in kw), route),
            f"{label}: routed to {route.__name__}", quiet=True)
    status, its = res.status_enum(), res.iterations
    reported = float(res.residual_norm)
    true64, same = host_residuals(csr, b, res.x)
    f64 = b.dtype == torch.float64
    ref = true64 if f64 else same
    print(f"{label}: {status.name} iterations={its} residual_norm={reported:.6e} host f64 "
          f"{true64:.6e} same-precision {same:.6e}; wall {walls[0]:.3f} s then "
          f"{walls[1]:.4f} s, {1e6 * walls[1] / max(its, 1):.1f} us/iteration, {syncs} host "
          f"syncs, {launched} {kname} launches")
    require(status == smm.SolverStatus.SUCCESS, f"{label}: status {status.name}", quiet=True)
    require(tuple(res.x.shape) == (csr.shape[0],) and bool(torch.isfinite(res.x).all()),
            f"{label}: x finite, shape {tuple(res.x.shape)}", quiet=True)
    require(abs(reported - ref) <= 0.01 * ref,
            f"{label}: residual_norm {reported:.6e} within 1% of the host {ref:.6e}", quiet=True)
    require(launched >= per_iteration * its,
            f"{label}: {launched} {kname} launches >= {per_iteration} x {its}", quiet=True)
    return res


def phase_w(smm, loop, torch, dev, cg_f64_its):
    """The general-pattern path at full width: the JAX bench's unstructured
    system (laplace_3d_jittered(113), 1.44M rows, 17.5M nnz) through W-SELL,
    its IC(0) strict factors through W-SELL, a shuffled poisson_2d(1414)
    through RCM + W-SELL, ELL; kernels K6-K8 against their plain versions,
    then the solves with every launch counter reset just before them."""
    import numpy as np

    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import sell_spmv as S
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    print("== phase W: general patterns (W-SELL K7/K8, RCM, ELL K6) at full width")
    t0 = time.perf_counter()
    jit = {dt: smm.laplace_3d_jittered(113, symmetric=True, shift=0.25, dtype=dt, device=dev)
           for dt in (torch.float32, torch.float64)}
    t1 = time.perf_counter()
    ws = {dt: smm.auto_route_for_solve(c) for dt, c in jit.items()}  # cached for the solves
    t2 = time.perf_counter()
    ic = {dt: smm.IC0Preconditioner.from_matrix(c, method="jacobi", sweeps=4)
          for dt, c in jit.items()}
    t3 = time.perf_counter()
    ell = {dt: smm.ell_from_csr(c) for dt, c in jit.items()}
    t4 = time.perf_counter()
    p64 = smm.poisson_2d(1414, dtype=torch.float64, device=dev)
    shuffled = smm.permute_csr(p64, np.random.default_rng(0).permutation(p64.shape[0]))
    del p64
    t5 = time.perf_counter()
    ro = smm.auto_route_for_solve(shuffled)  # DIA and W-SELL refuse, RCM + W-SELL packs
    t6 = time.perf_counter()
    w32, w64 = ws[torch.float32], ws[torch.float64]
    lower32 = ic[torch.float32].lower
    require(isinstance(w32, smm.WSellMatrix) and isinstance(w64, smm.WSellMatrix)
            and isinstance(ro, smm.ReorderedMatrix) and lower32.wsell is not None,
            "jittered -> W-SELL, shuffled -> RCM + W-SELL, IC(0) strict parts -> W-SELL",
            quiet=True)
    print(f"laplace_3d_jittered(113): n={w32.shape[0]} nnz={w32.nnz} nway={w32.nway} "
          f"slot_ratio={w32.slot_ratio:.3f} vregs={w32.n_vregs}; IC(0) strict L slot_ratio "
          f"{lower32.wsell.slot_ratio:.3f} (window_f {lower32.wsell.window_f}); shuffled "
          f"poisson_2d(1414) RCM slot_ratio {ro.inner.slot_ratio:.3f}; ELL K={ell[torch.float32].slots}."
          f" Host builds: 2 matrices {t1 - t0:.1f} s, 2 W-SELL routes {t2 - t1:.1f} s, 2 IC(0) "
          f"with W-SELL strict parts {t3 - t2:.1f} s, 2 ELL {t4 - t3:.1f} s, shuffle "
          f"{t5 - t4:.1f} s, route of the shuffled system {t6 - t5:.1f} s")

    stats = {}
    gen = torch.Generator(device=dev).manual_seed(3)

    def rand(*shape, dtype):
        return (torch.rand(*shape, generator=gen, device=dev, dtype=torch.float64) - 0.5).to(dtype)

    def lib_of(csr, dtype):
        return library_csr(torch, csr.data.to(dtype), csr.indices, csr.indptr, csr.shape)

    def w7():
        return W.launches["wsell_spmv"]

    # K7: the jittered system in f32 and f64, the RCM-permuted shuffled
    # system, the IC(0) strict factor layout
    ro32 = ro.inner.astype(torch.float32)  # the stencil's values are exact in f32

    def strict_csr(tri):
        # the strict part of a triangular factor as a CSR (rows are sorted)
        ptr = torch.zeros(tri.n + 1, dtype=torch.int64, device=dev)
        ptr[1:] = torch.cumsum(torch.bincount(tri.row_ids, minlength=tri.n), 0)
        return smm.CSRMatrix(data=tri.data, indices=tri.indices, indptr=ptr,
                             row_ids=tri.row_ids, shape=(tri.n, tri.n))

    upper32 = ic[torch.float32].upper
    require(upper32.wsell is not None, "IC(0) strict U -> W-SELL", quiet=True)
    strict = {"L": (lower32.wsell, strict_csr(lower32)), "U": (upper32.wsell, strict_csr(upper32))}
    k7_cases = [(f"K7 jittered {str(dt)[6:]}", ws[dt], jit[dt], dt) for dt in ws]
    k7_cases += [("K7 shuffled poisson_2d(1414) RCM f32", ro32, ro.inner_csr, torch.float32),
                 ("K7 IC(0) strict L jittered f32", *strict["L"], torch.float32)]
    for label, a, csr, dt in k7_cases:
        x = rand(a.shape[1], dtype=dt)
        lib = lib_of(csr, dt)
        kernel_case(torch, stats, "wsell_spmv", label, lambda: W.wsell_spmv(a, x),
                    lambda: S.sell_spmv_plain(a.sell, x), lambda: lib @ x,
                    sell_bytes(a.sell, x.element_size()), a.shape[0], w7,
                    planes_plain=lambda: W.wsell_spmv_plain(a, x),
                    info=sell_layout_info(smm, torch, a, wsell_bytes(a, 1, x.element_size())))
    # K8, the panel instantiations of the same kernel: k = 4 (phase M's panel
    # width) first, then 2 and 8 in f32 and 4 in f64, then the IC(0) strict
    # factors at k = 4 f32 (six of the seven K8 launches per step of phase
    # M's PCG); each against its plain version bit for bit, the planes'
    # product, k K7 launches on the columns (bit for bit, timed here too) and
    # the library's SpMM
    stats["wsell_spmm_cases"] = []
    k8_cases = [("jittered", ws[dt], jit[dt], k, dt)
                for k, dt in ((4, torch.float32), (2, torch.float32), (8, torch.float32),
                              (4, torch.float64))]
    k8_cases += [(f"IC(0) strict {f} jittered", a, csr, 4, torch.float32)
                 for f, (a, csr) in strict.items()]
    for what, a, csr, k, dt in k8_cases:
        name = str(dt)[6:]
        lib = lib_of(csr, dt)
        xs = rand(a.shape[1], k, dtype=dt)
        cols = [xs[:, j].contiguous() for j in range(k)]
        ys = W.wsell_spmm(a, xs)
        n7 = w7()
        per_col = [W.wsell_spmv(a, c) for c in cols]
        torch.cuda.synchronize()
        require(w7() == n7 + k and all(bits_equal(torch, ys[:, j].contiguous(), per_col[j])
                                        for j in range(k)),
                f"K8 {what} {name} k={k}: each column bit for bit a K7 launch", quiet=True)
        case = kernel_case(torch, stats, "wsell_spmm", f"K8 {what} {name} k={k}",
                           lambda: W.wsell_spmm(a, xs), lambda: S.sell_spmm_plain(a.sell, xs),
                           lambda: lib @ xs, sell_bytes(a.sell, xs.element_size(), k=k),
                           a.shape[0], lambda: W.launches["wsell_spmm"], calls=10,
                           planes_plain=lambda: W.wsell_spmm_plain(a, xs),
                           info={"layout_bytes": sell_bytes(a.sell, xs.element_size(),
                                                            padded=True, k=k),
                                 "planes_bound_ms": bound_ms(wsell_bytes(a, k, xs.element_size(),
                                                                         per_vreg=0))})
        k7_ms = median_ms(lambda: [W.wsell_spmv(a, c) for c in cols], calls=10)
        print(f"  K8 {what} {name} k={k}: {k} K7 launches on the columns {k7_ms:.4f} ms, "
              f"K8 {case['ms']:.4f} ms ({k7_ms / case['ms']:.2f}x)")
        stats["wsell_spmm_cases"].append(dict(case, matrix=what, k=k, dtype=name,
                                              k7_columns_ms=k7_ms))
        if "k7_columns_ms" not in stats["wsell_spmm"]:
            stats["wsell_spmm"]["k7_columns_ms"] = k7_ms
    del lib, xs, cols, ys, per_col
    # K6 on the ELL layout of the jittered system (K = its longest row)
    for dt, e in ell.items():
        x = rand(e.shape[1], dtype=dt)
        lib = lib_of(jit[dt], dt)
        kernel_case(torch, stats, "ell_spmv", f"K6 ELL jittered {str(dt)[6:]}",
                    lambda: E.ell_spmv(e, x), lambda: S.sell_spmv_plain(e.sell, x),
                    lambda: lib @ x, sell_bytes(e.sell, x.element_size()), e.shape[0],
                    lambda: E.launches["ell_spmv"], planes_plain=lambda: E.ell_spmv_plain(e, x),
                    info=sell_layout_info(smm, torch, e, ell_bytes(e, x.element_size())))
    del lib, x

    # -- the solves: counters at 0 just before, read just after ----------------
    for mod in (K, T, W, E):
        mod.reset_launch_counts()
    f32 = dict(epsilon=1e-4, max_iterations=600)
    f64 = dict(epsilon=1e-8, max_iterations=600)
    b = {}
    for dt, a in ws.items():
        ab = a @ torch.ones(a.shape[1], dtype=dt, device=dev)
        b[dt] = ab / torch.linalg.norm(ab)  # the JAX bench's right-hand side
    res = {}
    for dt, kw in ((torch.float32, f32), (torch.float64, f64)):
        name = str(dt)[6:]
        res[f"cg {name}"] = general_solve(
            smm, loop, torch, f"cg jittered(113) {name}", smm.cg, jit[dt], b[dt], jit[dt], kw,
            W.launches, "wsell_spmv", 1, route=smm.WSellMatrix)
        res[f"pcg {name}"] = general_solve(
            smm, loop, torch, f"cg+ic0(4) jittered(113) {name}", smm.cg, jit[dt], b[dt], jit[dt],
            dict(kw, preconditioner=ic[dt]), W.launches, "wsell_spmv", 1 + 2 * 3,
            route=smm.WSellMatrix)
    b_sh = shuffled @ torch.ones(shuffled.shape[0], dtype=torch.float64, device=dev)
    sh = general_solve(smm, loop, torch, "cg shuffled poisson_2d(1414) f64", smm.cg, shuffled,
                       b_sh, shuffled, dict(epsilon=1e-8, max_iterations=20000), W.launches,
                       "wsell_spmv", 1, route=smm.ReorderedMatrix)
    require(abs(sh.iterations - cg_f64_its) <= 0.01 * cg_f64_its,
            f"shuffled CG: {sh.iterations} iterations within 1% of the unshuffled "
            f"{cg_f64_its}", quiet=True)
    e32 = ell[torch.float32]
    general_solve(smm, loop, torch, "cg ELL jittered(113) f32", smm.cg, e32, b[torch.float32],
                  jit[torch.float32], f32, E.launches, "ell_spmv", 1)
    xs = rand(w32.shape[1], 4, dtype=torch.float32)
    n8, n7 = W.launches["wsell_spmm"], W.launches["wsell_spmv"]
    ys = smm.rmult(w32, xs)
    cols = [smm.rmult(w32, xs[:, j].contiguous()) for j in range(4)]
    torch.cuda.synchronize()
    require(W.launches["wsell_spmm"] == n8 + 1 and W.launches["wsell_spmv"] == n7 + 4
            and all(bits_equal(torch, ys[:, j].contiguous(), cols[j]) for j in range(4)),
            "rmult(W-SELL, X (n, 4)): one K8 launch, bit for bit four K7 products", quiet=True)
    # ELL panels: one launch of the panel kernel serves up to 8 columns
    for k in (8, 9):
        xs = rand(e32.shape[1], k, dtype=torch.float32)
        n_panel, n6 = E.launches["ell_spmm"], E.launches["ell_spmv"]
        ys = smm.rmult(e32, xs)
        cols = [smm.rmult(e32, xs[:, j].contiguous()) for j in range(k)]
        torch.cuda.synchronize()
        require(E.launches["ell_spmm"] == n_panel + -(-k // 8)
                and E.launches["ell_spmv"] == n6 + k
                and all(bits_equal(torch, ys[:, j].contiguous(), cols[j]) for j in range(k)),
                f"rmult(ELL, X (n, {k})): {-(-k // 8)} panel launch(es), bit for bit {k} K6 "
                "products", quiet=True)
    del xs, ys, cols
    counts = {**W.launches, **E.launches}
    print(f"phase W launches: {counts}; iterations: "
          + ", ".join(f"{k} {r.iterations}" for k, r in res.items()))
    for kname, n in counts.items():
        require(n > 0, f"general path launched {kname} {n} times", quiet=True)
    return stats, counts, {"jit": jit, "ic": ic}


def multi_solve(smm, loop, torch, label, a, b, csr, kw, per_step, singles=None):
    """``cg_multi`` through the public entry twice (the second timed warm),
    with every launch counter of the run read: each column's status, the
    true residual on the host (scipy, per column), K8's launches against the
    loop's prediction (``per_step`` panel products per step, round and the
    initial residual, plus the final residual fixes), no K7 launch, and
    each column against a single-column ``cg`` on the same column.  One
    printed line per solve; returns the result and the printed numbers."""
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
    from sparse_matrix_math_tpu_torch.solvers import block

    walls = []
    for _ in range(2):
        block.reset_loop_counts()
        n8, n7, syncs0 = W.launches["wsell_spmm"], W.launches["wsell_spmv"], loop.host_syncs["count"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = smm.cg_multi(a, b, **kw)
        res.residual_norm.tolist()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        k8, k7 = W.launches["wsell_spmm"] - n8, W.launches["wsell_spmv"] - n7
        syncs = loop.host_syncs["count"] - syncs0
    c = dict(block.loop_counts)
    predicted = per_step * (c["steps"] + c["rounds"] + 1) + c["residual_fixes"]
    status, its = res.status.tolist(), res.iterations.tolist()
    reported = res.residual_norm.tolist()
    f64 = b.dtype == torch.float64
    host = [host_residuals(csr, b[:, j], res.x[:, j]) for j in range(b.shape[1])]
    print(f"{label}: status {status} iterations {its}; wall {walls[0]:.4f} s then "
          f"{walls[1]:.4f} s, {1e6 * walls[1] / max(max(its), 1):.1f} us/iteration "
          f"({1e6 * walls[1] / max(c['steps'], 1):.1f} us per chunk step), "
          f"{k8} K8 launches per solve (predicted {predicted}: {c}), {k7} K7, {syncs} host "
          f"syncs; residual_norm {[f'{r:.4e}' for r in reported]} host f64 "
          f"{[f'{h[0]:.4e}' for h in host]}")
    require(all(st == smm.SolverStatus.SUCCESS for st in status), f"{label}: every column "
            "SUCCESS", quiet=True)
    require(tuple(res.x.shape) == tuple(b.shape) and bool(torch.isfinite(res.x).all()),
            f"{label}: X finite, shape {tuple(b.shape)}", quiet=True)
    for j, (r, (true64, same)) in enumerate(zip(reported, host)):
        ref = true64 if f64 else same
        require(abs(r - ref) <= 0.01 * ref and (not f64 or true64 <= 1.01 * kw["epsilon"]),
                f"{label} column {j}: residual_norm {r:.4e} within 1% of the host {ref:.4e}",
                quiet=True)
    require(k8 == predicted and k8 > 0 and k7 == 0,
            f"{label}: {k8} K8 launches, the loop's {predicted}, no K7 launch", quiet=True)
    out = {"status": status, "iterations": its,
           "us_per_iteration": 1e6 * walls[1] / max(max(its), 1),
           "us_per_step": 1e6 * walls[1] / max(c["steps"], 1),
           "k8_launches": k8, "host_syncs": syncs, "loop": c}
    if singles is not None:
        diffs = []
        for j in range(b.shape[1]):
            one = singles(b[:, j].contiguous())
            diffs.append(its[j] - one.iterations)
            require(one.status == status[j], f"{label} column {j}: status as a single-column "
                    f"cg ({one.status})", quiet=True)
            if f64:
                require(abs(diffs[-1]) <= max(1, 0.01 * one.iterations),
                        f"{label} column {j}: {its[j]} iterations within max(1, 1%) of a "
                        f"single-column cg's {one.iterations}", quiet=True)
        print(f"  {label}: iterations minus a single-column cg's per column: {diffs}")
        out["iterations_minus_single"] = diffs
    return res, out


def phase_m(smm, loop, torch, dev, wsys):
    """The multi-RHS path at full width: ``cg_multi`` on the jittered
    system (laplace_3d_jittered(113)) through W-SELL, m = 4 columns, in f32
    and f64, plain (one K8 launch per iteration) and with IC(0)(4) in f32
    (seven: the panel product and six strict-factor products), each column
    held to the host's residual and to a single-column cg; then ``solve(csr,
    B, auto_format=True)`` on poisson_2d(1414) in f64 through the grid
    stencil (no kernel).  Every launch counter is reset just before."""
    import numpy as np

    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    print("== phase M: multi-RHS cg_multi (K8 every iteration) at full width")
    jit, ic = wsys["jit"], wsys["ic"]
    m = 4

    def panel(csr, seed):
        # column j: A x_j / ||A x_j|| for seeded normal x_j (CSR product, no kernel)
        x = np.random.default_rng(seed).standard_normal((csr.shape[1], m))
        ax = smm.rmult(csr, torch.as_tensor(x, device=dev).to(csr.dtype))
        return (ax / torch.linalg.norm(ax, dim=0)).contiguous()

    b = {dt: panel(c, 7) for dt, c in jit.items()}
    require(all(isinstance(smm.auto_route_for_solve(c), smm.WSellMatrix) for c in jit.values()),
            "jittered(113) routes to W-SELL (cached from phase W)", quiet=True)
    for mod in (K, T, W, E):
        mod.reset_launch_counts()
    out = {}
    for dt, eps in ((torch.float32, 1e-4), (torch.float64, 1e-8)):
        name = str(dt)[6:]
        kw = dict(epsilon=eps, max_iterations=2000)
        _, out[f"cg_multi {name}"] = multi_solve(
            smm, loop, torch, f"cg_multi jittered(113) {name} m={m}", jit[dt], b[dt], jit[dt],
            kw, 1, singles=lambda col, dt=dt, kw=kw: smm.cg(jit[dt], col, **kw))
    f32 = torch.float32
    kw = dict(epsilon=1e-4, max_iterations=2000, preconditioner=ic[f32])
    _, out["cg_multi+ic0(4) float32"] = multi_solve(
        smm, loop, torch, f"cg_multi+ic0(4) jittered(113) float32 m={m}", jit[f32], b[f32],
        jit[f32], kw, 1 + 2 * 3, singles=lambda col: smm.cg(jit[f32], col, **kw))

    # the grid stencil: solve() with a 2-D b and auto_format on a CSR
    p64 = smm.poisson_2d(1414, dtype=torch.float64, device=dev)
    bp = panel(p64, 8)
    n8 = W.launches["wsell_spmm"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = smm.solve(p64, bp, auto_format=True, epsilon=1e-8)
    res.residual_norm.tolist()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    status, its = res.status.tolist(), res.iterations.tolist()
    host = [host_residuals(p64, bp[:, j], res.x[:, j])[0] for j in range(m)]
    print(f"solve(poisson_2d(1414) f64, B (n, {m}), auto_format=True): "
          f"{type(res).__name__} status {status} iterations {its}; wall {wall:.3f} s (grid "
          f"stencil selection included), {1e6 * wall / max(max(its), 1):.1f} us/iteration; "
          f"host f64 "
          f"residuals {[f'{h:.4e}' for h in host]}")
    require(isinstance(res, smm.MultiSolveResult) and W.launches["wsell_spmm"] == n8
            and isinstance(smm.best_format(p64), smm.GridStencilMatrix),
            "solve(poisson_2d(1414), B, auto_format=True) went through the grid stencil",
            quiet=True)
    require(all(st == smm.SolverStatus.SUCCESS for st in status)
            and all(h <= 1.01e-8 for h in host),
            "grid stencil cg_multi f64: every column SUCCESS, host residual <= 1e-8", quiet=True)
    out["solve stencil float64"] = {"status": status, "iterations": its,
                                    "us_per_iteration": 1e6 * wall / max(max(its), 1)}
    counts = dict(W.launches)
    print(f"phase M launches: {counts}")
    require(counts["wsell_spmm"] > 0, f"multi-RHS path launched K8 {counts['wsell_spmm']} times",
            quiet=True)
    return out, counts


def df_operator_on_card(smm, torch, dia64):
    """The double-word operator of a float64 DIA matrix whose values are
    scaled by 1 + 1e-9·(row mod 997), so that the lo planes are not zero,
    split on the card; and the scaled float64 matrix it represents."""
    n_rows = dia64.shape[0]
    ramp = 1.0 + 1e-9 * (torch.arange(n_rows, device=dia64.device, dtype=torch.float64) % 997)
    diags = dia64.diags * ramp
    hi = diags.to(torch.float32)
    lo = (diags - hi.to(torch.float64)).to(torch.float32)
    dfa = smm.DfDiaMatrix(diags_hi=hi, diags_lo=lo, offsets=dia64.offsets, shape=dia64.shape,
                          nnz=dia64.nnz)
    return dfa, smm.DIAMatrix(diags=diags, offsets=dia64.offsets, shape=dia64.shape,
                              nnz=dia64.nnz)


def df_kernel_cases(smm, D, K, torch, dev):
    """K9 (and its K10 wrapper) against the plain version, both words bit
    for bit, at the three systems of phase A; recombined hi + lo against the
    float64 DIA kernel K1 on the same float64 matrix and x; timed beside
    the float64 ``torch.sparse_csr_tensor`` product."""
    systems = [("poisson_2d(1414)", smm.poisson_2d, (1414,)),
               ("poisson_3d(243)", smm.poisson_3d, (243,)),
               ("poisson_3d_27pt(128)", smm.poisson_3d_27pt, (128,))]
    gen = torch.Generator(device=dev).manual_seed(4)
    stats = {"err": 0.0}
    for label, make, args in systems:
        csr = make(*args, device=dev)
        dfa, dia64 = df_operator_on_card(smm, torch, smm.dia_from_csr(csr))
        n_rows, nd = dfa.shape[0], len(dfa.offsets)
        p = D.pad_dia_df(dfa)
        x64 = torch.rand(n_rows, generator=gen, device=dev, dtype=torch.float64) - 0.5
        xh, xl = (p.to_padded(w) for w in smm.df_from_host(x64, device=dev))

        def kern():
            return D.dia_spmv_padded_df(p, xh, xl)

        def plain():
            return D.dia_spmv_padded_df_plain(p.hi.diags_p, p.lo.diags_p, p.offsets, p.lead,
                                              n_rows, xh, xl)

        before = D.launches["dia_spmv_padded_df"]
        (yh, yl), (rh, rl) = kern(), plain()
        streamed = D.dia_spmv_streamed_df(p, xh, xl)
        torch.cuda.synchronize()
        err = max((yh - rh).abs().max().item(), (yl - rl).abs().max().item())
        require(D.launches["dia_spmv_padded_df"] == before + 2,
                f"K9 {label}: one launch per wrapper call", quiet=True)
        require(torch.equal(yh, rh) and torch.equal(yl, rl) and torch.equal(streamed[0], rh)
                and torch.equal(streamed[1], rl) and bool(torch.isfinite(yh).all()),
                f"K9/K10 {label}: both words equal the plain version bit for bit "
                f"(max abs err {err:.3e})")
        require(all(bool((w[:p.lead] == 0).all()) and bool((w[p.lead + n_rows:] == 0).all())
                    for w in (yh, yl)), f"K9 {label}: guard rows exactly (0, 0)", quiet=True)
        # the recombined product against the float64 kernel on the values
        # the two words hold
        y64 = K.dia_spmv(dia64, p.from_padded(xh).double() + p.from_padded(xl).double())
        got = p.from_padded(yh).double() + p.from_padded(yl).double()
        rel = ((got - y64).abs().max() / y64.abs().max()).item()
        require(rel <= 1e-12, f"K9 {label}: hi + lo within {rel:.2e} <= 1e-12 of the "
                              "float64 product")
        stats["err"] = max(stats["err"], err)
        ms, plain_ms = median_ms(kern), median_ms(plain, samples=3, calls=2)
        lib = library_csr(torch, csr.data, csr.indices, csr.indptr, csr.shape)
        lib_ms = median_ms(lambda: lib @ x64)
        nbytes = (2 * nd + 4) * 4 * n_rows
        b_ms = bound_ms(nbytes)
        print(f"  K9 {label}: n={n_rows} ndiags={nd}: kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s, {100 * b_ms / ms:.0f}% of the {b_ms:.4f} ms "
              f"bound), plain {plain_ms:.3f} ms, float64 torch.sparse_csr_tensor {lib_ms:.4f} ms")
        if "ms" not in stats:  # poisson_2d(1414): the main path's shape
            # no PyTorch call computes a double-word product (library_ms
            # null); the float64 CSR product is printed beside it
            stats.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, library_ms=None,
                         f64_csr_ms=lib_ms)
        del csr, dfa, dia64, p, x64, xh, xl, yh, yl, rh, rl, streamed, y64, got, lib
        torch.cuda.empty_cache()
    return stats


def host_csr_arrays(csr):
    return csr.data.cpu().numpy(), csr.indices.cpu().numpy(), csr.indptr.cpu().numpy()


def df_solve(smm, torch, label, solver, a, b64, csr_host, kw, counts, checks,
             may_stall=False):
    """One double-word solve through the public entry, held to SUCCESS and
    to the host's float64 ``||b - A x||`` (at most eps within 1%, and the
    reported norm within 1% of it); ``counts()`` reads every launch counter,
    ``checks`` maps a kernel name to the least number of launches this solve
    must add given its result.  With ``may_stall`` a refinement may end
    MAX_ITERATIONS_REACHED instead, if the iterate it returns is no worse
    than x = 0 and its reported norm is the host's.  One printed line;
    returns the result and its wall seconds."""
    import numpy as np

    data, indices, indptr = csr_host
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solver(a, b64, **kw)
    float(res.residual_norm2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x = res.x_f64()
    true64 = float(np.linalg.norm(b64 - np.add.reduceat(data * x[indices], indptr[:-1])))
    reported = float(res.residual_norm2) ** 0.5
    added = {k: v - before[k] for k, v in counts().items()}
    its = res.iterations
    rounds = "" if res.outer_rounds is None else f" in {res.outer_rounds} rounds"
    print(f"{label}: {res.status_enum().name} iterations={its}{rounds} residual_norm="
          f"{reported:.6e} host f64 {true64:.6e}; wall {wall:.3f} s, "
          f"{1e6 * wall / max(its, 1):.1f} us/iteration; launches "
          + ", ".join(f"{k} {v}" for k, v in added.items() if v))
    eps = kw["epsilon"]
    require(x.shape == (a.shape[0],) and bool(np.isfinite(x).all()), f"{label}: x finite",
            quiet=True)
    if may_stall and res.status == smm.SolverStatus.MAX_ITERATIONS_REACHED:
        b_norm = float(np.linalg.norm(b64))
        require(true64 <= b_norm and abs(reported - true64) <= 0.01 * true64,
                f"{label}: ended MAX_ITERATIONS_REACHED after {res.outer_rounds} rounds, as "
                f"the JAX package does on the CPU at n = 250-400; the best iterate's host "
                f"residual {true64:.4e} <= ||b|| {b_norm:.4e}, reported within 1%")
        return res, wall
    require(res.status == smm.SolverStatus.SUCCESS, f"{label}: status {res.status_enum().name}",
            quiet=True)
    require(true64 <= 1.01 * eps and abs(reported - true64) <= 0.01 * true64,
            f"{label}: host f64 residual {true64:.4e} <= {eps:.0e} (1%), reported within 1%")
    for kname, least in checks(res).items():
        require(added[kname] >= least, f"{label}: {added[kname]} {kname} launches >= {least}",
                quiet=True)
    return res, wall


def phase_d(smm, loop, torch, dev):
    """The double-word path at full width: K9 against its plain version, then
    cg_df64, bicgstab_df64, cg_ir_df64 (inner solve on K2) and
    bicgstab_ir_df64 with PaddedSGS(4) (inner K2 and K4) on the bench's
    systems, and cg_df64 on the ELL operator of the jittered system, with
    every launch counter at 0 just before the solves."""
    import numpy as np

    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as D
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
    from sparse_matrix_math_tpu_torch.precond import PaddedSGS

    print("== phase D: double-word (f64-grade float32 pairs) kernel K9/K10 and solves")
    t_start = time.perf_counter()
    stats = df_kernel_cases(smm, D, K, torch, dev)

    t0 = time.perf_counter()
    p64 = smm.poisson_2d(1414, device=dev)
    p_host = host_csr_arrays(p64)
    dfa = smm.df_operator_from_host_csr(*p_host, p64.shape, device=dev)
    b_ones = np.add.reduceat(p_host[0], p_host[2][:-1])  # A @ ones in float64
    cd64 = smm.convection_diffusion_2d(1414, device=dev)
    cd_host = host_csr_arrays(cd64)
    cdfa = smm.df_operator_from_host_csr(*cd_host, cd64.shape, device=dev)
    x_rand = np.random.default_rng(0).standard_normal(cd64.shape[0])  # phase B's x_true
    b_rand = np.add.reduceat(cd_host[0] * x_rand[cd_host[1]], cd_host[2][:-1])
    cd_rowsums = np.add.reduceat(cd_host[0], cd_host[2][:-1])
    psgs = PaddedSGS.from_dia(smm.dia_from_csr(smm.convection_diffusion_2d(
        1414, dtype=torch.float32, device=dev)), sweeps=4)
    jit64 = smm.laplace_3d_jittered(113, symmetric=True, shift=0.25, device=dev)
    jit_host = host_csr_arrays(jit64)
    dfe = smm.df_operator_from_host_csr(*jit_host, jit64.shape, device=dev)
    b_jit = np.add.reduceat(jit_host[0], jit_host[2][:-1])
    b_jit = b_jit / np.linalg.norm(b_jit)  # the JAX bench's right-hand side
    require(isinstance(dfa, smm.DfDiaMatrix) and isinstance(cdfa, smm.DfDiaMatrix)
            and isinstance(dfe, smm.DfEllMatrix),
            "double-word operators: the stencils DIA, the jittered system ELL", quiet=True)
    print(f"double-word operators built on the host in {time.perf_counter() - t0:.1f} s "
          f"(ELL K={dfe.vals_hi.shape[1]})")

    # -- the solves: every counter at 0 just before, read just after ----------
    for mod in (K, T, W, E, D):
        mod.reset_launch_counts()

    def live():
        return {k: v for mod in (K, T, W, E, D) for k, v in mod.launches.items()}

    f64 = dict(epsilon=1e-8)
    cg_res, cg_wall = df_solve(
        smm, torch, "cg_df64 poisson_2d(1414) b=A@ones", smm.cg_df64, dfa, b_ones, p_host,
        dict(f64, max_iterations=12000), live,
        lambda r: {"dia_spmv_padded_df": r.iterations + 1})
    df_solve(smm, torch, "bicgstab_df64 convection_diffusion_2d(1414) x_true normal",
             smm.bicgstab_df64, cdfa, b_rand, cd_host, dict(f64, max_iterations=20000), live,
             lambda r: {"dia_spmv_padded_df": 2 * r.iterations + 2})
    df_solve(smm, torch, "cg_ir_df64 poisson_2d(1414) b=A@ones", smm.cg_ir_df64, dfa, b_ones,
             p_host, dict(f64, max_iterations=30000), live,
             lambda r: {"dia_spmv_padded_df": r.outer_rounds + 1,
                        "dia_spmv_padded": r.iterations})
    # The bench's form (b = row sums, bench.py:836-867) is held to SUCCESS
    # only where the f32 inner BiCGStab survives its first round: with
    # this b the JAX package on the CPU ends MAX_ITERATIONS_REACHED after one
    # reverted round at n = 250, 300 and 400 (and the port at 200, 300 and
    # 400); with phase B's x_true both succeed at every n tried.
    for label, b, may_stall in (("b=rowsums (the bench's)", cd_rowsums, True),
                                ("x_true normal", b_rand, False)):
        df_solve(smm, torch, f"bicgstab_ir_df64+PaddedSGS(4) convection_diffusion_2d(1414) {label}",
                 smm.bicgstab_ir_df64, cdfa, b, cd_host,
                 dict(f64, max_iterations=30000, preconditioner=psgs), live,
                 lambda r: {"dia_spmv_padded_df": r.outer_rounds + 1,
                            "dia_spmv_padded": 2 * r.iterations,
                            "sgs_apply": 2 * r.iterations}, may_stall=may_stall)
    df_solve(smm, torch, "cg_df64 ELL laplace_3d_jittered(113)", smm.cg_df64, dfe, b_jit,
             jit_host, dict(f64, max_iterations=600), live, lambda r: {})
    counts = live()
    print(f"phase D launches: {counts}")
    for kname in ("dia_spmv_padded_df", "dia_spmv_padded", "sgs_apply"):
        require(counts[kname] > 0, f"double-word path launched {kname} {counts[kname]} times",
                quiet=True)

    # native float64 CG on the same system, for its cost per iteration
    b_t = torch.as_tensor(b_ones, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    native = smm.cg(p64, b_t, epsilon=1e-8, max_iterations=20000)
    float(native.residual_norm)
    torch.cuda.synchronize()
    native_wall = time.perf_counter() - t0
    print(f"cg_df64 {1e6 * cg_wall / cg_res.iterations:.1f} us/iteration ({cg_res.iterations} "
          f"iterations) against native float64 cg {1e6 * native_wall / native.iterations:.1f} "
          f"us/iteration ({native.status_enum().name}, {native.iterations} iterations, wall "
          f"{native_wall:.3f} s) on "
          f"poisson_2d(1414); phase D took {time.perf_counter() - t_start:.1f} s")
    return stats, counts


def stream_bytes(p, table_len: int, itemsize: int) -> int:
    """K11's bytes model for one routing pass: each slot's value, meta word
    and output, the bases and the table once."""
    return p.n_vregs * (1024 * (2 * itemsize + 4) + 4) + table_len * itemsize


def final_pass_csr(smm, torch, fin):
    """The routed chain's final W-SELL pass as ``torch.sparse_csr_tensor``
    (rows by the stream positions), the yardstick of that pass alone."""
    from sparse_matrix_math_tpu_torch.formats.sell import wsell_products

    row, col, val, _ = wsell_products(fin.vals, fin.meta, fin.base, fin.slab,
                                      max(3, (8 * fin.window_f - 1).bit_length()), fin.nway)
    order = torch.sort(row * fin.shape[1] + col).indices
    crow = torch.zeros(fin.shape[0] + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=fin.shape[0]), 0)
    return library_csr(torch, val[order], col[order], crow, fin.shape)


class record_best_format:
    """While active, ``formats.best_format`` and the layout constructors it tries
    print their host seconds and what they returned; ``chosen`` holds the
    operators ``best_format`` handed back.  Everything passes through."""

    stages = ("try_wsell_from_csr", "reorder_to_wsell", "try_routed_from_csr", "best_format")

    def __init__(self, formats, torch):
        self.formats, self.torch, self.chosen, self.saved = formats, torch, [], {}

    def __enter__(self):
        for name in self.stages:
            self.saved[name] = fn = getattr(self.formats, name)

            def timed(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                self.torch.cuda.synchronize()
                ratio = getattr(getattr(out, "inner", out), "slot_ratio", None)
                print(f"    {_name}: {type(out).__name__} in {time.perf_counter() - t0:.1f} s"
                      + ("" if ratio is None else f", slot_ratio {ratio:.3f}"))
                if _name == "best_format":
                    self.chosen.append(out)
                return out

            setattr(self.formats, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.formats, name, fn)


def phase_r(smm, loop, torch, dev, dia_solves):
    """The front door and the routed path at full width: the JAX bench's
    zero-locality system (bench.py:756-806) as an R-SELL chain, K11 against its
    plain version on every pass, the chain beside the CSR products, then
    ``solve(..., auto_format=True)`` through a RoutedMatrix (f32, f64) and
    through the grid stencil, the pre-route to the double-word refinement,
    and BiCGSymmetric and CGS on the padded path, with every launch counter
    at 0 just before the solves.  ``dia_solves`` maps phase B's labels to
    (iterations, warm wall seconds), None to run those two CG solves here."""
    import numpy as np

    import sparse_matrix_math_tpu_torch.formats as formats
    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as D
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import sell_spmv as S
    from sparse_matrix_math_tpu_torch.ops import stream_gather as R
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    print("== phase R: the front door, the routed chain (K11, then K7) and the grid stencil")
    t_start = time.perf_counter()
    n = 2_000_000  # the JAX bench's size for the routed case
    t0 = time.perf_counter()
    csr = {dt: smm.uniform_random_csr(n, per_row=5, dtype=dt, device=dev)
           for dt in (torch.float32, torch.float64)}
    c32 = csr[torch.float32]
    t1 = time.perf_counter()
    ra32 = smm.routed_from_csr(c32, max_slot_ratio=16.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    print(f"uniform_random_csr({n}, per_row=5): nnz={c32.nnz}, two matrices in {t1 - t0:.1f} s; "
          f"routed_from_csr f32 on the host in {build_s:.1f} s: {len(ra32.passes)} routing "
          f"passes of {[p.n_vregs for p in ra32.passes]} vregs (window_f "
          f"{ra32.passes[0].window_f}), final W-SELL {ra32.final.n_vregs} vregs nway "
          f"{ra32.final.nway}, slot_ratio {ra32.slot_ratio:.3f} slots per nonzero")

    # -- the front door first: its f64 chain also serves the kernel checks ----
    for mod in (K, T, W, E, D, R):
        mod.reset_launch_counts()
    x_true = np.random.default_rng(0).standard_normal(n)  # phase B's form
    solved, per_solve = {}, {}
    with record_best_format(formats, torch) as spy:
        for dt, eps in ((torch.float32, 1e-4), (torch.float64, 1e-8)):
            name = str(dt)[6:]
            a = csr[dt]
            ab = a @ torch.as_tensor(x_true, device=dev).to(dt)
            # unit norm, as the JAX bench's general-pattern solve: with the
            # raw b (norm ~9e3) eps 1e-4 lies below eps_f32 * ||b|| and
            # solve() pre-routes the f32 request to the double-word refinement
            b = ab / torch.linalg.norm(ab)
            label = f"solve(bicgstab, auto_format=True) uniform_random({n}) {name}"
            print(f"{label}: best_format on the host")
            before = {k: dict(m.launches) for k, m in (("R", R), ("W", W))}
            syncs0 = loop.host_syncs["count"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = smm.solve(a, b, method="bicgstab", auto_format=True, epsilon=eps,
                            max_iterations=2000)
            float(res.residual_norm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            op = spy.chosen[-1]
            require(isinstance(op, smm.RoutedMatrix) and isinstance(res, smm.SolveResult),
                    f"{label}: best_format refused W-SELL and RCM + W-SELL and returned a "
                    f"RoutedMatrix; the solve returned a SolveResult")
            k11 = R.launches["stream_gather"] - before["R"]["stream_gather"]
            k7 = W.launches["wsell_spmv"] - before["W"]["wsell_spmv"]
            # the solve itself, warm: the operator is the one best_format built
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm = smm.solve(op, b, method="bicgstab", epsilon=eps, max_iterations=2000)
            float(warm.residual_norm)
            torch.cuda.synchronize()
            warm_wall = time.perf_counter() - t0
            # K11 and K7 of each counted solve: passes x matvecs and matvecs
            per_solve[f"bicgstab {name}"] = {"passes": len(op.passes), "stream_gather": k11,
                                             "wsell_spmv": k7}
            per_solve[f"bicgstab {name}, warm repeat"] = {
                "passes": len(op.passes),
                "stream_gather": R.launches["stream_gather"] - before["R"]["stream_gather"] - k11,
                "wsell_spmv": W.launches["wsell_spmv"] - before["W"]["wsell_spmv"] - k7}
            true64, same = host_residuals(a, b, res.x)
            ref = true64 if dt == torch.float64 else same
            reported, its = float(res.residual_norm), res.iterations
            print(f"{label}: {res.status_enum().name} iterations={its} residual_norm="
                  f"{reported:.6e} host f64 {true64:.6e} same-precision {same:.6e}; wall with "
                  f"the layout build {wall:.1f} s, warm solve {warm_wall:.4f} s "
                  f"({1e6 * warm_wall / max(warm.iterations, 1):.1f} us/iteration, "
                  f"{warm.iterations} iterations), {loop.host_syncs['count'] - syncs0} host "
                  f"syncs, launches K11 {k11}, K7 {k7}")
            require(res.status == smm.SolverStatus.SUCCESS and reported <= eps
                    and abs(reported - ref) <= 0.01 * ref,
                    f"{label}: SUCCESS, residual_norm {reported:.4e} <= {eps:.0e} and within "
                    f"1% of the host residual {ref:.4e}")
            require(tuple(res.x.shape) == (n,) and bool(torch.isfinite(res.x).all()),
                    f"{label}: x finite, shape {tuple(res.x.shape)}", quiet=True)
            require(k7 >= 2 * its + 2 and k11 == len(op.passes) * k7,
                    f"{label}: K7 launched {k7} times (>= 2 x {its} iterations + 2), K11 "
                    f"{k11} = {len(op.passes)} passes x {k7} matvecs")
            solved[dt] = op
            del ab, b, res, warm
    # read before the comparison launches below, which do not count
    routed_counts = {**R.launches, "wsell_spmv": W.launches["wsell_spmv"]}
    for kname in ("stream_gather", "wsell_spmv"):
        require(routed_counts[kname] == sum(c[kname] for c in per_solve.values()),
                f"{kname}: the count of the front-door solves is the sum of its solves'",
                quiet=True)
    op32, op64 = solved[torch.float32], solved[torch.float64]
    same_planes = len(op32.passes) == len(ra32.passes) and all(
        torch.equal(getattr(p, f), getattr(q, f)) for p, q in zip(op32.passes, ra32.passes)
        for f in ("vals", "meta", "base")) and all(
        torch.equal(getattr(op32.final, f), getattr(ra32.final, f))
        for f in ("vals", "meta", "base", "slab"))
    require(same_planes, "best_format's f32 chain has the planes of routed_from_csr(csr, "
                         "max_slot_ratio=16.0), the bench's build")
    del op32, solved

    # -- K11 against its plain version on every pass, f32 and f64 -------------
    gen = torch.Generator(device=dev).manual_seed(5)
    stats = {"err": 0.0}
    chains = {}
    for dt, ra in ((torch.float32, ra32), (torch.float64, op64)):
        name = str(dt)[6:]
        x = (torch.rand(n, generator=gen, device=dev, dtype=torch.float64) - 0.5).to(dt)
        t = x
        passes_ms, nbytes_all = [], 0
        for i, p in enumerate(ra.passes):
            kw = dict(x_rows=p.x_rows, window_f=p.window_f)
            before = R.launches["stream_gather"]
            out = R.stream_gather(p.base, p.meta, p.vals, t, **kw)
            ref = R.stream_gather_plain(p.base, p.meta, p.vals, t, **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            require(R.launches["stream_gather"] == before + 1,
                    f"K11 pass {i} {name}: launch counter rose", quiet=True)
            require(out.shape == (p.out_len,) and bool(torch.isfinite(out).all())
                    and torch.equal(out, ref),
                    f"K11 pass {i} {name}: {p.out_len} finite slots equal the plain version "
                    f"(max abs err {err:.3e})", quiet=True)
            del ref
            ms = median_ms(lambda: R.stream_gather(p.base, p.meta, p.vals, t, **kw))
            plain_ms = median_ms(lambda: R.stream_gather_plain(p.base, p.meta, p.vals, t, **kw),
                                 samples=3, calls=2)
            nbytes = stream_bytes(p, t.shape[0], t.element_size())
            b_ms = bound_ms(nbytes)
            print(f"  K11 pass {i} {name}: {p.n_vregs} vregs from a table of {t.shape[0]}: err "
                  f"0, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{100 * b_ms / ms:.0f}% of the {b_ms:.4f} ms bound), plain {plain_ms:.3f} ms")
            stats["err"] = max(stats["err"], err)
            passes_ms.append(ms)
            nbytes_all += nbytes
            if dt == torch.float32 and b_ms > stats.get("bound_ms", 0.0):
                stats.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)  # the largest pass
            t = out
        # the final W-SELL pass over the routed stream, and the whole chain
        # against the float64 product on the host and the port's CSR rmult
        fin = ra.final
        y_fin = W.wsell_spmv(fin, t)
        require(bits_equal(torch, y_fin, S.sell_spmv_plain(fin.sell, t))
                and bool(torch.equal(y_fin, W.wsell_spmv_plain(fin, t))),
                f"K7 over the routed stream {name} (table of {t.shape[0]} for "
                f"{n} rows, {fin.n_slabs} slabs): bit for bit its plain version, equal to "
                f"the planes' plain version", quiet=True)
        final_ms = median_ms(lambda: W.wsell_spmv(fin, t))
        fin_info = sell_layout_info(smm, torch, fin, wsell_bytes(fin, 1, t.element_size()))
        fin_lib = final_pass_csr(smm, torch, fin)
        fin_info["library_ms"] = median_ms(lambda: fin_lib @ t)
        del fin_lib
        y = ra @ x
        require(torch.equal(y, y_fin), f"rmult(RoutedMatrix) {name} is the chain", quiet=True)
        import scipy.sparse as sp

        a = csr[dt]
        host = sp.csr_matrix((a.data.cpu().numpy().astype(np.float64), a.indices.cpu().numpy(),
                              a.indptr.cpu().numpy()), shape=a.shape)
        y64 = host @ x.cpu().numpy().astype(np.float64)
        scale = float(np.abs(y64).max())
        rel_host = float(np.abs(y.cpu().numpy().astype(np.float64) - y64).max()) / scale
        rel_csr = ((y - a @ x).abs().max().item()) / scale
        tol = 1e-5 if dt == torch.float32 else 1e-13
        require(rel_host <= tol and rel_csr <= tol,
                f"routed product {name}: within {rel_host:.2e} of the host float64 CSR product "
                f"and {rel_csr:.2e} of the port's CSR rmult (of max|y|, bound {tol:.0e})")
        fin_bytes = sell_bytes(fin.sell, t.element_size())
        fin_info["bound_ms"] = bound_ms(fin_bytes)
        print(f"  K7 final pass {name}: {final_ms:.4f} ms "
              f"({100 * bound_ms(fin_bytes) / final_ms:.0f}% of its {bound_ms(fin_bytes):.4f} ms "
              f"bound; over the layout's slots {bound_ms(fin_info['layout_bytes']):.4f} ms, "
              f"the planes' {fin_info['planes_bound_ms']:.4f} ms), "
              f"torch.sparse_csr_tensor of the pass {fin_info['library_ms']:.4f} ms, "
              f"{fin_info['slots_per_nonzero']:.4f} slots per nonzero (planes "
              f"{fin_info['planes_slots_per_nonzero']:.4f}), layout derived in "
              f"{fin_info['layout_build_s']:.3f} s (same as built: {fin_info['same_as_built']}); "
              f"chain bytes {nbytes_all + fin_bytes}")
        chains[dt] = (passes_ms, final_ms, bound_ms(nbytes_all + fin_bytes), fin_info)
        del t, out, y, y_fin, x
    del op64
    torch.cuda.empty_cache()

    # -- the bench's own form: the product in a loop, x = ones, f32 ------------
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    lib = library_csr(torch, c32.data, c32.indices, c32.indptr, c32.shape)
    chain_ms = median_ms(lambda: ra32 @ ones)
    csr_ms = median_ms(lambda: c32 @ ones)
    lib_ms = median_ms(lambda: lib @ ones)
    passes_ms, final_ms, chain_bound, fin_info = chains[torch.float32]
    stats.update(library_ms=lib_ms, passes_ms=passes_ms, final_ms=final_ms, chain_ms=chain_ms,
                 chain_bound_ms=chain_bound, csr_ms=csr_ms, launches_per_solve=per_solve,
                 final_pass={"ms": final_ms, **fin_info})
    print(f"routed product f32, x = ones: chain {chain_ms:.4f} ms "
          f"({c32.nnz / chain_ms / 1e6:.2f} GNNZ/s; passes {sum(passes_ms):.4f} ms + final K7 "
          f"{final_ms:.4f} ms; {100 * chain_bound / chain_ms:.0f}% of the chain's "
          f"{chain_bound:.4f} ms bound), the port's CSR rmult {csr_ms:.4f} ms "
          f"({c32.nnz / csr_ms / 1e6:.2f} GNNZ/s), torch.sparse_csr_tensor @ x {lib_ms:.4f} ms "
          f"({c32.nnz / lib_ms / 1e6:.2f} GNNZ/s); build {build_s:.1f} s, slot_ratio "
          f"{ra32.slot_ratio:.3f}, {len(ra32.passes)} passes")
    stats["routed_f32"] = ra32  # phase U times its product through spmv_throughput
    del lib, ra32, ones
    torch.cuda.empty_cache()

    # -- CG through a routed chain: the symmetric part (A + A^T)/2, f32 --------
    # (diagonal 6 against a symmetrized off-diagonal part of spectral radius
    # near 5: positive definite, though not every row is diagonally dominant)
    t0 = time.perf_counter()
    r_h, c_h = c32.row_ids.cpu().numpy(), c32.indices.cpu().numpy()
    v_h = c32.data.cpu().numpy() * np.float32(0.5)
    sym = smm.csr_from_coo(smm.coo_from_arrays(
        np.concatenate([r_h, c_h]), np.concatenate([c_h, r_h]), np.concatenate([v_h, v_h]),
        (n, n), device=dev))
    t1 = time.perf_counter()
    ra_sym = smm.routed_from_csr(sym, max_slot_ratio=16.0)
    print(f"(A + A^T)/2: nnz={sym.nnz}, assembled on the host in {t1 - t0:.1f} s, routed in "
          f"{time.perf_counter() - t1:.1f} s: {len(ra_sym.passes)} passes, slot_ratio "
          f"{ra_sym.slot_ratio:.3f}")
    ab = sym @ torch.as_tensor(x_true, device=dev).to(torch.float32)
    general_solve(smm, loop, torch, f"cg routed (A + A^T)/2 uniform_random({n}) f32", smm.cg,
                  ra_sym, ab / torch.linalg.norm(ab), sym, dict(epsilon=1e-4, max_iterations=2000),
                  R.launches, "stream_gather", len(ra_sym.passes))
    del r_h, c_h, v_h, sym, ra_sym, ab, csr, c32
    torch.cuda.empty_cache()

    # -- the grid-stencil route and the pre-route ------------------------------
    def front_door(label, a, b, expect, **kw):
        with record_best_format(formats, torch) as spy:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = smm.solve(a, b, auto_format=True, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        require(isinstance(spy.chosen[-1], expect), f"{label}: best_format returned a "
                f"{expect.__name__}", quiet=True)
        return res, wall, spy.chosen[-1]

    p32 = smm.poisson_2d(1414, dtype=torch.float32, device=dev)
    p64 = smm.poisson_2d(1414, dtype=torch.float64, device=dev)
    b32 = p32 @ torch.ones(p32.shape[0], dtype=torch.float32, device=dev)
    b64 = p64 @ torch.ones(p64.shape[0], dtype=torch.float64, device=dev)
    if dia_solves is None:  # phase R alone: phase B's two CG solves, warm
        dia_solves = {}
        for name, a, b, kw in (("f32", p32, b32, dict(epsilon=1e-4, max_iterations=6000)),
                               ("f64", p64, b64, dict(epsilon=1e-8, max_iterations=20000))):
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = smm.cg(a, b, **kw)
                float(ref.residual_norm)
                torch.cuda.synchronize()
                dia_solves[f"cg poisson_2d(1414) {name}"] = (ref.iterations,
                                                             time.perf_counter() - t0)
    for label, a, b, kw, dia_label in (
            ("stencil cg poisson_2d(1414) f32", p32, b32,
             dict(epsilon=1e-4, max_iterations=6000, auto_escalate=False),
             "cg poisson_2d(1414) f32"),
            ("stencil cg poisson_2d(1414) f64", p64, b64,
             dict(epsilon=1e-8, max_iterations=20000), "cg poisson_2d(1414) f64")):
        k2 = K.launches["dia_spmv_padded"]
        res, wall, st = front_door(label, a, b, smm.GridStencilMatrix, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = smm.solve(st, b, **kw)
        float(warm.residual_norm)
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - t0
        true64, same = host_residuals(a, b, res.x)
        f64 = b.dtype == torch.float64
        ref = true64 if f64 else same
        reported, its = float(res.residual_norm), res.iterations
        dia_its, dia_wall = dia_solves[dia_label]
        print(f"{label}: {res.status_enum().name} iterations={its} floor_hit={res.floor_hit} "
              f"residual_norm={reported:.6e} host f64 {true64:.6e} same-precision {same:.6e}; "
              f"wall with detection {wall:.3f} s, warm {warm_wall:.4f} s, "
              f"{1e6 * warm_wall / max(warm.iterations, 1):.1f} us/iteration against "
              f"{1e6 * dia_wall / max(dia_its, 1):.1f} for the DIA padded path (phase B, "
              f"{dia_its} iterations)")
        ok = res.status == smm.SolverStatus.SUCCESS or (
            not f64 and res.status == smm.SolverStatus.MAX_ITERATIONS_REACHED and res.floor_hit)
        require(ok and isinstance(res, smm.SolveResult) and abs(reported - ref) <= 0.01 * ref,
                f"{label}: status {res.status_enum().name} (floor_hit={res.floor_hit}), "
                f"residual_norm within 1% of the host residual")
        # an f32 solve ends at its floor after a number of verified restarts
        # that moves with the summation order
        band = max(2, int(0.01 * dia_its)) if f64 else int(0.25 * dia_its)
        require(abs(its - dia_its) <= band and K.launches["dia_spmv_padded"] == k2,
                f"{label}: {its} iterations within {band} of the DIA path's {dia_its}, no DIA "
                f"kernel launched")
    k9, k2 = D.launches["dia_spmv_padded_df"], K.launches["dia_spmv_padded"]
    res, wall, _ = front_door("pre-route poisson_2d(1414) f32 eps 1e-8", p32, b32,
                              smm.GridStencilMatrix, epsilon=1e-8, max_iterations=30000)
    require(isinstance(res, smm.DfSolveResult) and res.status == smm.SolverStatus.SUCCESS,
            "solve(f32 data, epsilon=1e-8, auto_format=True) pre-routes to the double-word "
            f"refinement: {res!r}", quiet=True)
    data, indices, indptr = host_csr_arrays(p64)
    true64 = float(np.linalg.norm(b64.cpu().numpy() - np.add.reduceat(
        data * res.x_f64()[indices], indptr[:-1])))
    print(f"pre-route poisson_2d(1414) f32 eps 1e-8: {res!r} in {res.outer_rounds} rounds, host "
          f"f64 residual {true64:.4e}; wall {wall:.2f} s; launches K9 "
          f"{D.launches['dia_spmv_padded_df'] - k9}, K2 {K.launches['dia_spmv_padded'] - k2}")
    require(true64 <= 1e-8 and D.launches["dia_spmv_padded_df"] > k9,
            f"pre-route: host float64 residual {true64:.4e} <= 1e-8 through K9 and K2")

    # -- BiCGSymmetric and CGS on the padded path (K2) -------------------------
    for solver in (smm.bicg_symmetric, smm.cgs):
        general_solve(smm, loop, torch, f"{solver.__name__} poisson_2d(1414) f64", solver, p64,
                      b64, p64, dict(epsilon=1e-8, max_iterations=20000), K.launches,
                      "dia_spmv_padded", 1 if solver is smm.bicg_symmetric else 2,
                      route=smm.DIAMatrix)
    counts = {**routed_counts, "dia_spmv_padded": K.launches["dia_spmv_padded"]}
    print(f"phase R launches: {counts}; phase R took {time.perf_counter() - t_start:.1f} s")
    for kname in ("stream_gather", "wsell_spmv", "dia_spmv_padded"):
        require(counts[kname] > 0, f"front door launched {kname} {counts[kname]} times",
                quiet=True)
    return stats, counts


def timed_solve(torch, solve):
    """``solve()`` timed by the host clock between two syncs: (result, s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    float(res.residual_norm2 if hasattr(res, "residual_norm2") else res.residual_norm)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def device_breakdown(torch, solve, groups, by_count=None):
    """Device µs of one run of ``solve`` under torch.profiler, summed by the
    first group (name, substrings) whose substring a kernel's name holds,
    the rest under "other"; and the kernel launches (``by_count``, when
    given, receives them by group)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = solve()
        float(res.residual_norm)
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in groups}
    out["other"], launches = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.is_user_annotation:
            continue
        key = next((name for name, subs in groups if any(s in ev.key for s in subs)), "other")
        out[key] += ev.self_device_time_total
        launches += ev.count
        if by_count is not None:
            by_count[key] = by_count.get(key, 0) + ev.count
    if by_count is not None:
        for name in out:
            by_count.setdefault(name, 0)
    return res, out, launches


def phase_h(smm, K, loop, torch, dev):
    """The mixed-precision path at full width: ``mixed_cg`` (bfloat16
    diagonals through K2's narrow instantiation in the inner solve, the
    float32 true residual through K2 each round) and ``solve(...,
    matrix_dtype="bfloat16", auto_format=True)``, beside plain float32 ``cg``
    at the same epsilon, on the two systems the JAX package measured it on:
    ``poisson_2d(1414)`` at epsilon = plain cg's true residual x 1.05
    (bench.py:377-407) and ``poisson_3d_27pt(128)`` at 1e-4 * ||b||
    (benchmarks/mixed_wide_stencil.py:51-57), b = A @ ones."""
    import dataclasses
    import warnings

    from sparse_matrix_math_tpu_torch.solvers import mixed as MX

    print("== phase H: mixed precision (bf16 diagonals, K2's narrow shape) at full width")
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(2)
    stats = {"err": 0.0, "cases": {}, "solves": {}}
    launched_lo = 0
    for label, make, args, rel_eps in (("poisson_2d(1414)", smm.poisson_2d, (1414,), None),
                                       ("poisson_3d_27pt(128)", smm.poisson_3d_27pt, (128,),
                                        1e-4)):
        csr = make(*args, dtype=torch.float32, device=dev)
        dia = smm.dia_from_csr(csr)
        n, nd = dia.shape[0], len(dia.offsets)
        p_hi = K.pad_dia(dia)
        p_lo = dataclasses.replace(p_hi, diags_p=p_hi.diags_p.to(torch.bfloat16))
        xp = p_hi.to_padded(torch.rand(n, generator=gen, device=dev) - 0.5)

        # -- K2 on bf16 diagonals: bit for bit its plain version, timed ------
        before = dict(K.launches)
        y = K.dia_spmv_padded(p_lo, xp)
        y_ref = K.dia_spmv_padded_plain(p_lo.diags_p, p_lo.offsets, p_lo.lead, n, xp)
        torch.cuda.synchronize()
        err = (y - y_ref).abs().max().item()
        require(K.launches["dia_spmv_padded_bf16"] == before["dia_spmv_padded_bf16"] + 1
                and K.launches["dia_spmv_padded"] == before["dia_spmv_padded"],
                f"K2 bf16 {label}: its own launch counter rose, f32 K2's did not", quiet=True)
        require(y.dtype == torch.float32 and bits_equal(torch, y, y_ref)
                and bool(torch.isfinite(y).all()),
                f"K2 bf16 {label}: {n} rows bit for bit its plain version")
        require(bool((y[:p_lo.lead] == 0).all()) and bool((y[p_lo.lead + n:] == 0).all()),
                f"K2 bf16 {label}: guard rows exactly 0")
        ms = graph_ms(torch, lambda: K.dia_spmv_padded(p_lo, xp))
        f32_ms = graph_ms(torch, lambda: K.dia_spmv_padded(p_hi, xp))
        wrapper_ms = median_ms(lambda: K.dia_spmv_padded(p_lo, xp))
        plain_ms = median_ms(lambda: K.dia_spmv_padded_plain(p_lo.diags_p, p_lo.offsets,
                                                             p_lo.lead, n, xp),
                             samples=3, calls=5)
        x = p_hi.from_padded(xp).contiguous()
        lib = library_csr(torch, csr.data, csr.indices, csr.indptr, csr.shape)
        lib_ms = median_ms(lambda: lib @ x)
        del lib
        lo_bytes, hi_bytes = k2_bytes(p_lo, 4), k2_bytes(p_hi, 4)
        case = {"n": n, "ndiags": nd, "n_total": p_hi.n_total, "ms": ms, "f32_ms": f32_ms,
                "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": bound_ms(lo_bytes), "f32_bound_ms": bound_ms(hi_bytes),
                "err": err, "variant": K.variant(p_lo, dev),
                "f32_variant": K.variant(p_hi, dev)}
        print(f"  K2 bf16 {label}: {case['variant']} (f32: {case['f32_variant']}): "
              f"{nd} diagonals, n_total {p_hi.n_total}: graph {ms:.4f} ms "
              f"({lo_bytes / ms / 1e6:.0f} GB/s, {100 * case['bound_ms'] / ms:.0f}% of the "
              f"{case['bound_ms']:.4f} ms bound, {lo_bytes / 1e6:.1f} MB); f32 K2 graph "
              f"{f32_ms:.4f} ms ({100 * case['f32_bound_ms'] / f32_ms:.0f}% of "
              f"{case['f32_bound_ms']:.4f}); bf16 through the wrapper {wrapper_ms:.4f} ms; "
              f"plain {plain_ms:.3f} ms; torch.sparse_csr_tensor(f32) @ x {lib_ms:.4f} ms")
        stats["cases"][label] = case
        stats["err"] = max(stats["err"], err)
        del y, y_ref, p_lo, xp

        # -- the solves -------------------------------------------------------
        b = dia @ torch.ones(n, dtype=torch.float32, device=dev)
        eps_cg = 1e-4 if rel_eps is None else rel_eps * float(torch.linalg.norm(b))

        cg_kw = dict(epsilon=eps_cg, max_iterations=6000)
        timed_solve(torch, lambda: smm.cg(dia, b, **cg_kw))  # warm
        cg_res, cg_wall = timed_solve(torch, lambda: smm.cg(dia, b, **cg_kw))
        cg_true, _ = host_residuals(csr, b, cg_res.x)
        eps = 1.05 * cg_true if rel_eps is None else eps_cg
        mx_kw = dict(epsilon=eps, max_iterations=6000)
        timed_solve(torch, lambda: smm.mixed_cg(dia, b, **mx_kw))  # warm
        # the counters at 0 just before the measured solve, read just after
        K.reset_launch_counts()
        MX.reset_loop_counts()
        syncs0 = loop.host_syncs["count"]
        mx_res, mx_wall = timed_solve(torch, lambda: smm.mixed_cg(dia, b, **mx_kw))
        counts, rounds = dict(K.launches), MX.loop_counts["rounds"]
        syncs = loop.host_syncs["count"] - syncs0
        mx_true, mx_same = host_residuals(csr, b, mx_res.x)
        its = mx_res.iterations
        _, cg_split, cg_kernels = device_breakdown(torch, lambda: smm.cg(dia, b, **cg_kw), ())
        _, mx_split, mx_kernels = device_breakdown(torch, lambda: smm.mixed_cg(dia, b, **mx_kw),
                                                   ())
        cg_dev, mx_dev = sum(cg_split.values()), sum(mx_split.values())
        print(f"{label} b=A@ones eps {eps:.6e}: mixed_cg {mx_res.status_enum().name} "
              f"inner iterations {its}, rounds {rounds}, residual_norm "
              f"{float(mx_res.residual_norm):.6e}, host f64 {mx_true:.6e} (f32 {mx_same:.6e}); "
              f"wall {mx_wall:.4f} s, {1e6 * mx_wall / max(its, 1):.1f} us/iteration, device "
              f"{mx_dev / max(its, 1):.1f} us/iteration in {mx_kernels / max(its, 1):.1f} kernels, "
              f"{syncs} host syncs; launches {counts}")
        print(f"{label}: plain f32 cg eps {eps_cg:.6e} {cg_res.status_enum().name} "
              f"iterations {cg_res.iterations} floor_hit={cg_res.floor_hit}, host f64 "
              f"{cg_true:.6e}; wall {cg_wall:.4f} s, "
              f"{1e6 * cg_wall / max(cg_res.iterations, 1):.1f} us/iteration, device "
              f"{cg_dev / max(cg_res.iterations, 1):.1f} us/iteration in "
              f"{cg_kernels / max(cg_res.iterations, 1):.1f} kernels; mixed/plain wall "
              f"{mx_wall / cg_wall:.3f}")
        require(mx_res.status_enum() == smm.SolverStatus.SUCCESS and mx_true <= eps,
                f"mixed_cg {label}: SUCCESS with the host float64 residual {mx_true:.6e} <= "
                f"epsilon {eps:.6e}")
        require(tuple(mx_res.x.shape) == (n,) and bool(torch.isfinite(mx_res.x).all()),
                f"mixed_cg {label}: x finite, shape ({n},)", quiet=True)
        require(counts["dia_spmv_padded_bf16"] >= its,
                f"mixed_cg {label}: {counts['dia_spmv_padded_bf16']} K2 bf16 launches >= "
                f"{its} inner iterations")
        require(counts["dia_spmv_padded"] == 1 + 2 * rounds and counts["dia_spmv"] == 0,
                f"mixed_cg {label}: {counts['dia_spmv_padded']} f32 K2 launches = 1 + 2 x "
                f"{rounds} rounds")
        launched_lo += counts["dia_spmv_padded_bf16"]
        stats["solves"][label] = {
            "epsilon": eps, "status": mx_res.status_enum().name, "iterations": its,
            "rounds": rounds, "host_f64_residual": mx_true, "wall_s": mx_wall,
            "us_per_iteration": 1e6 * mx_wall / max(its, 1),
            "device_us_per_iteration": mx_dev / max(its, 1),
            "kernels_per_iteration": mx_kernels / max(its, 1),
            "k2_bf16_launches": counts["dia_spmv_padded_bf16"],
            "k2_f32_launches": counts["dia_spmv_padded"],
            "cg_iterations": cg_res.iterations, "cg_wall_s": cg_wall,
            "cg_us_per_iteration": 1e6 * cg_wall / max(cg_res.iterations, 1),
            "cg_device_us_per_iteration": cg_dev / max(cg_res.iterations, 1),
            "cg_kernels_per_iteration": cg_kernels / max(cg_res.iterations, 1)}

        # -- the front door: DIA kept for the bf16 stream ----------------------
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fd = smm.solve(csr, b, method="cg", auto_format=True, matrix_dtype="bfloat16",
                           epsilon=eps, max_iterations=6000)
        warned = any(issubclass(w.category, smm.PerformanceWarning)
                     and "matrix_dtype" in str(w.message) for w in seen)
        fd_true, _ = host_residuals(csr, b, fd.x)
        require(fd.status_enum() == smm.SolverStatus.SUCCESS and fd_true <= eps
                and warned == (nd <= 9),
                f"solve(csr, auto_format=True, matrix_dtype='bfloat16') {label}: SUCCESS in "
                f"{fd.iterations} inner iterations through DIA, host f64 {fd_true:.6e}; "
                f"narrow-stencil warning {'given' if warned else 'not given'} ({nd} diagonals)")
        del csr, dia, p_hi, b, cg_res, mx_res, fd
        torch.cuda.empty_cache()
    stats["launches"] = launched_lo
    first = stats["cases"]["poisson_2d(1414)"]
    stats.update({k: first[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                         "f32_ms", "wrapper_ms", "variant")})
    print(f"phase H took {time.perf_counter() - t_start:.1f} s")
    return stats


def held(smm, label, res, true64, same, eps, required):
    """The result contract of one phase-G run: SUCCESS only where the host's
    float64 true residual is at most ``eps`` (1% slack), any other status
    with a reported residual the host confirms within 1% (``same``: the
    host's residual in the solve's precision).  A ``required`` run must
    reach SUCCESS.  Returns whether the run is a confirmed SUCCESS."""
    status = res.status_enum()
    reported = float(res.residual_norm)
    if status == smm.SolverStatus.SUCCESS:
        ok = true64 <= 1.01 * eps
        if required:
            require(ok, f"{label}: SUCCESS with the host float64 residual {true64:.6e} <= "
                        f"{eps:.6e}")
        else:
            print(f"  {label}: SUCCESS {'confirmed' if ok else 'NOT confirmed'} by the host "
                  f"(float64 {true64:.6e}, epsilon {eps:.6e})")
        return ok
    require(not required, f"{label}: status {status.name} (required: SUCCESS)")
    require(abs(reported - same) <= 0.01 * same,
            f"{label}: {status.name}, residual_norm {reported:.6e} within 1% of the host's "
            f"{same:.6e}")
    return False


def lowest_modes(torch, nx: int, k: int, dev):
    """The ``k`` lowest eigenvectors of the 5-point Dirichlet Laplacian on an
    nx x nx grid, sin(p pi i / (nx + 1)) sin(q pi j / (nx + 1)), normalised,
    as an (n, k) float32 panel (the modes of ``poisson_2d``'s row order)."""
    import math

    pairs = sorted(((p, q) for p in range(1, 5) for q in range(1, 5)),
                   key=lambda pq: (pq[0] ** 2 + pq[1] ** 2, pq))[:k]
    t = torch.arange(1, nx + 1, dtype=torch.float64, device=dev) * (math.pi / (nx + 1))
    cols = []
    for p, q in pairs:
        v = torch.outer(torch.sin(q * t), torch.sin(p * t)).reshape(-1)  # row j, column i
        cols.append(v / torch.linalg.norm(v))
    return torch.stack(cols, dim=1).to(torch.float32), pairs


def launch_meter(mods):
    """Set the launch counters of the kernel modules ``mods`` to 0 and return
    (measured, counted): ``counted(run)`` calls ``run()`` as a measured run
    and returns (its result, its launches), which add to ``measured``."""
    for mod in mods:
        mod.reset_launch_counts()

    def live():
        return {k: v for mod in mods for k, v in mod.launches.items()}

    measured = dict.fromkeys(live(), 0)

    def counted(run):
        before = live()
        out = run()
        added = {k: v - before[k] for k, v in live().items()}
        for k, v in added.items():
            measured[k] += v
        return out, added

    return measured, counted


def phase_g(smm, K, loop, torch, dev, dia_solves, nx: int = 1414, m3: int = 243):
    """The solver tail at the JAX bench's sizes: GMRES(32) and its s-step form
    on ``convection_diffusion_2d(1414)`` as DIA (every matvec one K1 launch;
    bench.py:885-947), GMRES + ILU0(4) through ``solve(auto_format=True)``
    (DIA, K1, and the factors' W-SELL strict products, K7), PCG with the
    multigrid V-cycle on ``poisson_2d(1414)`` (bench.py:467-490), the 1e-8
    contract through ``solve(preconditioner="multigrid")`` on
    ``poisson_3d(243)`` (bench.py:1025-1070), Chebyshev, pipelined and
    deflated CG beside plain CG, ``lanczos_deflation_basis``, and
    ``cg_solve``'s forward and backward.  ``nx`` and ``m3`` are the 2-D and
    3-D sides (smaller ones rehearse the phase).  Returns the phase's
    readings, with ``launches``: every kernel's launches summed over the
    measured runs (warm-up runs, the profiled run and the f32 floor's
    calibration run are not counted)."""
    import importlib
    import math

    import numpy as np

    from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as D
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    G = importlib.import_module("sparse_matrix_math_tpu_torch.solvers.gmres")
    print("== phase G: the solver tail (GMRES, multigrid, Chebyshev, pipelined, deflated, "
          "cg_solve) at full width")
    t_start = time.perf_counter()
    stats = {"runs": {}}
    measured, counted = launch_meter((K, T, W, E, D))

    # -- 1. GMRES(32) on convection_diffusion_2d(1414), f32 DIA ---------------
    cd64 = smm.convection_diffusion_2d(nx, dtype=torch.float64, device=dev)
    b = torch.zeros(cd64.shape[0], dtype=torch.float64, device=dev).index_add_(
        0, cd64.row_ids, cd64.data).to(torch.float32)  # row sums: x = ones
    cd32 = cd64.astype(torch.float32)
    del cd64
    dia = smm.dia_from_csr(cd32)
    geps = 6e-4
    for label, extra in (("gmres(32)", {}), ("gmres(32) s_step=8", {"s_step": 8})):
        kw = dict(epsilon=geps, max_iterations=6000, restart=32, **extra)
        timed_solve(torch, lambda: smm.gmres(dia, b, **kw))  # warm
        syncs0 = loop.host_syncs["count"]
        G.loop_counts.update(cycles=0, matvecs=0)
        (res, wall), added = counted(lambda: timed_solve(torch, lambda: smm.gmres(dia, b, **kw)))
        k1 = added["dia_spmv"]
        syncs = loop.host_syncs["count"] - syncs0
        cycles, matvecs = G.loop_counts["cycles"], G.loop_counts["matvecs"]
        true64, same = host_residuals(cd32, b, res.x)
        its = res.iterations
        print(f"{label} convection_diffusion_2d({nx}) f32 eps {geps}: "
              f"{res.status_enum().name} iterations={its} restarts={cycles} residual_norm="
              f"{float(res.residual_norm):.6e} host f64 {true64:.6e} f32 {same:.6e}; wall "
              f"{wall:.3f} s, {1e6 * wall / max(its, 1):.1f} us per Arnoldi step, {syncs} host "
              f"syncs; K1 launches {k1} = 1 + 2 x {cycles} cycles + {matvecs} matvecs")
        held(smm, label, res, true64, same, geps, required=True)
        require(k1 == 1 + 2 * cycles + matvecs and matvecs >= its,
                f"{label}: every matvec one K1 launch ({k1})")
        stats["runs"][label] = {"status": res.status_enum().name, "iterations": its,
                                "restarts": cycles, "host_f64_residual": true64,
                                "wall_s": wall, "us_per_step": 1e6 * wall / max(its, 1),
                                "host_syncs": syncs, "k1_launches": k1}
    # where a step's device time goes: a capped run (8 cycles), timed, then
    # under the profiler (neither counted)
    groups = (("K1 dia_kernel", ("dia_kernel",)), ("panel products (cuBLAS)", ("gemv", "gemm")))
    capped = dict(epsilon=geps, max_iterations=256, restart=32)
    _, wall = timed_solve(torch, lambda: smm.gmres(dia, b, **capped))
    _, split, launches = device_breakdown(torch, lambda: smm.gmres(dia, b, **capped), groups)
    total = sum(split.values())
    print(f"  gmres(32), 256 steps under torch.profiler: wall {1e6 * wall / 256:.1f} us per "
          f"step, device {total / 256:.1f} us per step in {launches / 256:.1f} kernels: "
          + ", ".join(f"{k} {v / 256:.1f}" for k, v in split.items()))
    stats["runs"]["gmres(32) 256-step profile"] = {
        "wall_us_per_step": 1e6 * wall / 256, "device_us_per_step": total / 256,
        "kernels_per_step": launches / 256,
        **{f"{k} us_per_step": v / 256 for k, v in split.items()}}

    # GMRES + ILU0(4) through the front door: DIA operator, W-SELL strict factors
    (fd, wall), added = counted(lambda: timed_solve(torch, lambda: smm.solve(
        cd32, b, method="gmres", epsilon=geps, max_iterations=6000, preconditioner="ilu0",
        preconditioner_options={"method": "jacobi", "sweeps": 4}, auto_format=True)))
    k1, k7 = added["dia_spmv"], added["wsell_spmv"]
    true64, same = host_residuals(cd32, b, fd.x)
    label = "solve(csr, method='gmres', preconditioner='ilu0' jacobi 4, auto_format=True)"
    print(f"{label}: {fd.status_enum().name} iterations={fd.iterations} residual_norm "
          f"{float(fd.residual_norm):.6e} host f64 {true64:.6e}; wall {wall:.3f} s; K1 "
          f"launches {k1}, K7 launches {k7}")
    held(smm, label, fd, true64, same, geps, required=False)
    require(k1 >= fd.iterations and k7 >= fd.iterations,
            f"{label}: the DIA operator on K1 ({k1}) and the strict factors on K7 ({k7})")
    stats["runs"]["gmres + ilu0 front door"] = {
        "status": fd.status_enum().name, "iterations": fd.iterations,
        "host_f64_residual": true64, "wall_s": wall, "k1_launches": k1, "k7_launches": k7}
    del dia, cd32, b, fd
    torch.cuda.empty_cache()

    # -- 2. PCG with the V-cycle on poisson_2d(1414), f32 ----------------------
    p32 = smm.poisson_2d(nx, dtype=torch.float32, device=dev)
    pdia = smm.dia_from_csr(p32)
    ones = torch.ones(p32.shape[0], dtype=torch.float32, device=dev)
    b = pdia @ ones
    mg = smm.PoissonMultigrid.for_grid(nx, device=dev)
    r = torch.rand(p32.shape[0], dtype=torch.float32, device=dev)
    vcycle_ms, vcycle_graph_ms = median_ms(lambda: mg.apply(r), samples=5, calls=5), \
        graph_ms(torch, lambda: mg.apply(r), calls=5)
    kw = dict(epsilon=1e-4, max_iterations=6000, preconditioner=mg)
    timed_solve(torch, lambda: smm.cg(pdia, b, **kw))  # warm
    (res, wall), _ = counted(lambda: timed_solve(torch, lambda: smm.cg(pdia, b, **kw)))
    true64, same = host_residuals(p32, b, res.x)
    cg_its, cg_wall = dia_solves["cg poisson_2d(1414) f32"]
    label = f"pcg + multigrid poisson_2d({nx}) f32 eps 1e-4"
    print(f"{label}: {res.status_enum().name} iterations={res.iterations} floor_hit="
          f"{res.floor_hit} residual_norm {float(res.residual_norm):.6e} host f64 {true64:.6e} "
          f"f32 {same:.6e}; wall {wall:.3f} s; V-cycle apply {vcycle_ms:.3f} ms (events, "
          f"{len(mg.dims)} levels), {vcycle_graph_ms:.3f} ms from a CUDA graph; phase B's "
          f"plain CG {cg_its} iterations in {cg_wall:.3f} s")
    held(smm, label, res, true64, same, 1e-4, required=False)
    stats["runs"]["pcg multigrid"] = {
        "status": res.status_enum().name, "iterations": res.iterations,
        "floor_hit": res.floor_hit, "host_f64_residual": true64, "host_f32_residual": same,
        "wall_s": wall, "vcycle_ms": vcycle_ms, "vcycle_graph_ms": vcycle_graph_ms,
        "plain_cg_iterations": cg_its, "plain_cg_wall_s": cg_wall}
    del mg, r

    # -- 4. Chebyshev, pipelined and deflated CG beside plain CG ---------------
    eps = 1e-4 * float(torch.linalg.norm(b))
    s2 = math.sin(math.pi / (2 * (nx + 1))) ** 2
    bounds = (8.0 * s2, 8.0 * (1.0 - s2))  # the 5-point Laplacian's extreme eigenvalues
    basis, pairs = lowest_modes(torch, nx, 8, dev)
    tail = (("cg", lambda: smm.cg(pdia, b, epsilon=eps, max_iterations=20000)),
            ("chebyshev", lambda: smm.chebyshev(pdia, b, epsilon=eps, max_iterations=20000,
                                                eig_bounds=bounds)),
            ("cg_pipelined", lambda: smm.cg_pipelined(pdia, b, epsilon=eps,
                                                      max_iterations=20000)),
            ("deflated_cg", lambda: smm.deflated_cg(pdia, b, epsilon=eps, max_iterations=20000,
                                                    deflation_basis=basis)))
    for name, solve in tail:
        (res, wall), added = counted(lambda: timed_solve(torch, solve))
        k1 = added["dia_spmv"]
        true64, same = host_residuals(p32, b, res.x)
        label = f"{name} poisson_2d({nx}) f32 eps 1e-4*||b|| = {eps:.4e}"
        print(f"{label}: {res.status_enum().name} iterations={res.iterations} residual_norm "
              f"{float(res.residual_norm):.6e} host f64 {true64:.6e} f32 {same:.6e}; wall "
              f"{wall:.3f} s, {1e6 * wall / max(res.iterations, 1):.1f} us/iteration; K1 "
              f"launches {k1}")
        # pipelined CG reports its recurrence's residual, as in the JAX package
        if name == "cg_pipelined" and res.status_enum() != smm.SolverStatus.SUCCESS:
            print(f"  {label}: residual_norm is the recurrence's (host {same:.6e})")
            confirmed = False
        else:
            confirmed = held(smm, label, res, true64, same, eps, required=False)
        if name != "cg":
            require(k1 >= res.iterations, f"{name}: its matvecs on K1 ({k1} launches)",
                    quiet=True)
        stats["runs"][name] = {"status": res.status_enum().name, "confirmed": confirmed,
                               "iterations": res.iterations, "host_f64_residual": true64,
                               "wall_s": wall, "k1_launches": k1}
    print(f"  deflation basis: the modes (p, q) = {pairs}")

    # lanczos_deflation_basis at tests/test_deflated.py's size: the f32 ring
    n = 128
    i = np.arange(n)
    d = np.zeros((n, n), np.float32)
    d[i, i] = 2.0 + 1e-5
    d[i, (i + 1) % n] = -1.0
    d[i, (i - 1) % n] = -1.0
    ring = smm.csr_from_dense(d, device=dev)
    rb = torch.as_tensor(np.random.default_rng(2).standard_normal(n).astype(np.float32),
                         device=dev)

    def ring_runs():
        w = smm.lanczos_deflation_basis(ring, n_vectors=1, steps=96)
        return (w, smm.deflated_cg(ring, rb, epsilon=1e-5, max_iterations=5000,
                                   deflation_basis=w),
                smm.cg(ring, rb, epsilon=1e-5, max_iterations=5000))

    (w, defl, plain), _ = counted(ring_runs)
    overlap = abs(float(w[:, 0].sum())) / math.sqrt(n)
    require(tuple(w.shape) == (n, 1) and overlap > 1 - 1e-3 and defl.success
            and defl.iterations < plain.iterations,
            f"lanczos_deflation_basis on the f32 ring (n=128, 96 steps): the constant mode "
            f"(overlap {overlap:.6f}); deflated_cg {defl.iterations} iterations against plain "
            f"cg's {plain.iterations}")
    del basis, w, ring

    # -- 5. cg_solve forward and backward, poisson_2d(1414) f32 DIA -------------
    # eps: twice the true residual at which f32 CG with b = ones stalls on
    # this system (its floor, measured here by a run that floor_hit stops)
    floor_run = smm.cg(pdia, ones, epsilon=1.0, max_iterations=20000)
    floor64, _ = host_residuals(p32, ones, floor_run.x)
    ceps = 2.0 * floor64
    print(f"  f32 cg poisson_2d({nx}) b = ones, eps 1.0: {floor_run.status_enum().name} "
          f"floor_hit={floor_run.floor_hit} after {floor_run.iterations} iterations, residual_norm "
          f"{float(floor_run.residual_norm):.6e}, host f64 {floor64:.6e}")
    diags = pdia.diags.clone().requires_grad_(True)
    a = dataclasses.replace(pdia, diags=diags)
    bb = ones.clone().requires_grad_(True)

    def forward_backward():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = smm.cg_solve(a, bb, ceps, 20000)
        x.backward(ones)
        torch.cuda.synchronize()
        return x.detach(), time.perf_counter() - t0

    (x, wall), added = counted(forward_backward)
    k2, lam = added["dia_spmv_padded"], bb.grad
    fwd, _ = host_residuals(p32, ones, x)  # ||b - A x||, float64 on the host
    adj, _ = host_residuals(p32, ones, lam)  # ||g - A grad_b||
    # the matrix cotangent, -lam[i] x[i + off] where the column is valid,
    # worked out in float64 on the host from the same x and lam: one f32
    # product per entry, so within half an ulp of each
    lam64, x64 = lam.double().cpu().numpy(), x.double().cpu().numpy()
    ref = np.zeros(tuple(diags.shape))
    for row, off in enumerate(pdia.offsets):
        lo, hi = max(0, -off), min(len(x64), len(x64) - off)
        ref[row, lo:hi] = -lam64[lo:hi] * x64[lo + off:hi + off]
    got = diags.grad.double().cpu().numpy()
    gerr, gtol = float(np.abs(got - ref).max()), 4 * 2.0 ** -23 * float(np.abs(ref).max())
    require(bool(torch.isfinite(lam).all()) and fwd <= ceps and adj <= ceps,
            f"cg_solve poisson_2d({nx}) f32 DIA, b = g = ones, eps {ceps:.4e}: "
            f"||b - A x|| = {fwd:.4e}, ||A grad_b - g|| = {adj:.4e} <= eps in float64; "
            f"forward + backward {wall:.3f} s, {k2} K2 launches")
    require(tuple(got.shape) == tuple(diags.shape) and gerr <= gtol,
            f"cg_solve: diags.grad {tuple(got.shape)} against -lam[i] x[i + off] in float64 on "
            f"the host: max |err| {gerr:.3e} <= 4 f32 ulps of the largest entry ({gtol:.3e})")
    stats["runs"]["cg_solve"] = {"epsilon": ceps, "f32_floor": floor64,
                                 "floor_iterations": floor_run.iterations,
                                 "forward_residual": fwd, "adjoint_residual": adj,
                                 "diags_grad_max_err": gerr, "wall_s": wall, "k2_launches": k2}
    del diags, a, bb, x, lam, ref, got, floor_run, pdia, p32, b
    torch.cuda.empty_cache()

    # -- 3. the 1e-8 contract: poisson_3d(243) through the front door ----------
    p3 = smm.poisson_3d(m3, dtype=torch.float64, device=dev)
    data, indices, indptr = host_csr_arrays(p3)
    st = smm.try_grid_stencil_from_csr(p3.astype(torch.float32))
    del p3
    torch.cuda.empty_cache()
    b64 = np.add.reduceat(data, indptr[:-1])  # row sums: x = ones
    b32 = torch.as_tensor(b64.astype(np.float32), device=dev)
    (res, wall), _ = counted(lambda: timed_solve(torch, lambda: smm.solve(
        st, b32, method="cg", epsilon=1e-8, preconditioner="multigrid", max_iterations=60000)))
    x64 = res.x_f64()
    true64 = float(np.linalg.norm(b64 - np.add.reduceat(data * x64[indices], indptr[:-1])))
    label = f"solve(poisson_3d({m3}) stencil, f32 b, eps 1e-8, preconditioner='multigrid')"
    print(f"{label}: {type(res).__name__} {res.status_enum().name} rounds={res.outer_rounds} "
          f"inner iterations={res.iterations} host f64 {true64:.6e}; wall {wall:.3f} s")
    require(isinstance(res, smm.DfSolveResult) and res.status == smm.SolverStatus.SUCCESS
            and true64 <= 1.01e-8,
            f"{label}: pre-routed to the refinement with the V-cycle inside, SUCCESS with the "
            f"host float64 residual {true64:.4e} <= 1e-8")
    stats["runs"][f"contract 1e-8 poisson_3d({m3})"] = {
        "status": res.status_enum().name, "rounds": res.outer_rounds,
        "inner_iterations": res.iterations, "host_f64_residual": true64, "wall_s": wall}
    del st, b32, res, data, indices, indptr
    torch.cuda.empty_cache()

    stats["launches"] = measured
    stats["seconds"] = time.perf_counter() - t_start
    require(measured["dia_spmv"] > 0, f"phase G's measured runs launched K1 "
                                      f"{measured['dia_spmv']} times")
    print(f"phase G launches (measured runs): {measured}; phase G took "
          f"{stats['seconds']:.1f} s")
    return stats


def write_mtx(path, csr):
    """The lower triangle of a symmetric CSR matrix as a MatrixMarket
    coordinate real symmetric file (1-based indices), written in bulk."""
    import numpy as np

    rows, cols = csr.row_ids.cpu().numpy(), csr.indices.cpu().numpy()
    keep = rows >= cols
    table = np.column_stack([rows[keep] + 1, cols[keep] + 1,
                             csr.data.cpu().numpy().astype(np.float64)[keep]])
    np.savetxt(path, table, fmt=["%d", "%d", "%.17g"], comments="",
               header=f"%%MatrixMarket matrix coordinate real symmetric\n"
                      f"{csr.shape[0]} {csr.shape[1]} {int(keep.sum())}")


def run_example(name, dev):
    """Run ``examples/<name>.py``'s ``main`` in this process at its default
    size, as ``python examples/<name>.py`` runs it (with ``--cpu`` when
    ``dev`` is the CPU); its printed lines, also printed here."""
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location(name, os.path.join(_ROOT, "examples",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    argv = sys.argv
    sys.argv = [f"{name}.py"] + ([] if dev.type == "cuda" else ["--cpu"])
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = argv
    text = out.getvalue()
    for line in text.splitlines():
        print(f"  {name}: {line}")
    print(f"  {name}: {time.perf_counter() - t0:.1f} s")
    return text


def phase_u(smm, K, torch, dev, earlier, routed, cg_f64_its, nx: int = 1414,
            chunk: int = 500):
    """The last single-process modules at the bench system's size
    (``poisson_2d(1414)``): ``spmv_throughput`` for CSR, DIA (K1), ELL (K6)
    and W-SELL (K7) in f32 and for phase R's routed chain (K11 per pass,
    then K7), each beside the same product's time from a CUDA graph on the
    same inputs (a reading below it would be a missing sync) and the
    earlier phases' readings in ``earlier`` (name: (what, ms)); then
    ``solve_with_stats(cg)`` on DIA in f64 beside a plain ``cg``;
    ``checkpointed_solve`` at chunk 500, uninterrupted and stopped after two
    chunks then resumed from the file; ``trace`` around 3 CG iterations;
    the CLI as subprocesses on a ``poisson_2d(256)`` ``.mtx`` written here;
    and the six ``examples/torch_*.py`` at their default sizes.  ``nx`` and
    ``chunk`` are the grid side and the checkpoint chunk (smaller ones
    rehearse the phase).  Returns the
    phase's readings, with ``launches``: every kernel's launches over the
    measured runs (the graph captures are not counted)."""
    import glob
    import json as _json
    import tempfile

    from sparse_matrix_math_tpu_torch.ops import dia_spmv_df as D
    from sparse_matrix_math_tpu_torch.ops import ell_spmv as E
    from sparse_matrix_math_tpu_torch.ops import stream_gather as R
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W
    from sparse_matrix_math_tpu_torch.utils.profiling import trace

    print("== phase U: profiling, checkpoint and resume, the CLI and the examples")
    t_start = time.perf_counter()
    stats = {"throughput": {}}

    # -- 1. spmv_throughput per format, beside the same product's graph time ---
    t0 = time.perf_counter()
    p32 = smm.poisson_2d(nx, dtype=torch.float32, device=dev)
    ops = {"csr": p32, "dia": smm.dia_from_csr(p32), "ell": smm.ell_from_csr(p32),
           "wsell": smm.wsell_from_csr(p32), "routed": routed}
    torch.cuda.synchronize()
    print(f"poisson_2d({nx}) f32 as CSR, DIA, ELL and W-SELL in {time.perf_counter() - t0:.1f} s; "
          f"the routed chain is phase R's (uniform_random_csr(2_000_000, per_row=5))")
    graph = {}
    for name, op in ops.items():
        x = torch.ones(op.shape[1], dtype=op.dtype, device=dev)
        graph[name] = graph_ms(torch, lambda: smm.rmult(op, x))

    measured, counted = launch_meter((K, T, W, E, D, R))
    calls = 20 + 2  # spmv_throughput's timed products and its warm-up
    expect = {"csr": {}, "dia": {"dia_spmv": calls}, "ell": {"ell_spmv": calls},
              "wsell": {"wsell_spmv": calls},
              "routed": {"stream_gather": calls * len(routed.passes), "wsell_spmv": calls}}
    for name, op in ops.items():
        st, added = counted(lambda: smm.spmv_throughput(op))
        ms = 1e3 * st["seconds_per_op"]
        what, e_ms = earlier.get(name, ("", None))
        beside = f"; {what} {e_ms:.4f} ms" if e_ms is not None else ""
        print(f"  spmv_throughput({type(op).__name__}, nnz={op.nnz}): {ms:.4f} ms per op "
              f"({st['gnnz_per_s']:.2f} GNNZ/s, {st['gflop_per_s']:.2f} GFLOP/s); the same "
              f"product from a CUDA graph {graph[name]:.4f} ms{beside}")
        require(set(st) == {"seconds_per_op", "gnnz_per_s", "gflop_per_s"}
                and st["gnnz_per_s"] > 0
                and abs(st["gflop_per_s"] - 2 * st["gnnz_per_s"]) <= 1e-12 * st["gflop_per_s"],
                f"spmv_throughput({name}): the JAX package's three keys, positive rates",
                quiet=True)
        # the graph replays the same launches with no host between them: a
        # wrapper reading under it (beyond the replays' 5% spread) would
        # mean the timed loop ended before the card did
        require(ms >= 0.95 * graph[name],
                f"spmv_throughput({name}): {ms:.4f} ms per op is not below the product's "
                f"graph time {graph[name]:.4f} ms")
        require(all(added[k] == v for k, v in expect[name].items()),
                f"spmv_throughput({name}) launched {expect[name] or 'no kernel'}: "
                f"{ {k: v for k, v in added.items() if v} }")
        stats["throughput"][name] = {**st, "graph_ms": graph[name]}
    d32 = ops["dia"]
    del ops

    # -- 2. solve_with_stats(cg) on DIA, f64, beside a plain cg -----------------
    p64 = smm.poisson_2d(nx, dtype=torch.float64, device=dev)
    dia64 = smm.dia_from_csr(p64)
    b = dia64 @ torch.ones(dia64.shape[0], dtype=torch.float64, device=dev)
    kw = dict(epsilon=1e-8, max_iterations=20000)
    ss, added = counted(lambda: smm.solve_with_stats(smm.cg, dia64, b, **kw))
    (plain, plain_s), _ = counted(lambda: timed_solve(torch, lambda: smm.cg(dia64, b, **kw)))
    rate = ss.iterations * dia64.nnz / ss.wall_seconds / 1e9
    print(f"  solve_with_stats(cg, DIA f64): {ss!r}, {ss.spmv_gnnz_per_s:.3f} GNNZ/s; plain cg "
          f"{plain.status_enum().name} in {plain.iterations} iterations, {plain_s:.3f} s "
          f"(phase B's cg f64 {cg_f64_its}); {added['dia_spmv_padded']} K2 launches in the "
          f"warm and timed solves")
    require(ss.status == plain.status == smm.SolverStatus.SUCCESS
            and ss.iterations == plain.iterations,
            f"solve_with_stats(cg): SUCCESS in {ss.iterations} iterations, as plain cg")
    require(abs(ss.spmv_gnnz_per_s - rate) <= 1e-9 * rate,
            f"solve_with_stats(cg): spmv_gnnz_per_s {ss.spmv_gnnz_per_s:.6f} = iterations x nnz "
            f"/ wall")
    require(added["dia_spmv_padded"] >= 2 * ss.iterations,
            f"solve_with_stats(cg): K2 launched {added['dia_spmv_padded']} >= 2 x "
            f"{ss.iterations} times")
    stats["solve_with_stats"] = {"iterations": ss.iterations, "wall_s": ss.wall_seconds,
                                 "gnnz_per_s": ss.spmv_gnnz_per_s, "plain_cg_s": plain_s}

    with tempfile.TemporaryDirectory() as tmp:
        # -- 3. checkpointed_solve in chunks: whole, and stopped then resumed ----
        kw = dict(chunk_iterations=chunk, epsilon=1e-8, max_iterations=40000)

        class Preempted(Exception):
            pass

        def stopping_after(n):
            done = [0]

            def run(*args, **kwargs):
                if done[0] == n:
                    raise Preempted
                done[0] += 1
                return smm.cg(*args, **kwargs)
            return run

        whole_path, cut_path = os.path.join(tmp, "whole.npz"), os.path.join(tmp, "cut.npz")
        (whole, whole_s), _ = counted(lambda: timed_solve(torch, lambda: smm.checkpointed_solve(
            smm.cg, dia64, b, checkpoint_path=whole_path, **kw)))
        try:
            counted(lambda: smm.checkpointed_solve(stopping_after(2), dia64, b,
                                                   checkpoint_path=cut_path, **kw))
            raise CheckFailed("the stopping solver was not stopped")
        except Preempted:
            pass
        saved = smm.load_checkpoint(cut_path).iterations_done
        (resumed, resumed_s), _ = counted(lambda: timed_solve(torch, lambda: smm.checkpointed_solve(
            smm.cg, dia64, b, checkpoint_path=cut_path, **kw)))
        bitwise = bool(torch.equal(whole.x, resumed.x))
        rel = float((whole.x - resumed.x).norm() / whole.x.norm())
        t_whole, t_resumed = (host_residuals(p64, b, r.x)[0] for r in (whole, resumed))
        print(f"  checkpointed_solve(cg, chunk {chunk}) f64: uninterrupted {whole!r} in "
              f"{whole_s:.2f} s (host f64 {t_whole:.4e}); stopped after two chunks ({saved} "
              f"iterations saved), resumed {resumed!r} in {resumed_s:.2f} s (host f64 "
              f"{t_resumed:.4e}); x bit for bit: {bitwise} (relative difference {rel:.3e})")
        require(saved == 2 * chunk,
                f"checkpoint after two chunks holds {saved} = {2 * chunk} iterations")
        require(whole.status == resumed.status == smm.SolverStatus.SUCCESS
                and whole.iterations == resumed.iterations,
                f"checkpointed_solve: resumed run SUCCESS in {resumed.iterations} iterations, "
                f"as the uninterrupted one")
        require(bitwise or rel <= 1e-12,
                f"checkpointed_solve: resumed x {'bit for bit' if bitwise else 'within 1e-12'} "
                f"the uninterrupted one")
        require(max(t_whole, t_resumed) <= 1e-8,
                f"checkpointed_solve: host float64 residuals {t_whole:.4e}, {t_resumed:.4e} "
                f"<= 1e-8")
        stats["checkpoint"] = {"iterations": whole.iterations, "whole_s": whole_s,
                               "resumed_s": resumed_s, "x_bitwise": bitwise, "x_rel": rel}
        del dia64, p64, b

        # -- 4. trace around 3 CG iterations on DIA f32 --------------------------
        b32 = d32 @ torch.ones(d32.shape[0], dtype=torch.float32, device=dev)
        trace_dir = os.path.join(tmp, "trace")
        with trace(trace_dir):
            counted(lambda: smm.cg(d32, b32, epsilon=1e-12, max_iterations=3))
        files = glob.glob(os.path.join(trace_dir, "trace.*.json"))
        require(len(files) == 1, f"trace wrote one Chrome trace ({len(files)} files)")
        with open(files[0]) as f:
            kernels = {e.get("name", "") for e in _json.load(f)["traceEvents"]
                       if e.get("cat") == "kernel"}
        k2 = sorted(n for n in kernels if "dia_staged_kernel" in n or "dia_padded_kernel" in n)
        print(f"  trace: {os.path.getsize(files[0])} bytes, {len(kernels)} kernel names, K2 as "
              f"{k2[:1]}")
        require(bool(k2), "trace names the K2 kernel")
        del d32, b32

        # -- 5. the CLI as subprocesses on a poisson_2d(256) .mtx ----------------
        mtx = os.path.join(tmp, "poisson_2d_256.mtx")
        write_mtx(mtx, smm.poisson_2d(256, device="cpu"))
        cli = {"info": ["info", mtx], "solve": ["solve", mtx],
               "bench-spmv": ["bench-spmv", mtx, "--routed"]}
        t0 = time.perf_counter()
        on = [] if dev.type == "cuda" else ["--device", str(dev)]  # the card is the default
        procs = {k: subprocess.Popen([sys.executable, "-m", "sparse_matrix_math_tpu_torch", *on,
                                      *a], cwd=_ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, a in cli.items()}
        outs = {}
        for k, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            require(proc.returncode == 0, f"CLI {k}: exit code {proc.returncode} ({err[-500:]})")
            outs[k] = _json.loads(out.strip().splitlines()[-1])
            print(f"  python -m sparse_matrix_math_tpu_torch {' '.join(cli[k][:1] + cli[k][2:])}: "
                  f"{out.strip().splitlines()[-1]}")
        print(f"  the CLI's three commands side by side in {time.perf_counter() - t0:.1f} s")
        require(outs["info"]["shape"] == [65536, 65536] and outs["info"]["symmetric_pattern"]
                and outs["info"]["dtype"] == "float64",
                "CLI info: shape, dtype and symmetric pattern")
        require(outs["solve"]["status"] == "SUCCESS", "CLI solve: SUCCESS")
        require(all(isinstance(outs["bench-spmv"].get(k), dict)
                    and outs["bench-spmv"][k]["gnnz_per_s"] > 0 for k in ("dia", "ell", "wsell"))
                and "rsell" in outs["bench-spmv"],
                "CLI bench-spmv --routed reports dia, ell and wsell (and rsell)")
        stats["cli"] = outs

    # -- 6. the six examples at their default sizes on the card ------------------
    checks = {
        # at 256 the f32 IC0 solve floors and escalates: a DfSolveResult
        "torch_poisson_solve": ["PCG+IC0: ", "status=SUCCESS"],
        "torch_unstructured_solve": ["auto-format CG: status=0", "statuses=[0, 0, 0, 0]",
                                     "nonsymmetric BiCGStab+SGS: status=0",
                                     "nonsymmetric GMRES+ILU0: status=0"],
        "torch_multigrid_solve": ["PCG+V-cycle", "iterations"],
        "torch_df64_solve": ["cg_df64: status=SUCCESS", "cg_ir_df64 (+mg inner): status=SUCCESS"],
        "torch_accuracy_autopilot": ["floor_hit = ", "DfSolveResult SUCCESS"],
        "torch_poisson3d_1e8": ["SUCCESS"],
    }
    for name, want in checks.items():
        text, added = counted(lambda: run_example(name, dev))
        require(all(w in text for w in want), f"{name}: prints {want}")
        if name == "torch_df64_solve":
            line = [ln for ln in text.splitlines() if "true residual (host f64)" in ln][0]
            require(float(line.split(":")[1]) <= 1e-10, f"{name}: {line.strip()}")
        print(f"  {name} launches: { {k: v for k, v in added.items() if v} }")

    stats["launches"] = measured
    stats["seconds"] = time.perf_counter() - t_start
    for kname in ("dia_spmv", "dia_spmv_padded", "ell_spmv", "wsell_spmv", "stream_gather",
                  "dia_spmv_padded_df"):
        require(measured[kname] > 0, f"phase U launched {kname} {measured[kname]} times",
                quiet=True)
    print(f"phase U launches (measured runs): {measured}; phase U took "
          f"{stats['seconds']:.1f} s")
    return stats


def phase_c(smm, torch, dev):
    """A small solve against scipy's direct solve."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    print("== phase C: small solve against a direct reference")
    csr = smm.poisson_2d(64, dtype=torch.float64, device=dev)
    b_h = np.random.default_rng(0).standard_normal(csr.shape[0])
    a_h = sp.csr_matrix((csr.data.cpu().numpy(), csr.indices.cpu().numpy(),
                         csr.indptr.cpu().numpy()), shape=csr.shape)
    x_ref = spla.spsolve(a_h.tocsc(), b_h)
    dia = smm.dia_from_csr(csr)
    for solver in (smm.cg, smm.bicgstab):
        res = solver(dia, torch.as_tensor(b_h, device=dev), epsilon=1e-10)
        err = float(np.abs(res.x.cpu().numpy() - x_ref).max())
        require(res.success and err < 1e-8,
                f"{solver.__name__} poisson_2d(64) f64: max |x - x_direct| {err:.2e} < 1e-8")


# iterations of the torch.profiler window that reads a solve's device time
_WINDOW = 256


def single_case(torch, ref, csr, b, groups):
    """The single-device solve that the distributed solves of one system are
    held against, read once: ``ref(m)`` solves with ``max_iterations=m``
    (None: the phase's cap), timed once by the host clock, then a
    ``_WINDOW``-iteration solve under torch.profiler."""
    res, wall = timed_solve(torch, lambda: ref(None))
    win, dev_us, dev_n = device_breakdown(torch, lambda: ref(_WINDOW), groups)
    return {"res": res, "wall": wall, "window_its": max(win.iterations, 1),
            "dev_us": dev_us, "dev_n": dev_n, "host64": host_residuals(csr, b, res.x)[0]}


def dist_case(smm, torch, par, label, d, dist, single, csr, b, eps, band_of, groups, *,
              repeat=False):
    """One distributed solve at world size 1 against ``single`` (the
    :func:`single_case` reading of the same system), through the public
    entry point: ``dist(m)`` solves with ``max_iterations=m`` (None: the
    phase's cap).  The full solve is timed once by the host clock and its
    collectives counted, then a ``_WINDOW``-iteration solve is read under
    torch.profiler.  Holds the status, the iterations within
    ``band_of(the single-device iterations)``, an interval, and the host's
    float64 true residual (at most 1.01 eps for a float64 SUCCESS; for
    float32, at most twice the larger of eps and the single-device
    solve's); with ``repeat``, a second full solve must return the same
    iterations and x bit for bit.  One printed line; the readings."""
    import numpy as np

    M = par.mesh
    M.reset_collective_counts()
    res, wall = timed_solve(torch, lambda: dist(None))
    coll = dict(M.collectives)
    by_count = {}
    win, dev_us, dev_n = device_breakdown(torch, lambda: dist(_WINDOW), groups, by_count)
    one, one_wall, ref_us, ref_n = single["res"], single["wall"], single["dev_us"], single["dev_n"]
    x = par.collect(res.x, d)
    require(x.shape == (csr.shape[0],) and bool(np.isfinite(x).all()),
            f"{label}: x finite, shape {x.shape}", quiet=True)
    true64, _ = host_residuals(csr, b, torch.from_numpy(x))
    one64 = single["host64"]
    its, w_its, o_its = res.iterations, max(win.iterations, 1), single["window_its"]
    f64 = csr.dtype == torch.float64
    per_it = {k: round(v / max(its, 1), 3) for k, v in coll.items()}
    reading = {
        "status": res.status_enum().name, "iterations": its, "floor_hit": res.floor_hit,
        "single_status": one.status_enum().name, "single_iterations": one.iterations,
        "host_f64_residual": true64, "single_host_f64_residual": one64,
        "wall_s": wall, "single_wall_s": one_wall,
        "wall_us_per_iteration": 1e6 * wall / max(its, 1),
        "single_wall_us_per_iteration": 1e6 * one_wall / max(one.iterations, 1),
        "device_us_per_iteration": sum(dev_us.values()) / w_its,
        "single_device_us_per_iteration": sum(ref_us.values()) / o_its,
        "device_us_by_kernel_per_iteration": {k: v / w_its for k, v in dev_us.items()},
        "single_device_us_by_kernel_per_iteration": {k: v / o_its for k, v in ref_us.items()},
        "kernels_per_iteration": dev_n / w_its, "single_kernels_per_iteration": ref_n / o_its,
        "collectives": coll, "collectives_per_iteration": per_it,
        "window_iterations": w_its, "window_launches": by_count,
    }
    print(f"{label}: {reading['status']} iterations={its} floor_hit={res.floor_hit} host f64 "
          f"{true64:.6e} (single device: {reading['single_status']} {one.iterations}, "
          f"{one64:.6e}); wall {reading['wall_us_per_iteration']:.1f} us/iteration (single "
          f"{reading['single_wall_us_per_iteration']:.1f}); device "
          f"{reading['device_us_per_iteration']:.1f} us/iteration in "
          f"{reading['kernels_per_iteration']:.1f} kernels (single "
          f"{reading['single_device_us_per_iteration']:.1f} in "
          f"{reading['single_kernels_per_iteration']:.1f}); by kernel "
          + ", ".join(f"{k} {v:.1f}"
                      for k, v in reading["device_us_by_kernel_per_iteration"].items())
          + f"; collectives per iteration {per_it}")
    require(res.status == one.status and res.floor_hit == one.floor_hit,
            f"{label}: status {reading['status']} (floor_hit {res.floor_hit}) as the single-device "
            f"solve's {reading['single_status']} (floor_hit {one.floor_hit})")
    lo, hi = band_of(one.iterations)
    require(lo <= its <= hi,
            f"{label}: {its} iterations in [{lo}, {hi}] (the single-device solve: "
            f"{one.iterations})")
    if f64 and res.success:
        require(true64 <= 1.01 * eps, f"{label}: host f64 residual {true64:.4e} <= {eps} (+1%)")
    elif not f64:
        require(true64 <= 2 * max(eps, one64),
                f"{label}: host f64 residual {true64:.4e} <= 2 x max(eps, single's {one64:.4e})")
    if repeat:
        again = dist(None)
        require(again.iterations == its and bits_equal(torch, again.x, res.x),
                f"{label}: a second solve on the same b repeats it ({again.iterations} "
                f"iterations, x bit for bit)")
    return reading


def phase_x_modules(smm, W, torch, par, mesh, dev, groups, routed, n_r: int = 2_000_000,
                    nx: int = 1414, m3: int = 243):
    """Phase X's solves of the last three distributed modules, each held
    against the single-device solve of the same system: ``dist_routed_solve``
    (BiCGStab f32 on phase R's system, b = A·ones, eps 1e-4; K11 per pass and
    K7 last in the shard), ``dist_cg_ir_df64`` (phase D's ``poisson_2d(nx)``
    to 1e-10) and ``dist_mg_solve`` (PCG f32 with the distributed V-cycle on
    phase G's ``poisson_3d(m3)``).  ``routed`` is phase R's single-device
    chain of the system (None: built here).  Returns the readings and the
    K11 and K7 launches of the routed solve."""
    import numpy as np

    from sparse_matrix_math_tpu_torch.ops import sell_spmv as S
    from sparse_matrix_math_tpu_torch.ops import stream_gather as R

    out = {}
    t_start = time.perf_counter()
    # -- dist_rsell: the routed chain in the shard (K11 per pass, K7 last) ------
    t0 = time.perf_counter()
    u32 = smm.uniform_random_csr(n_r, per_row=5, dtype=torch.float32, device=dev)
    ones = torch.ones(n_r, dtype=torch.float32, device=dev)
    bu = u32 @ ones
    if routed is None:
        routed = smm.routed_from_csr(u32, max_slot_ratio=16.0)
    t1 = time.perf_counter()
    du = par.distribute_routed(u32, mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    loc = du.local
    print(f"uniform_random_csr({n_r}, per_row=5) f32: distribute_routed on the host in "
          f"{t2 - t1:.1f} s: block {du.block_rows}, {du.n_passes} passes of "
          f"{[p.n_vregs for p in loc.passes]} vregs, final {loc.final.n_vregs} vregs nway "
          f"{du.final_nway}, slot_ratio {du.slot_ratio:.3f} (single device: "
          f"{len(routed.passes)} passes of {[p.n_vregs for p in routed.passes]} vregs, final "
          f"{routed.final.n_vregs} nway {routed.final.nway}, {routed.slot_ratio:.3f})")
    xl = torch.as_tensor(np.random.default_rng(2).standard_normal(du.block_rows),
                         device=dev).to(torch.float32)
    R.reset_launch_counts()
    W.reset_launch_counts()
    y = par.dist_routed_spmv(du, xl)
    torch.cuda.synchronize()
    require(R.launches["stream_gather"] == du.n_passes and W.launches["wsell_spmv"] == 1,
            f"dist_routed_spmv: {R.launches['stream_gather']} K11 launches (one per pass) and "
            f"{W.launches['wsell_spmv']} K7 launch")
    t = xl  # the all-gathered x of a world of one rank
    for p in loc.passes:
        t = R.stream_gather_plain(p.base, p.meta, p.vals, t, x_rows=p.x_rows,
                                  window_f=p.window_f)
    require(bits_equal(torch, y, S.sell_spmv_plain(loc.final.sell, t)),
            "dist_routed_spmv shard product (the all-gather, K11 per pass, K7) bit for bit "
            "the chain's plain versions (stream_gather_plain, sell_spmv_plain)")
    kw = dict(epsilon=1e-4, max_iterations=2000)
    label = f"dist_routed_solve bicgstab uniform_random({n_r}) f32"
    R.reset_launch_counts()
    W.reset_launch_counts()
    gathers = par.mesh.collectives["all_gather"]
    res, wall = timed_solve(torch, lambda: par.dist_routed_solve(du, bu, solver="bicgstab",
                                                                   **kw))
    products = par.mesh.collectives["all_gather"] - gathers
    k11, k7 = R.launches["stream_gather"], W.launches["wsell_spmv"]
    print(f"{label}: {res.status_enum().name} in {res.iterations} iterations, {wall:.3f} s; "
          f"K11 launches {k11}, K7 {k7}, products (all-gathers) {products}")
    require(k7 == products > res.iterations and k11 == du.n_passes * products,
            f"{label}: {du.n_passes + 1} launches per product ({k11} K11 = {du.n_passes} x "
            f"{products} products, {k7} K7)")

    def band(frac, least):
        def interval(its):
            w = max(least, int(np.ceil(frac * its)))
            return its - w, its + w
        return interval

    # the f32 solve ends at its precision floor (||r|| ~6e-4 > eps): the exit
    # after the verified restarts moves with the summation order, as phase R's
    # f32 front-door solves do: max(4, 25%)
    single = single_case(torch, lambda m: smm.bicgstab(routed, bu, **(
        kw if m is None else dict(kw, max_iterations=m))), u32, bu, groups)
    out[label] = dist_case(smm, torch, par, label, du, lambda m: par.dist_routed_solve(
        du, bu, solver="bicgstab", **(kw if m is None else dict(kw, max_iterations=m))),
        single, u32, bu, 1e-4, band(0.25, 4), groups)
    wl = out[label]["window_launches"]
    require(wl["K11 stream_gather"] == du.n_passes * wl["K7 sell_kernel"] > 0,
            f"{label}: torch.profiler sees {wl['K11 stream_gather']} K11 and "
            f"{wl['K7 sell_kernel']} K7 launches in the window, {du.n_passes} + 1 per product")
    out[label].update(k11_launches=k11, k7_launches=k7, products=products,
                      passes=du.n_passes, slot_ratio=du.slot_ratio,
                      single_slot_ratio=routed.slot_ratio, build_s=t2 - t1)
    launches = {"stream_gather": k11, "wsell_spmv": k7}
    del du, u32, bu, ones, routed, y, t, xl
    torch.cuda.empty_cache()

    # -- dist_df64: the refinement to 1e-10 on phase D's system -------------------
    p64 = smm.poisson_2d(nx, device=dev)
    data, indices, indptr = host_csr_arrays(p64)
    dfa = smm.df_operator_from_host_csr(data, indices, indptr, p64.shape, device=dev)
    b64 = np.add.reduceat(data, indptr[:-1])  # A @ ones in float64
    ddf = par.distribute_df_dia(dfa, mesh)
    fkw = dict(epsilon=1e-10, max_iterations=30000)
    label = f"dist_cg_ir_df64 poisson_2d({nx}) eps 1e-10"
    reading = {}
    for name, solve in (("single", lambda: smm.cg_ir_df64(dfa, b64, **fkw)),
                        ("dist", lambda: par.dist_cg_ir_df64(ddf, b64, **fkw))):
        par.mesh.reset_collective_counts()
        r, w = timed_solve(torch, solve)
        x = r.x_f64()
        true64 = float(np.linalg.norm(b64 - np.add.reduceat(data * x[indices], indptr[:-1])))
        reading[name] = {"status": r.status_enum().name, "rounds": r.outer_rounds,
                         "inner_iterations": r.iterations, "host_f64_residual": true64,
                         "wall_s": w, "wall_us_per_inner_iteration": 1e6 * w / max(r.iterations, 1),
                         "collectives": dict(par.mesh.collectives)}
        print(f"{label} {name}: {r!r} in {r.outer_rounds} rounds, host f64 {true64:.6e}; wall "
              f"{w:.3f} s, {reading[name]['wall_us_per_inner_iteration']:.1f} us per inner "
              f"iteration; collectives {reading[name]['collectives']}")
        require(x.shape == (nx * nx,) and bool(np.isfinite(x).all()), f"{label} {name}: x finite",
                quiet=True)
    one, got = reading["single"], reading["dist"]
    lo, hi = band(0.10, 3)(one["inner_iterations"])
    require(got["status"] == one["status"] and abs(got["rounds"] - one["rounds"]) <= 1
            and lo <= got["inner_iterations"] <= hi,
            f"{label}: {got['status']} in {got['rounds']} rounds, {got['inner_iterations']} inner "
            f"iterations, as the single-device {one['status']} in {one['rounds']} rounds (within "
            f"1), {one['inner_iterations']} (within [{lo}, {hi}])")
    if got["status"] == "SUCCESS":
        require(got["host_f64_residual"] <= 1.01e-10,
                f"{label}: host f64 residual {got['host_f64_residual']:.4e} <= 1e-10 (+1%)")
    out[label] = reading
    del p64, dfa, ddf, data, indices, indptr, b64
    torch.cuda.empty_cache()

    # -- dist_multigrid: PCG with the distributed V-cycle on phase G's 3-D system -
    p3 = smm.poisson_3d(m3, dtype=torch.float32, device=dev)
    b3 = p3 @ torch.ones(p3.shape[0], dtype=torch.float32, device=dev)
    mg = smm.PoissonMultigrid.for_grid(m3, m3, m3, device=dev)
    t3 = time.perf_counter()
    dmg = par.distribute_multigrid(mg, mesh)
    torch.cuda.synchronize()
    eps3 = 1e-4 * float(torch.linalg.norm(b3))  # above the f32 floor at 14M rows
    mkw = dict(epsilon=eps3, max_iterations=200)
    label = f"dist_mg_solve pcg poisson_3d({m3}) f32 eps 1e-4 ||b||"
    print(f"{label}: distribute_multigrid {time.perf_counter() - t3:.2f} s, "
          f"{dmg.n_levels_dist} distributed levels of {len(mg.dims)}, m0s {dmg.m0s}")
    single = single_case(torch, lambda m: smm.cg(p3, b3, preconditioner=mg, **(
        mkw if m is None else dict(mkw, max_iterations=m))), p3, b3, groups)
    out[label] = dist_case(smm, torch, par, label, dmg, lambda m: par.dist_mg_solve(
        dmg, b3, solver="pcg", **(mkw if m is None else dict(mkw, max_iterations=m))),
        single, p3, b3, eps3, band(0.0, 1), groups)
    out[label]["same_iterations"] = out[label]["iterations"] == out[label]["single_iterations"]
    del p3, b3, mg, dmg
    torch.cuda.empty_cache()
    print(f"phase X's dist_rsell, dist_df64 and dist_multigrid solves took "
          f"{time.perf_counter() - t_start:.1f} s")
    return out, launches


def phase_x(smm, W, torch, dev, dia_solves, routed=None, nx: int = 1414, m: int = 113):
    """The distributed layer (``parallel/``) at world size 1 over NCCL, at the
    single-device phases' sizes: ``dist_solve`` on the CSR (halo mode; CG in
    f32 and f64, BiCGStab + distributed SGS(4) in f64), ``dist_dia_solve``
    (CG f32, f64), ``dist_stencil_solve`` (CG f64), ``dist_wsell_solve`` (CG
    f32 on the jittered system, K7 in the shard), then
    :func:`phase_x_modules` (``dist_routed_solve``, ``dist_cg_ir_df64``,
    ``dist_mg_solve``; ``routed`` is phase R's chain), each against the
    single-device solve of the same system; then the distributed example
    under ``torch.distributed.run`` and at ``--cpu 2``.  Returns the
    readings and the launches of K7 (the W-SELL and routed solves) and K11
    (the routed solve)."""
    import shutil
    import tempfile

    import numpy as np

    from sparse_matrix_math_tpu_torch import parallel as par
    from sparse_matrix_math_tpu_torch.ops import sell_spmv as S

    print("== phase X: the distributed layer at world size 1 over NCCL")
    store = tempfile.mkdtemp(prefix="smm_store_")
    t0 = time.perf_counter()
    mesh = par.init_distributed(f"file://{store}/store", 1, 0, device=dev)
    out = {}
    try:
        par.mesh.all_reduce(torch.zeros(1, device=dev), mesh)  # NCCL's set-up, untimed
        torch.cuda.synchronize()
        print(f"{mesh}; NCCL up in {time.perf_counter() - t0:.2f} s")
        groups = [("nccl", ("nccl", "Nccl")), ("K7 sell_kernel", ("sell_kernel",)),
                  ("K2 dia", ("dia_staged", "dia_padded")), ("K4 sweeps", ("window_kernel",)),
                  ("row sum", ("segment_reduce",))]
        p32 = smm.poisson_2d(nx, dtype=torch.float32, device=dev)
        p64 = smm.poisson_2d(nx, dtype=torch.float64, device=dev)
        b = {dt: a @ torch.ones(a.shape[0], dtype=dt, device=dev)
             for dt, a in ((torch.float32, p32), (torch.float64, p64))}
        t1 = time.perf_counter()
        d32, d64 = par.distribute_csr(p32, mesh), par.distribute_csr(p64, mesh)
        t2 = time.perf_counter()
        sgs = smm.SGSPreconditioner.from_matrix(p64, method="jacobi", sweeps=4,
                                                strict_layout="csr")
        dsgs = par.distribute_preconditioner(sgs, d64)
        t3 = time.perf_counter()
        dd = {dt: par.distribute_dia(smm.dia_from_csr(a), mesh)
              for dt, a in ((torch.float32, p32), (torch.float64, p64))}
        ds = par.distribute_stencil(smm.try_grid_stencil_from_csr(p64), mesh)
        t4 = time.perf_counter()
        require(d32.mode == d64.mode == "halo" and d64.block_rows == -(-nx * nx // 8) * 8,
                f"poisson_2d({nx}) distributes in halo mode, one block of "
                f"{d64.block_rows:,} rows")
        print(f"host builds: distribute_csr x2 {t2 - t1:.2f} s, SGS(4) + "
              f"distribute_preconditioner {t3 - t2:.2f} s, distribute_dia x2 + "
              f"distribute_stencil {t4 - t3:.2f} s")
        f32 = dict(epsilon=1e-4, max_iterations=6000)
        f64 = dict(epsilon=1e-8, max_iterations=20000)

        def cap(kw, m):
            return kw if m is None else dict(kw, max_iterations=m)

        def plain(fn, a, bb, kw, **extra):
            return lambda m: fn(a, bb, **cap(kw, m), **extra)

        def band(frac):
            """The single-device count widened by max(3, frac) on each side."""
            def interval(its):
                w = max(3, int(np.ceil(frac * its)))
                return its - w, its + w
            return interval

        # CG within 1 in f64; the f32 solves end at their floor, where the
        # products' rounding moves the exit: max(3, 10%), as f32 BiCGStab
        cg_band = {torch.float64: lambda its: (its - 1, its + 1), torch.float32: band(0.1)}

        cg = {dt: single_case(torch, plain(smm.cg, a, b[dt], kw), a, b[dt], groups)
              for dt, a, kw in ((torch.float32, p32, f32), (torch.float64, p64, f64))}
        cases = []
        for dt, kw, dcsr in ((torch.float32, f32, d32), (torch.float64, f64, d64)):
            bb = b[dt]
            name = "f32" if dt == torch.float32 else "f64"
            cases.append((f"dist_solve cg poisson_2d({nx}) {name}", dcsr,
                          plain(par.dist_solve, dcsr, bb, kw), dt, kw))
            cases.append((f"dist_dia_solve cg poisson_2d({nx}) {name}", dd[dt],
                          plain(par.dist_dia_solve, dd[dt], bb, kw), dt, kw))
        cases.append((f"dist_stencil_solve cg poisson_2d({nx}) f64", ds,
                      plain(par.dist_stencil_solve, ds, b[torch.float64], f64), torch.float64,
                      f64))
        for label, d, dist, dt, kw in cases:
            out[label] = dist_case(smm, torch, par, label, d, dist, cg[dt],
                                   p32 if dt == torch.float32 else p64, b[dt], kw["epsilon"],
                                   cg_band[dt], groups)
        # BiCGStab + SGS(4): max(3, 5%) around the single-device count.  Its
        # count moves with any change of rounding (the products' summation
        # order, b's last bit: tools/dist_probe.py), so the distributed
        # solve must repeat itself on the same b, bit for bit.
        label = f"dist_solve bicgstab+sgs(4) poisson_2d({nx}) f64"
        b64 = b[torch.float64]
        out[label] = dist_case(
            smm, torch, par, label, d64,
            plain(par.dist_solve, d64, b64, f64, solver="bicgstab", preconditioner=dsgs),
            single_case(torch, plain(smm.bicgstab, p64, b64, f64, preconditioner=sgs), p64, b64,
                        groups),
            p64, b64, 1e-8, band(0.05), groups, repeat=True)
        for name in ("f32", "f64"):
            single = f"cg poisson_2d({nx}) {name}"
            print(f"  phase B's {single}: {dia_solves[single][0]} iterations; this phase's "
                  f"single-device solve {out['dist_solve ' + single]['single_iterations']}")
        del d32, d64, dsgs, sgs, dd, ds, p32, p64, b, cg

        # W-SELL: K7 in the shard, on phase W's system and right-hand side
        t5 = time.perf_counter()
        g32 = smm.laplace_3d_jittered(m, symmetric=True, shift=0.25, dtype=torch.float32,
                                      device=dev)
        w32 = smm.auto_route_for_solve(g32)
        ab = w32 @ torch.ones(g32.shape[1], dtype=torch.float32, device=dev)
        bw = ab / torch.linalg.norm(ab)
        t6 = time.perf_counter()
        require(isinstance(w32, smm.WSellMatrix), "the single-device solve routes to W-SELL",
                quiet=True)
        dw = par.distribute_wsell(g32, mesh)
        t7 = time.perf_counter()
        print(f"laplace_3d_jittered({m}) f32: single-device route {t6 - t5:.2f} s; "
              f"distribute_wsell {t7 - t6:.2f} s: block {dw.block_rows}, window matrix "
              f"{dw.local.shape}, nway {dw.nway}, slot_ratio {dw.slot_ratio:.3f} (single "
              f"device {w32.slot_ratio:.3f})")
        xl = torch.as_tensor(np.random.default_rng(1).standard_normal(dw.block_rows),
                             device=dev).to(torch.float32)
        y = par.dist_wsell_spmv(dw, xl)
        torch.cuda.synchronize()
        require(bits_equal(torch, y, S.sell_spmv_plain(dw.local.sell, torch.cat([xl, xl, xl]))),
                "dist_wsell_spmv shard product (K7 over the [left | own | right] window) bit "
                "for bit sell_spmv_plain on the same layout")
        wkw = dict(epsilon=1e-4, max_iterations=600)
        label = f"dist_wsell_solve cg jittered({m}) f32"
        W.reset_launch_counts()
        halos = par.mesh.collectives["halo"]
        res, wall = timed_solve(torch, lambda: par.dist_wsell_solve(dw, bw, **wkw))
        k7, matvecs = W.launches["wsell_spmv"], par.mesh.collectives["halo"] - halos
        print(f"{label}: {res.status_enum().name} in {res.iterations} iterations, "
              f"{wall:.3f} s; K7 launches {k7}, products (halo exchanges) {matvecs}")
        require(k7 == matvecs > res.iterations,
                f"{label}: K7 launched once per product ({k7} launches, {matvecs} products)")
        out[label] = dist_case(smm, torch, par, label, dw,
                               plain(par.dist_wsell_solve, dw, bw, wkw),
                               single_case(torch, plain(smm.cg, g32, bw, wkw), g32, bw, groups),
                               g32, bw, 1e-4, band(0.1), groups)
        out[label]["k7_launches"] = k7
        del dw, g32, w32
        torch.cuda.empty_cache()
        more, launches = phase_x_modules(
            smm, W, torch, par, mesh, dev,
            groups + [("K11 stream_gather", ("stream_gather",))], routed, nx=nx)
        out.update(more)
        launches["wsell_spmv"] += k7
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # the example, as a user runs it: one process per card, and two CPU ranks
    example = os.path.join(_ROOT, "examples", "torch_distributed_solve.py")
    for tag, cmd in (("torchrun --nproc_per_node=1 (NCCL, the card)",
                      [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node=1", example]),
                     ("--cpu 2 (CPU run: two gloo ranks)", [sys.executable, example, "--cpu",
                                                           "2"])):
        t8 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=_ROOT)
        for line in run.stdout.splitlines():
            print(f"  torch_distributed_solve {tag}: {line}")
        want = "backend=nccl" if "nccl" in tag.lower() else "backend=gloo"
        require(run.returncode == 0 and want in run.stdout
                and "SolveResult(status=SUCCESS" in run.stdout,
                f"torch_distributed_solve {tag}: SUCCESS in {time.perf_counter() - t8:.1f} s"
                + ("" if run.returncode == 0 else f"\n{run.stderr[-3000:]}"))
    return out, launches


def main() -> int:
    if not os.path.isdir(os.path.join(_ROOT, "sparse_matrix_math_tpu_torch")):
        print("chip_smoke.py must run from a checkout holding sparse_matrix_math_tpu_torch/",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch import native
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.ops import dia_spmv as K
    from sparse_matrix_math_tpu_torch.ops import trisweep as T
    from sparse_matrix_math_tpu_torch.solvers import _loop

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")
    dev = torch.device("cuda", 0)

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    # nvcc (one process per source) and g++ side by side
    with ThreadPoolExecutor(2) as pool:
        kernels_s, native_s = (f.result() for f in [pool.submit(timed, _build.library),
                                                    pool.submit(timed, native.library)])
    built = (f"built {', '.join(p.name for p in _build.SOURCES)} with nvcc in {kernels_s:.2f} s; "
             f"{native.SOURCE.relative_to(_ROOT)} with g++ in {native_s:.2f} s")
    print(built)
    require(native.available(), "native factorization and W-SELL layout library built and loaded")

    stats = phase_a(smm, K, torch, dev)
    counts, dia_solves = phase_b(smm, K, _loop, torch, dev)
    cg_f64_its = dia_solves["cg poisson_2d(1414) f64"][0]
    pcounts = phase_p(smm, K, T, _loop, torch, dev)
    wstats, wcounts, wsys = phase_w(smm, _loop, torch, dev, cg_f64_its)
    mstats, mcounts = phase_m(smm, _loop, torch, dev, wsys)
    del wsys
    dstats, dcounts = phase_d(smm, _loop, torch, dev)
    rstats, rcounts = phase_r(smm, _loop, torch, dev, dia_solves)
    hstats = phase_h(smm, K, _loop, torch, dev)
    glaunch = phase_g(smm, K, _loop, torch, dev, dia_solves)["launches"]
    earlier = {"dia": ("phase A's K1 at the same shape, CUDA graph", stats["dia_spmv"]["ms"]),
               "ell": ("phase W's K6 at laplace_3d_jittered(113), events",
                       wstats["ell_spmv"]["ms"]),
               "wsell": ("phase W's K7 at laplace_3d_jittered(113), events",
                         wstats["wsell_spmv"]["ms"]),
               "routed": ("phase R's chain, events", rstats["chain_ms"])}
    routed = rstats.pop("routed_f32")
    ustats = phase_u(smm, K, torch, dev, earlier, routed, cg_f64_its)
    ulaunch = ustats["launches"]
    print("PHASE_U " + json.dumps({k: v for k, v in ustats.items() if k != "launches"}))
    phase_c(smm, torch, dev)
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    xstats, xlaunch = phase_x(smm, W, torch, dev, dia_solves, routed)
    del routed
    print("PHASE_X " + json.dumps(xstats))

    def entry(name, source, replaces, launches, st, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, **extra,
                "launches": launches, "max_abs_err": st["err"], "ms": st["ms"],
                "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"], "bound_by": "bytes",
                "library_ms": st["library_ms"]}

    def layout(st):
        return {k: st[k] for k in ("slots_per_nonzero", "planes_slots_per_nonzero",
                                   "planes_bound_ms", "layout_device_bytes", "layout_bytes",
                                   "layout_build_s", "same_as_built")}

    # every entry's launches also count phase U's measured runs
    # (phase_u_launches: profiling, checkpoint and resume, the examples; the
    # CLI runs in subprocesses, whose launches this process does not see)
    kernels = [
        # K2/K3: ms from a CUDA graph of 20 calls (wrapper_ms through the
        # wrapper), bound_ms k2_bytes, at poisson_2d(1414) f32; every phase-A
        # system and dtype in cases, with the kernel and tile the rule of
        # ops/dia_spmv.py staged_plan took (variant); launches are phase B's
        # and phase G's measured runs' (cg on DIA, cg_solve)
        entry("dia_staged_kernel / dia_padded_kernel (dia_spmv_padded, dia_spmv_streamed)",
              _SOURCE, f"{_PALLAS}:254", counts["dia_spmv_padded"] + glaunch["dia_spmv_padded"]
              + ulaunch["dia_spmv_padded"],
              stats["dia_spmv_padded"], phase_b_launches=counts["dia_spmv_padded"],
              phase_g_launches=glaunch["dia_spmv_padded"],
              phase_u_launches=ulaunch["dia_spmv_padded"],
              also_replaces=f"{_PALLAS}:281", wrapper_ms=stats["dia_spmv_padded"]["wrapper_ms"],
              variant=stats["dia_spmv_padded"]["variant"],
              cases=stats["dia_spmv_padded"]["cases"]),
        # K2/K3's bf16-diagonal call shape (the mixed solve's inner product):
        # ms from a CUDA graph of 20 calls beside f32 K2's (f32_ms), bound_ms
        # k2_bytes, at poisson_2d(1414); every system in cases; launches are
        # phase H's two measured mixed_cg solves
        entry("dia_staged_kernel<__nv_bfloat16, float> (dia_spmv_padded on bf16 diagonals)",
              _SOURCE, f"{_PALLAS}:254", hstats["launches"] + ulaunch["dia_spmv_padded_bf16"],
              hstats, phase_u_launches=ulaunch["dia_spmv_padded_bf16"],
              also_replaces=f"{_PALLAS}:281", entry=f"{_PALLAS}:356",
              variant=hstats["variant"],
              library_of="torch.sparse_csr_tensor(f32) @ x, the nearest call: no PyTorch "
                         "call multiplies bf16-stored values by an f32 vector",
              f32_ms=hstats["f32_ms"], wrapper_ms=hstats["wrapper_ms"],
              cases=hstats["cases"], solves=hstats["solves"]),
        # K1: ms from a CUDA graph of 20 calls (wrapper_ms through the
        # wrapper) at poisson_2d(1414) f32; launches are phase B's and phase
        # G's measured runs' (every matvec of the solver tail on DIA)
        entry("dia_kernel (dia_spmv)", _SOURCE, f"{_PALLAS}:91",
              counts["dia_spmv"] + glaunch["dia_spmv"] + ulaunch["dia_spmv"], stats["dia_spmv"],
              wrapper_ms=stats["dia_spmv"]["wrapper_ms"], phase_b_launches=counts["dia_spmv"],
              phase_g_launches=glaunch["dia_spmv"], phase_u_launches=ulaunch["dia_spmv"],
              phase_u_spmv_throughput=ustats["throughput"]["dia"]),
        # K4/K5: ms from a CUDA graph of 20 applies (wrapper_ms through the
        # wrapper), bound_ms each input read once and z written once,
        # traffic_bound_ms the variant's own traffic; variants: what the rule
        # of ops/trisweep.py window_tile took on each phase-A case
        entry("sgs_apply (smm_sgs_apply_*: window_kernel forward + backward with D; large "
              "reach: scale_kernel + sweep_kernel)", _TRI_SOURCE,
              f"{_TRI_PALLAS}:54", pcounts["sgs_apply"] + ulaunch["sgs_apply"],
              stats["sgs_apply"], phase_u_launches=ulaunch["sgs_apply"],
              entry=f"{_TRI_PALLAS}:168", wrapper_ms=stats["sgs_apply"]["wrapper_ms"],
              traffic_bound_ms=stats["sgs_apply"]["traffic_bound_ms"],
              variants=stats["sgs_apply"]["variants"]),
        entry("tri_pair_apply (smm_tri_pair_apply_*: window_kernel forward + backward; large "
              "reach: scale_kernel + sweep_kernel)", _TRI_SOURCE,
              f"{_TRI_PALLAS}:54", pcounts["tri_pair_apply"] + ulaunch["tri_pair_apply"],
              stats["tri_pair_apply"], phase_u_launches=ulaunch["tri_pair_apply"],
              entry=f"{_TRI_PALLAS}:243", wrapper_ms=stats["tri_pair_apply"]["wrapper_ms"],
              traffic_bound_ms=stats["tri_pair_apply"]["traffic_bound_ms"],
              variants=stats["tri_pair_apply"]["variants"]),
        # K6 and K7 are one kernel over the slab-sorted SELL-32 layout; bound_ms
        # counts the stored entries, layout_bytes the layout's slots (padding
        # too), planes_bound_ms the planes' ELL / W-SELL model
        entry("sell_kernel for ell_kernel (ell_spmv)", _SELL_SOURCE, f"{_PALLAS}:392",
              wcounts["ell_spmv"] + ulaunch["ell_spmv"], wstats["ell_spmv"],
              entry=f"{_PALLAS}:405", phase_u_launches=ulaunch["ell_spmv"],
              phase_u_spmv_throughput=ustats["throughput"]["ell"],
              layout=layout(wstats["ell_spmv"])),
        # K7: launches are phase W's and phase G's measured runs' (the ILU0
        # factors' strict products under GMRES), and phase X's distributed
        # W-SELL and routed solves' (every shard product)
        entry("sell_kernel for wsell_kernel k=1 (wsell_spmv)", _SELL_SOURCE,
              f"{_WSELL_PALLAS}:89",
              wcounts["wsell_spmv"] + glaunch["wsell_spmv"] + ulaunch["wsell_spmv"]
              + xlaunch["wsell_spmv"],
              wstats["wsell_spmv"], phase_w_launches=wcounts["wsell_spmv"],
              phase_g_launches=glaunch["wsell_spmv"], phase_u_launches=ulaunch["wsell_spmv"],
              phase_x_launches=xlaunch["wsell_spmv"],
              phase_u_spmv_throughput=ustats["throughput"]["wsell"],
              also_replaces=f"{_WSELL_PALLAS}:119", entry=f"{_WSELL_PALLAS}:207",
              layout=layout(wstats["wsell_spmv"]), routed_chain_launches=rcounts["wsell_spmv"],
              routed_final_pass=rstats["final_pass"]),
        # K8: the panel instantiations of the same kernel; ms, bound_ms (the
        # entries once, X and Y k times) and library_ms at k = 4 f32, every
        # case in cases; launches are phase M's (cg_multi), launches_per_solve
        # each solve's, beside the phase W rmult checks' launches (W-SELL and
        # ELL panels)
        entry("sell_kernel k=2..8 for wsell_spmm_kernel (wsell_spmm; ELL panels)", _SELL_SOURCE,
              f"{_WSELL_PALLAS}:165", mcounts["wsell_spmm"] + ulaunch["wsell_spmm"],
              wstats["wsell_spmm"], phase_u_launches=ulaunch["wsell_spmm"],
              entry=f"{_WSELL_PALLAS}:287", layout_bytes=wstats["wsell_spmm"]["layout_bytes"],
              planes_bound_ms=wstats["wsell_spmm"]["planes_bound_ms"],
              k7_columns_ms=wstats["wsell_spmm"]["k7_columns_ms"],
              cases=wstats["wsell_spmm_cases"],
              launches_per_solve={k: v.get("k8_launches", 0) for k, v in mstats.items()},
              phase_w_launches=wcounts["wsell_spmm"], ell_panel_launches=wcounts["ell_spmm"]),
        entry("dia_padded_df_kernel (dia_spmv_padded_df, dia_spmv_streamed_df)", _DF_SOURCE,
              f"{_PALLAS}:523", dcounts["dia_spmv_padded_df"] + ulaunch["dia_spmv_padded_df"],
              dstats, phase_u_launches=ulaunch["dia_spmv_padded_df"],
              also_replaces=f"{_PALLAS}:594", entry=f"{_PALLAS}:560",
              f64_csr_ms=dstats["f64_csr_ms"]),
        # ms, plain_ms and bound_ms are of the chain's largest routing pass;
        # no PyTorch call computes one pass, so library_ms is the CSR product
        # that the whole chain (every pass, then K7) computes; launches sums
        # the front-door solves that launches_per_solve lists one by one,
        # phase U's and phase X's distributed routed solve's
        entry("stream_gather_kernel (stream_gather)", _STREAM_SOURCE, f"{_RSELL_PALLAS}:32",
              rcounts["stream_gather"] + ulaunch["stream_gather"] + xlaunch["stream_gather"],
              rstats, phase_u_launches=ulaunch["stream_gather"],
              phase_x_launches=xlaunch["stream_gather"],
              phase_u_spmv_throughput=ustats["throughput"]["routed"],
              also_replaces=f"{_RSELL_PALLAS}:47",
              entry=f"{_RSELL_PALLAS}:89", library_of="the whole chain",
              passes_ms=rstats["passes_ms"], final_wsell_ms=rstats["final_ms"],
              chain_ms=rstats["chain_ms"], chain_bound_ms=rstats["chain_bound_ms"],
              csr_rmult_ms=rstats["csr_ms"], chain_wsell_launches=rcounts["wsell_spmv"],
              launches_per_solve=rstats["launches_per_solve"]),
    ]
    print(built)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
