#!/usr/bin/env python3
"""Time and probe the slab-sorted SELL-32 kernel (K6/K7, K8) on one CUDA card.

    python3 tools/sell_tune.py [m]

Writes patched copies of ``sparse_matrix_math_tpu_torch/csrc/sell_spmv.cu``
under the git-ignored ``sparse_matrix_math_tpu_torch/build/tune/`` and builds
each with nvcc, all at once, printing what ptxas reports (registers, spills):

* variants of the kernel's two constants, ``kUnroll`` (value/column pairs in
  flight per thread) and ``kMinBlocks`` (blocks per SM asked of the
  compiler; patched for float64 only, float32 keeps the shipped value);
* variants of the panel instantiations (K8, K > 1): rows per block
  (``kPanelThreads``) and blocks per SM asked of the compiler;
* a probe: the shipped constants, with each block recording its SM, its
  start and end (``clock64`` and ``%globaltimer``) and the cycle at which
  each of its warps reaches the barrier before the write-back.

Then, on the W-SELL layout (nway 4) of ``laplace_3d_jittered(m,
symmetric=True, shift=0.25)`` (m = 113 by default, the general-pattern bench
system), in float32 and float64:

* times K8 at 2, 4 and 8 columns: the shipped build, each panel variant
  (bit for bit the shipped result) and as many K7 launches on the columns;
* times the shipped build (``ops/_build.py``), each variant (held bit for bit
  to the shipped result) and ``torch.sparse_csr_tensor @ x`` (CUDA events,
  ``chip_smoke.median_ms``), and two plain streams of as many bytes as the
  product needs (``chip_smoke.sell_bytes``): a sum, which reads them, and a
  copy, which reads half and writes half; they give the rate the card
  reaches on such traffic, beside the bound's 3.35 TB/s;
* runs the probe once: resident blocks and warps per SM over each SM's span
  (achieved occupancy, of the 64 warps an SM holds), the largest number of
  blocks seen at once on an SM, the share of each SM's span with fewer than
  ``kMinBlocks`` blocks resident, the share of resident warp time spent
  waiting at the barrier for the slab's slowest chunk, the write-back's
  share, and the blocks' fill of the kernel's span on the global timer;
* asks ``torch.profiler`` for CUPTI hardware metrics of the shipped kernel,
  one metric per session (DRAM bytes and throughput, achieved occupancy,
  warp stall reasons), and prints what comes back, or that nothing did.

Prints the card's name and power limit and one JSON line.  Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import ab_build  # noqa: E402
from chip_smoke import median_ms, sell_bytes  # noqa: E402

_SRC = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "csrc", "sell_spmv.cu")
_OUT = os.path.join(_ROOT, "sparse_matrix_math_tpu_torch", "build", "tune")
VARIANTS = [(4, 2), (8, 2), (2, 1), (4, 1)]  # (kUnroll, float64 kMinBlocks)
# panel builds (K > 1): (rows per block, blocks per SM asked of the compiler)
PANEL_VARIANTS = [(128, 8), (256, 2), (256, 4), (512, 2)]
PANEL_COLUMNS = (2, 4, 8)
WARPS_PER_SM = 64  # Hopper: 2048 threads per SM
STALLS = ("long_scoreboard", "barrier", "lg_throttle", "wait", "drain", "short_scoreboard",
          "not_selected", "selected", "math_pipe_throttle", "mio_throttle", "no_instruction",
          "dispatch_stall", "imc_miss", "branch_resolving")
METRICS = ("dram__bytes_read.sum", "sm__warps_active.avg.pct_of_peak_sustained_active",
           "dram__bytes_write.sum", "dram__throughput.avg.pct_of_peak_sustained_elapsed",
           "gpu__time_duration.sum",
           *(f"smsp__average_warps_issue_stalled_{r}_per_issue_active.ratio" for r in STALLS))


def patch(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"sell_spmv.cu no longer holds exactly one {old!r}")
    return src.replace(old, new)


_BOUNDS = "__launch_bounds__(PanelShape<T, K>::threads, PanelShape<T, K>::min_blocks)"


def variant_source(src: str, unroll: int, f64_blocks: int) -> str:
    src = patch(src, "constexpr int kUnroll = 2;", f"constexpr int kUnroll = {unroll};")
    return patch(src, _BOUNDS, "__launch_bounds__(PanelShape<T, K>::threads, K == 1 && "
                 f"sizeof(T) == 8 ? {f64_blocks} : PanelShape<T, K>::min_blocks)")


def panel_source(src: str, threads: int, blocks: int) -> str:
    """The panel instantiations (K > 1) with ``threads`` rows per block and
    ``blocks`` blocks per SM asked of the compiler, float32 and float64."""
    src = patch(src, "constexpr int kPanelThreads = 256;",
                f"constexpr int kPanelThreads = {threads};")
    return patch(src, "(sizeof(T) * K > 32 ? 2 : 4)", f"({blocks})")


def probe_source(src: str) -> str:
    """The shipped kernel with per-block and per-warp records in ``g_probe``:
    block b's SM, clock64 at start and end, globaltimer at start and end at
    ``[8b, 8b + 5)``; warp w's cycles from the block's start to the barrier
    at ``8 * gridDim.x + 32b + w``."""
    src = patch(src, "namespace {\n", "namespace {\n\n__device__ long long* g_probe;\n")
    src = patch(src, "  __shared__ T ys[K == 1 ? kSlab : 1];\n",
                "  __shared__ T ys[K == 1 ? kSlab : 1];\n"
                "  const long long probe_c0 = clock64();\n"
                "  unsigned long long probe_g0;\n"
                "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(probe_g0));\n")
    src = patch(src, "    __syncthreads();\n",
                "    if (lane == 0)\n"
                "      g_probe[8LL * gridDim.x + slab * 32 + threadIdx.x / kChunk] ="
                " clock64() - probe_c0;\n"
                "    __syncthreads();\n")
    src = patch(src, "    if (row < n_rows) y[row] = ys[threadIdx.x];\n",
                "    if (row < n_rows) y[row] = ys[threadIdx.x];\n"
                "    __syncthreads();\n"
                "    if (threadIdx.x == 0) {\n"
                "      unsigned smid;\n"
                "      unsigned long long g1;\n"
                "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
                "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
                "      long long* r = g_probe + 8 * slab;\n"
                "      r[0] = smid;\n"
                "      r[1] = probe_c0;\n"
                "      r[2] = clock64();\n"
                "      r[3] = static_cast<long long>(probe_g0);\n"
                "      r[4] = static_cast<long long>(g1);\n"
                "    }\n")
    return src + ("\nextern \"C\" int smm_sell_probe_set(void* p) {\n"
                  "  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &p, sizeof(p)));\n}\n")


def build(sources: dict) -> tuple:
    """One shared library per patched source, built side by side; ptxas's
    registers and spills for each."""
    os.makedirs(_OUT, exist_ok=True)
    paths = {}
    for key, text in sources.items():
        paths[key] = os.path.join(_OUT, f"sell_{key}.cu")
        with open(paths[key], "w") as f:
            f.write(text)
    libs, ptxas = {}, {}
    P, LL = ctypes.c_void_p, ctypes.c_longlong
    for key, b in ab_build.build(paths, _OUT, "libsell").items():
        reports = list(b["ptxas"].values())
        ptxas[key] = {"registers": [r["registers"] for r in reports],
                      "spill_store_bytes": [r["spill_store_bytes"] for r in reports
                                            if r["spill_store_bytes"] is not None]}
        dll = ctypes.CDLL(b["lib"])
        for name in ("smm_sell_spmm_f32", "smm_sell_spmm_f64"):
            fn = getattr(dll, name)
            fn.argtypes = [P, P, P, P, P, P, ctypes.c_int, LL, ctypes.c_int, P]
            fn.restype = ctypes.c_int
        libs[key] = dll
    return libs, ptxas


def panel_times(torch, W, libs, ws, dt, stream) -> dict:
    """K8 at k = 2, 4, 8 columns: the shipped build (``wsell_spmm``), each
    panel variant (held bit for bit to it) and k K7 launches on the columns."""
    s = ws.sell
    word = torch.int32 if dt == torch.float32 else torch.int64
    gen = torch.Generator(device=s.device).manual_seed(1)
    out = {}
    for k in PANEL_COLUMNS:
        xs = (torch.rand(ws.shape[1], k, dtype=dt, device=s.device, generator=gen) - 0.5)
        cols = [xs[:, j].contiguous() for j in range(k)]
        ref = W.wsell_spmm(ws, xs)
        row = {"need_bytes": sell_bytes(s, xs.element_size(), k=k),
               "shipped_ms": median_ms(lambda: W.wsell_spmm(ws, xs), calls=10),
               "k7_columns_ms": median_ms(lambda: [W.wsell_spmv(ws, c) for c in cols], calls=10)}
        for key, dll in libs.items():
            if not key.startswith("panel_"):
                continue
            fn = dll.smm_sell_spmm_f32 if dt == torch.float32 else dll.smm_sell_spmm_f64
            ys = torch.empty_like(ref)

            def launch(fn=fn, ys=ys):
                code = fn(s.vals.data_ptr(), s.cols.data_ptr(), s.chunk_ptr.data_ptr(),
                          s.row_of.data_ptr(), xs.data_ptr(), ys.data_ptr(), s.n_slabs,
                          s.shape[0], k, stream)
                if code != 0:
                    raise RuntimeError(f"CUDA error {code}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(ys.view(word), ref.view(word)):
                raise RuntimeError(f"{key} k={k}: not bit for bit the shipped result")
            row[f"{key}_ms"] = median_ms(launch, calls=10)
        out[f"k{k}"] = row
    return out


def occupancy(rec, warp_done) -> dict:
    """What the probe's records say: ``rec`` (blocks, 8) int64, ``warp_done``
    (blocks, 32) cycles from each block's start to each warp's barrier."""
    import numpy as np

    sm, c0, c1, g0, g1 = (rec[:, i] for i in range(5))
    dur = (c1 - c0).astype(np.float64)
    span_sum, below, most = 0.0, 0.0, 0
    for s in np.unique(sm):
        on = sm == s
        times = np.concatenate([c0[on], c1[on]])
        steps = np.concatenate([np.ones(on.sum(), np.int64), -np.ones(on.sum(), np.int64)])
        order = np.lexsort((steps, times))  # an end before a start at the same cycle
        resident = np.cumsum(steps[order])[:-1]
        gaps = np.diff(times[order]).astype(np.float64)
        span_sum += gaps.sum()
        below += gaps[resident < 2].sum()
        most = max(most, int(resident.max()))
    last = warp_done.max(axis=1).astype(np.float64)
    blocks_per_sm = dur.sum() / span_sum
    n_sm = len(np.unique(sm))
    g_span = float(g1.max() - g0.min())
    return {"sms": n_sm, "blocks": int(rec.shape[0]),
            "resident_blocks_per_sm": blocks_per_sm,
            "achieved_occupancy": blocks_per_sm * 32 / WARPS_PER_SM,
            "most_blocks_at_once": most,
            "share_below_2_blocks": below / span_sum,
            "barrier_wait_share": float((last[:, None] - warp_done).sum() / (32 * dur.sum())),
            "write_back_share": float((dur - last).sum() / dur.sum()),
            "global_span_us": g_span / 1e3,
            "global_fill_of_2_blocks_per_sm": float((g1 - g0).sum()) / (2 * n_sm * g_span),
            "block_us_median": float(np.median(g1 - g0)) / 1e3,
            "sm_clock_ghz": dur.sum() / float((g1 - g0).sum())}


def cupti_metrics(torch, fn) -> dict:
    """One CUPTI metric per ``torch.profiler`` session over ``fn`` (one
    kernel); the values found in the exported trace, and what failed."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    found, failed = {}, {}
    for i, metric in enumerate(METRICS):
        path = os.path.join(_OUT, f"cupti_{i}.json")
        try:
            cfg = _ExperimentalConfig(profiler_metrics=[metric], profiler_measure_per_kernel=True)
            with profile(activities=[ProfilerActivity.CUDA], experimental_config=cfg) as prof:
                fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        except Exception as exc:  # noqa: BLE001 - report any refusal and go on
            failed[metric] = repr(exc)[:200]
            events = []
        values = [ev["args"][metric] for ev in events if metric in ev.get("args", {})]
        if values:
            found[metric] = values
        elif metric not in failed:
            cats = sorted({str(ev.get("cat")) for ev in events})
            failed[metric] = f"no value in the trace (event categories {cats})"
        if i == 1 and not found:
            failed["rest"] = "not tried: the first two metrics returned nothing"
            break
    return {"values": found, "failed": failed}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no CUDA card", file=sys.stderr)
        return 2
    import sparse_matrix_math_tpu_torch as smm
    from sparse_matrix_math_tpu_torch.ops import _build
    from sparse_matrix_math_tpu_torch.ops import wsell_spmv as W

    m = int(sys.argv[1]) if len(sys.argv) > 1 else 113
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    _build.library()
    with open(_SRC) as f:
        shipped = f.read()
    sources = {f"u{u}_b{b}": variant_source(shipped, u, b) for u, b in VARIANTS}
    sources["probe"] = probe_source(shipped)
    sources.update({f"panel_t{t}_b{b}": panel_source(shipped, t, b) for t, b in PANEL_VARIANTS})
    libs, ptxas = build(sources)
    probe_lib = libs["probe"]
    probe_lib.smm_sell_probe_set.argtypes = [ctypes.c_void_p]
    probe_lib.smm_sell_probe_set.restype = ctypes.c_int
    for key, info in ptxas.items():
        print(f"{key}: ptxas {info}", flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi, "m": m, "ptxas": ptxas}
    for dt in (torch.float32, torch.float64):
        csr = smm.laplace_3d_jittered(m, symmetric=True, shift=0.25, dtype=dt, device=dev)
        ws = smm.try_wsell_from_csr(csr)
        s = ws.sell
        x = torch.rand(csr.shape[1], dtype=dt, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0)) - 0.5
        lib = torch.sparse_csr_tensor(csr.indptr.to(torch.int32), csr.indices.to(torch.int32),
                                      csr.data, size=csr.shape)
        ref = W.wsell_spmv(ws, x)
        word = torch.int32 if dt == torch.float32 else torch.int64
        need = sell_bytes(s, x.element_size())
        name = str(dt)[6:]
        row = {"needed_bytes": need, "layout_bytes": sell_bytes(s, x.element_size(), padded=True),
               "slots_per_nonzero": s.slots_per_nonzero,
               "shipped_ms": median_ms(lambda: W.wsell_spmv(ws, x)),
               "library_ms": median_ms(lambda: lib @ x)}
        stream_in = torch.rand(need // 4, device=dev)
        row["read_stream_ms"] = median_ms(lambda: stream_in.sum())
        half = stream_in[:need // 8]
        copy_out = torch.empty_like(half)
        row["copy_stream_ms"] = median_ms(lambda: copy_out.copy_(half))
        del stream_in, half, copy_out

        def runner(dll, y):
            fn = dll.smm_sell_spmm_f32 if dt == torch.float32 else dll.smm_sell_spmm_f64

            def launch():
                code = fn(s.vals.data_ptr(), s.cols.data_ptr(), s.chunk_ptr.data_ptr(),
                          s.row_of.data_ptr(), x.data_ptr(), y.data_ptr(), s.n_slabs,
                          s.shape[0], 1, stream)
                if code != 0:
                    raise RuntimeError(f"CUDA error {code}")
            return launch

        probe = torch.zeros(40 * s.n_slabs, dtype=torch.int64, device=dev)
        if probe_lib.smm_sell_probe_set(probe.data_ptr()) != 0:
            raise RuntimeError("probe: cudaMemcpyToSymbol failed")
        row["panel"] = panel_times(torch, W, libs, ws, dt, stream)
        for key, dll in libs.items():
            if key.startswith("panel_"):
                continue
            y = torch.empty_like(ref)
            launch = runner(dll, y)
            launch()
            torch.cuda.synchronize()
            if not torch.equal(y.view(word), ref.view(word)):
                raise RuntimeError(f"{key} {name}: not bit for bit the shipped result")
            if key == "probe":
                rec = probe[:8 * s.n_slabs].view(s.n_slabs, 8).cpu().numpy()
                done = probe[8 * s.n_slabs:].view(s.n_slabs, 32).cpu().numpy()
                row["probe"] = occupancy(rec, done)
            row[f"{key}_ms"] = median_ms(launch)
        row["bandwidth"] = {k: need / row[f"{k}_ms"] / 1e9 for k in
                            ("shipped", "read_stream", "copy_stream")}
        print(f"{name}: " + json.dumps(row), flush=True)
        row["cupti"] = cupti_metrics(torch, runner(_build.library(), torch.empty_like(ref)))
        print(f"{name} CUPTI metrics: " + json.dumps(row["cupti"]), flush=True)
        result[name] = row
        del csr, ws, s, lib, x, ref
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
