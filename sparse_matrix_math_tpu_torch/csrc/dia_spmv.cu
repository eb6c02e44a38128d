// DIA sparse matrix-vector product y = A x for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sparse_matrix_math_tpu/ops/pallas_spmv.py:
//   _dia_kernel          (:91)  -> dia_kernel         one-shot, unpadded x
//   _dia_padded_kernel   (:254) -> dia_staged_kernel  padded layout (and
//                                  dia_padded_kernel where the rule keeps it)
//   _dia_streamed_kernel (:281) -> the same two kernels
//
// The TPU split x between a VMEM-resident kernel and one that streamed x
// windows from HBM by DMA, because VMEM holds ~40 MB.  The H100 has no such
// split: the padded kernels serve every size and dia_spmv_streamed launches
// them.
//
// What bounds it: device-memory bytes.  A product must read each active
// row's ndiags diagonal values and x once and write y over the layout:
// ndiags * n_rows * sizeof(TD) + n_rows * sizeof(T) + n_total * sizeof(T).
// The first design, dia_padded_kernel (one thread per row), reads x
// ndiags times per row through L1/L2 with scalar loads and each diagonal
// value with one 2- to 8-byte load per thread: on an H100 it reached 39%
// of that bound at 27 bf16 diagonals and 66% at 27 f32 ones, the two
// taking about the same time although bf16 moves half the bytes.
//
// dia_staged_kernel, the padded kernel the rule of ops/dia_spmv.py picks
// at the solvers' shapes: persistent CTAs of 256 threads walk tiles of
// kTile = 256 * J consecutive rows (tile blockIdx.x, + gridDim.x, ...;
// J = 2 or 4).  The sorted offsets are grouped into clusters
// (ops/dia_spmv.py x_clusters: a new cluster where the gap to the previous
// offset reaches the tile); each tile's diagonals (kTile values each) and,
// for each cluster c, its x segment [tile + lo_c, tile + lo_c + len_c),
// rounded out to 16 bytes, are copied into shared memory by TMA bulk
// copies (cp.async.bulk, completion on an mbarrier) into a ring of two
// stages, so that the next tile's copies are in flight while a tile
// computes: the JAX kernel's double-buffered x window
// (pallas_spmv.py:281-316), one segment per cluster instead of one span
// (at 27 points the span is 33,026 rows).  Every device-memory read is a
// bulk copy of at least 1 KB; x is read from L2 about
// clusters * (1 + span / kTile) times instead of ndiags times through L1;
// the diagonals, read once, are copied with an L2 evict-first policy so x
// stays in L2.  The lanes of warp 0 issue a tile's copies in parallel, one
// each: from one thread, ~60 ns per copy held up the whole CTA.  Thread t
// computes rows t + 256 j of the tile, so a warp's reads of a diagonal and
// of x from shared memory are consecutive words: no bank conflict.  A
// tile's copies are clamped inside [0, n_total); the rows that would read
// outside a clamped segment are guard rows.  On an H100 it reads 65-84% of
// the bound with the L2 flushed first (81-95% warm) at 5, 7 and 27
// diagonals in f32 and bf16, 1.2-2.1x the row kernel; two stages and two
// or three CTAs per SM beat deeper rings with one CTA.  The row kernel
// stays for float64 x (81-90% of its bound; the staged kernel won 7-20% at
// 1-2M rows but lost 2-8% from 4M), for layouts of fewer than 7 tiles per
// SM, and where two stages do not fit the 227 KB a block may use.
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in ascending-offset order, the order of the JAX kernel, in
// both kernels.  The plain PyTorch versions in ops/dia_spmv.py follow the
// same order, so kernel and plain version agree bit for bit.
//
// Narrow diagonals (the mixed-precision solve, solvers/mixed.py): the padded
// kernels also take bfloat16 (or float16) diagonals with float32 x and y,
// as the JAX kernels are traced for a bf16 diags3 and an f32 xp
// (pallas_spmv.py:369-375).  Each stored value is widened exactly to float
// (__bfloat162float, __half2float) and then multiplied and summed as in the
// float32 kernel, the order of the JAX kernel, where bf16 * f32 promotes to
// f32.
//
// Which kernel runs is the caller's explicit rule (ops/dia_spmv.py
// staged_plan), passed as the tile, the clusters' segments, the bytes of a
// stage and the grid, all worked out once per layout by ops/dia_spmv.py
// (the grid from smm_dia_staged_blocks_per_sm); tile 0 asks for
// dia_padded_kernel.  The entry checks the plan against the kernel and
// launches.  A refused launch (a malformed segment, a stage too small,
// shared memory over the block's limit) returns its error: nothing falls
// back.
//
// Index math is 64-bit: d * n_total + e reaches 2^31 at 27 diagonals and
// 80M rows.  Offsets arrive as a host array and travel as a kernel
// parameter (at most kMaxDiags of them, the DIA format's max_diags).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;
constexpr int kStagedThreads = 256;
constexpr int kStages = 2;  // the ring's depth
// ahead of the stages: the stages' mbarriers, then the clusters' lo, len
// and base (the copies index them by lane, which kernel parameters do not
// allow without a local copy); ops/dia_spmv.py's _HEADER_BYTES
constexpr int kHeaderBytes = 1024;
static_assert(kStages * 8 + 3 * kMaxDiags * 4 <= kHeaderBytes, "header");

struct Offsets {
  int v[kMaxDiags];
};

// The staged kernel's view of the clusters, built by the C entry from the
// segments ops/dia_spmv.py passes.
struct StagedPlan {
  int xoff[kMaxDiags];  // per diagonal: x-region index of row 0's term
  int lo[kMaxDiags];    // per cluster: first element of its segment, tile-relative
  int len[kMaxDiags];   // per cluster: elements of its segment
  int base[kMaxDiags];  // per cluster: the segment's first element in the x region
  int nclusters;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// A stored diagonal value in the accumulation type: exact for every pair
// instantiated below (float from bf16 or f16 drops no bit).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that outlasts ~2^35 cycles (tens of seconds) traps, so a fault in
// the copies' accounting ends the launch with an error instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 35)) __trap();
  }
}

// TMA bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The same copy with an L2 eviction policy (`policy`, from createpolicy):
// the diagonals are read once, so they go first and x stays in L2.
__device__ __forceinline__ void bulk_copy_hint(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Padded layout: diags (ndiags, n_total), xp and y (n_total,).  Rows
// outside [lead, lead + n_rows) are guard rows: they write an exact 0 and
// read nothing.  The layout's guards (at least -min(offsets) before lead,
// at least max(offsets) after the data) keep every read of an active row
// in bounds, so no clamp is needed.  TD is the diagonals' type, T that of
// x, y and the sum.  One thread per row.
template <typename TD, typename T>
__global__ void __launch_bounds__(kThreads)
dia_padded_kernel(const TD* __restrict__ diags, const T* __restrict__ xp,
                  T* __restrict__ y, const Offsets offs, int ndiags,
                  long long n_total, long long lead, long long n_rows) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_total) return;
  T acc = T(0);
  if (e >= lead && e < lead + n_rows) {
    acc = mul_rn(widen(diags[e]), __ldg(xp + e + offs.v[0]));
#pragma unroll
    for (int d = 1; d < kMaxDiags; ++d) {
      if (d >= ndiags) break;
      const T a = widen(diags[static_cast<long long>(d) * n_total + e]);
      acc = add_rn(acc, mul_rn(a, __ldg(xp + e + offs.v[d])));
    }
  }
  y[e] = acc;
}

// The staged padded kernel (header).  Shared memory: kHeaderBytes of
// mbarriers and the clusters' table, then kStages stages of stage_bytes,
// each the tile's diagonals (ndiags * kTile values) then its x region (the
// clusters' segments, back to back).
template <typename TD, typename T, int J>
__global__ void __launch_bounds__(kStagedThreads)
dia_staged_kernel(const TD* __restrict__ diags, const T* __restrict__ xp, T* __restrict__ y,
                  const StagedPlan plan, int ndiags, long long n_total, long long lead,
                  long long n_rows, int stage_bytes) {
  constexpr int kTile = kStagedThreads * J;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  const long long ntiles = (n_total + kTile - 1) / kTile;
  const long long first = blockIdx.x, stride = gridDim.x;
  const int mine =
      first < ntiles ? static_cast<int>((ntiles - first + stride - 1) / stride) : 0;
  const size_t diag_bytes = static_cast<size_t>(ndiags) * kTile * sizeof(TD);

  int* seg_lo = reinterpret_cast<int*>(smem + kStages * sizeof(uint64_t));
  int* seg_len = seg_lo + kMaxDiags;
  int* seg_base = seg_len + kMaxDiags;
  const int nclusters = plan.nclusters;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < kMaxDiags; ++c) {  // unrolled: constant parameter offsets
      if (c >= nclusters) break;
      seg_lo[c] = plan.lo[c];
      seg_len[c] = plan.len[c];
      seg_base[c] = plan.base[c];
    }
  }
  __syncthreads();

  // The lanes of warp 0 ask for tile k's copies into stage k % kStages, one
  // copy per lane (a copy takes its issuing thread ~100 cycles).  A
  // cluster's segment is clamped to [0, n_total).
  auto clamp = [&](long long t0, int c, long long* g0, long long* g1) {
    const long long s0 = t0 + seg_lo[c];
    *g0 = s0 > 0 ? s0 : 0;
    *g1 = s0 + seg_len[c] < n_total ? s0 + seg_len[c] : n_total;
  };
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));
  auto issue = [&](int k) {
    const int lane = threadIdx.x;
    const long long t0 = (first + static_cast<long long>(k) * stride) * kTile;
    unsigned char* st = smem + kHeaderBytes + static_cast<size_t>(k % kStages) * stage_bytes;
    T* xs = reinterpret_cast<T*>(st + diag_bytes);
    uint64_t* bar = &full[k % kStages];
    const long long rows = n_total - t0 < kTile ? n_total - t0 : kTile;
    if (lane == 0) {
      uint32_t bytes = static_cast<uint32_t>(ndiags * rows * sizeof(TD));
      for (int c = 0; c < nclusters; ++c) {
        long long g0, g1;
        clamp(t0, c, &g0, &g1);
        if (g1 > g0) bytes += static_cast<uint32_t>((g1 - g0) * sizeof(T));
      }
      mbar_expect_tx(bar, bytes);
    }
    __syncwarp();
    for (int i = lane; i < ndiags + nclusters; i += 32) {
      if (i < ndiags) {
        bulk_copy_hint(st + static_cast<size_t>(i) * kTile * sizeof(TD),
                       diags + static_cast<long long>(i) * n_total + t0,
                       static_cast<uint32_t>(rows * sizeof(TD)), bar, evict_first);
      } else {
        const int c = i - ndiags;
        long long g0, g1;
        clamp(t0, c, &g0, &g1);
        if (g1 > g0)
          bulk_copy(xs + seg_base[c] + (g0 - (t0 + seg_lo[c])), xp + g0,
                    static_cast<uint32_t>((g1 - g0) * sizeof(T)), bar);
      }
    }
  };

  if (threadIdx.x < 32)
    for (int k = 0; k < mine && k < kStages; ++k) issue(k);

  for (int k = 0; k < mine; ++k) {
    const int s = k % kStages;
    mbar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
    const long long t0 = (first + static_cast<long long>(k) * stride) * kTile;
    const unsigned char* st = smem + kHeaderBytes + static_cast<size_t>(s) * stage_bytes;
    const TD* ds = reinterpret_cast<const TD*>(st);
    const T* xs = reinterpret_cast<const T*>(st + diag_bytes);

    // row r = threadIdx.x + 256 j of the tile (a row past the layout's end
    // reads what the stage holds and is never stored)
    auto diag = [&](int d, int r) -> T { return widen(ds[d * kTile + r]); };
    T acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int r = threadIdx.x + j * kStagedThreads;
      acc[j] = mul_rn(diag(0, r), xs[plan.xoff[0] + r]);
    }
#pragma unroll
    for (int d = 1; d < kMaxDiags; ++d) {
      if (d >= ndiags) break;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int r = threadIdx.x + j * kStagedThreads;
        acc[j] = add_rn(acc[j], mul_rn(diag(d, r), xs[plan.xoff[d] + r]));
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const long long e = t0 + threadIdx.x + j * kStagedThreads;
      if (e < n_total) y[e] = (e >= lead && e < lead + n_rows) ? acc[j] : T(0);
    }
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x < 32 && k + kStages < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(k + kStages);
    }
  }
}

// One-shot: diags (ndiags, n_rows), x (n_cols,), y (n_rows,).  Terms whose
// column i + off falls outside [0, n_cols) are skipped instead of padding x
// on every call (the TPU kernel padded x, pallas_spmv.py:121-129).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_kernel(const T* __restrict__ diags, const T* __restrict__ x,
           T* __restrict__ y, const Offsets offs, int ndiags,
           long long n_rows, long long n_cols) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  T acc = T(0);
#pragma unroll
  for (int d = 0; d < kMaxDiags; ++d) {
    if (d >= ndiags) break;
    const long long j = i + offs.v[d];
    if (j >= 0 && j < n_cols) {
      const T a = diags[static_cast<long long>(d) * n_rows + i];
      acc = add_rn(acc, mul_rn(a, __ldg(x + j)));
    }
  }
  y[i] = acc;
}

Offsets load_offsets(const void* offsets, int ndiags) {
  Offsets o{};
  const int* src = static_cast<const int*>(offsets);
  for (int d = 0; d < ndiags && d < kMaxDiags; ++d) o.v[d] = src[d];
  return o;
}

unsigned int blocks_for(long long n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// The clusters' segments, as ops/dia_spmv.py passes them: segs[0] is the
// number of clusters, then (lo, len, first diagonal) for each.  Checks
// that every segment is 16-byte aligned, holds every read of its
// diagonals' terms on a tile of kTile rows, and that the segments together
// take at most max_x elements.  Returns false on a malformed plan.
bool make_plan(const int* offs, int ndiags, const int* segs, int tile, int align,
               long long max_x, StagedPlan* plan) {
  if (segs == nullptr) return false;
  const int nc = segs[0];
  if (nc < 1 || nc > ndiags) return false;
  plan->nclusters = nc;
  long long base = 0;
  for (int c = 0; c < nc; ++c) {
    const int lo = segs[1 + 3 * c], len = segs[2 + 3 * c], d0 = segs[3 + 3 * c];
    const int d1 = c + 1 < nc ? segs[3 + 3 * (c + 1)] : ndiags;
    if (lo % align != 0 || len % align != 0 || len <= 0 || d0 < 0 || d1 <= d0 ||
        (c == 0 && d0 != 0) || d1 > ndiags || base + len > max_x)
      return false;
    plan->lo[c] = lo;
    plan->len[c] = len;
    plan->base[c] = static_cast<int>(base);
    for (int d = d0; d < d1; ++d) {
      const long long rel = static_cast<long long>(offs[d]) - lo;
      if (rel < 0 || rel + tile > len) return false;
      plan->xoff[d] = static_cast<int>(base + rel);
    }
    base += len;
  }
  return true;
}

// The staged kernel on `grid` CTAs, each with kHeaderBytes + kStages *
// stage_bytes of dynamic shared memory (both from ops/dia_spmv.py); the
// plan is checked against the kernel first.
template <typename TD, typename T, int J>
int launch_staged(const TD* diags, const T* xp, T* y, const int* offs, int ndiags,
                  long long n_total, long long lead, long long n_rows, const int* segs,
                  long long stage_bytes, long long grid, cudaStream_t stream) {
  constexpr int kTile = kStagedThreads * J;
  if (reinterpret_cast<uintptr_t>(diags) % 16 != 0 || reinterpret_cast<uintptr_t>(xp) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long diag_bytes = static_cast<long long>(ndiags) * kTile * sizeof(TD);
  StagedPlan plan{};
  if (n_total % 128 != 0 || grid < 1 || grid > INT32_MAX || stage_bytes % 16 != 0 ||
      stage_bytes <= diag_bytes || stage_bytes > INT32_MAX ||
      !make_plan(offs, ndiags, segs, kTile, 16 / static_cast<int>(sizeof(T)),
                 (stage_bytes - diag_bytes) / static_cast<long long>(sizeof(T)), &plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = kHeaderBytes + kStages * static_cast<size_t>(stage_bytes);
  dia_staged_kernel<TD, T, J><<<static_cast<unsigned int>(grid), kStagedThreads, smem, stream>>>(
      diags, xp, y, plan, ndiags, n_total, lead, n_rows, static_cast<int>(stage_bytes));
  return static_cast<int>(cudaGetLastError());
}

// tile 0: dia_padded_kernel; else the staged kernel at that tile (512 or
// 1024 rows).
template <typename TD, typename T>
int launch_padded(const void* diags, const void* xp, void* y, const void* offsets,
                  int ndiags, long long n_total, long long lead, long long n_rows, int tile,
                  const void* segs, long long stage_bytes, long long grid, void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TD* d = static_cast<const TD*>(diags);
  const T* x = static_cast<const T*>(xp);
  T* out = static_cast<T*>(y);
  const int* offs = static_cast<const int*>(offsets);
  const int* sg = static_cast<const int*>(segs);
  if (tile == 0) {
    dia_padded_kernel<TD, T><<<blocks_for(n_total), kThreads, 0, s>>>(
        d, x, out, load_offsets(offsets, ndiags), ndiags, n_total, lead, n_rows);
    return static_cast<int>(cudaGetLastError());
  }
  switch (tile) {
    case 2 * kStagedThreads:
      return launch_staged<TD, T, 2>(d, x, out, offs, ndiags, n_total, lead, n_rows, sg,
                                     stage_bytes, grid, s);
    case 4 * kStagedThreads:
      return launch_staged<TD, T, 4>(d, x, out, offs, ndiags, n_total, lead, n_rows, sg,
                                     stage_bytes, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks of the staged kernel at `tile` that one SM holds with `smem` bytes
// of dynamic shared memory each, after opting the kernel in to the
// device's per-block maximum; an error where none fits.
template <typename TD, typename T, int J>
int staged_blocks(long long smem, int* blocks) {
  const void* kernel = reinterpret_cast<const void*>(dia_staged_kernel<TD, T, J>);
  int dev = 0, optin = 0;
  int code = static_cast<int>(cudaGetDevice(&dev));
  if (code == 0)
    code = static_cast<int>(
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (code == 0)
    code = static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
  if (code != 0) return code;
  if (smem < 0 || smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  code = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kStagedThreads, static_cast<size_t>(smem)));
  if (code != 0) return code;
  return *blocks < 1 ? static_cast<int>(cudaErrorInvalidConfiguration) : 0;
}

template <typename TD, typename T>
int staged_blocks_at(int tile, long long smem, int* blocks) {
  switch (tile) {
    case 2 * kStagedThreads:
      return staged_blocks<TD, T, 2>(smem, blocks);
    case 4 * kStagedThreads:
      return staged_blocks<TD, T, 4>(smem, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_oneshot(const void* diags, const void* x, void* y, const void* offsets,
                   int ndiags, long long n_rows, long long n_cols, void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  dia_kernel<T><<<blocks_for(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diags), static_cast<const T*>(x), static_cast<T*>(y),
      load_offsets(offsets, ndiags), ndiags, n_rows, n_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Every function
// returns cudaGetLastError() after its launch (or the error that refused
// it): 0 means the launch was taken.  The padded entries take the rule's
// choice: tile (0 for one thread per row), the clusters' segments, the
// bytes of a stage and the grid (ops/dia_spmv.py staged_plan).
extern "C" {

int smm_dia_spmv_padded_f32(const void* diags, const void* xp, void* y, const void* offsets,
                            int ndiags, long long n_total, long long lead, long long n_rows,
                            int tile, const void* segs, long long stage_bytes, long long grid,
                            void* stream) {
  return launch_padded<float, float>(diags, xp, y, offsets, ndiags, n_total, lead, n_rows,
                                     tile, segs, stage_bytes, grid, stream);
}

int smm_dia_spmv_padded_f64(const void* diags, const void* xp, void* y, const void* offsets,
                            int ndiags, long long n_total, long long lead, long long n_rows,
                            int tile, const void* segs, long long stage_bytes, long long grid,
                            void* stream) {
  return launch_padded<double, double>(diags, xp, y, offsets, ndiags, n_total, lead, n_rows,
                                       tile, segs, stage_bytes, grid, stream);
}

// bfloat16 (or float16) diagonals, float32 xp and y: the mixed solve's
// inner product
int smm_dia_spmv_padded_bf16_f32(const void* diags, const void* xp, void* y,
                                 const void* offsets, int ndiags, long long n_total,
                                 long long lead, long long n_rows, int tile, const void* segs,
                                 long long stage_bytes, long long grid, void* stream) {
  return launch_padded<__nv_bfloat16, float>(diags, xp, y, offsets, ndiags, n_total, lead,
                                             n_rows, tile, segs, stage_bytes, grid, stream);
}

int smm_dia_spmv_padded_f16_f32(const void* diags, const void* xp, void* y,
                                const void* offsets, int ndiags, long long n_total,
                                long long lead, long long n_rows, int tile, const void* segs,
                                long long stage_bytes, long long grid, void* stream) {
  return launch_padded<__half, float>(diags, xp, y, offsets, ndiags, n_total, lead, n_rows,
                                      tile, segs, stage_bytes, grid, stream);
}

// Blocks per SM of the staged kernel for the diagonals' type (kind 0
// float32, 1 float64, 2 bfloat16, 3 float16, as the entries above) at
// `tile` and `smem` bytes of dynamic shared memory.
int smm_dia_staged_blocks_per_sm(int kind, int tile, long long smem, int* blocks) {
  switch (kind) {
    case 0:
      return staged_blocks_at<float, float>(tile, smem, blocks);
    case 1:
      return staged_blocks_at<double, double>(tile, smem, blocks);
    case 2:
      return staged_blocks_at<__nv_bfloat16, float>(tile, smem, blocks);
    case 3:
      return staged_blocks_at<__half, float>(tile, smem, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int smm_dia_spmv_f32(const void* diags, const void* x, void* y, const void* offsets,
                     int ndiags, long long n_rows, long long n_cols, void* stream) {
  return launch_oneshot<float>(diags, x, y, offsets, ndiags, n_rows, n_cols, stream);
}

int smm_dia_spmv_f64(const void* diags, const void* x, void* y, const void* offsets,
                     int ndiags, long long n_rows, long long n_cols, void* stream) {
  return launch_oneshot<double>(diags, x, y, offsets, ndiags, n_rows, n_cols, stream);
}

const char* smm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
