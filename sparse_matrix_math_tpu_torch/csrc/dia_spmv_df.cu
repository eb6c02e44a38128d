// Double-word DIA sparse matrix-vector product (yh, yl) = A (xh, xl) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sparse_matrix_math_tpu/ops/pallas_spmv.py:
//   _dia_padded_df_kernel   (:523) -> dia_padded_df_kernel
//   _dia_streamed_df_kernel (:594) -> dia_padded_df_kernel  the same kernel
//
// Every value is a pair of float32 words, hi + lo, carrying a 48-bit
// significand (ops/df32.py).  For each active row e, from acc = (0, 0) and
// in ascending-offset order:
//   (p, err) = two_prod(a_hi[d, e], x_hi[e + off_d])
//   err     += a_hi * x_lo + a_lo * x_hi
//   acc      = df_add(acc, fast_two_sum(p, err))
// Guard rows (outside [lead, lead + n_rows)) write an exact (0, 0).  The TPU
// split x between a VMEM-resident kernel and one that streamed x windows by
// DMA; here every read of x goes through the 50 MB L2, so one kernel serves
// every size, as dia_spmv.cu does for the float kernels.
//
// The error-free transforms are exact only if every operation is rounded on
// its own.  nvcc contracts a * b + c into an FMA by default (--fmad=true),
// which would change two_sum, fast_two_sum and the cross terms silently, so
// every add, subtract and multiply is written as __fadd_rn / __fsub_rn /
// __fmul_rn, which are never contracted.  two_prod's error is the one FMA:
// __fmaf_rn(a, b, -p) is exactly a * b - p, the value Dekker's split gives
// (the plain version in ops/df32.py splits; both are exact short of
// overflow and underflow).  Build without --use_fast_math and without
// -ftz=true: the lo words sit ~2^-24 below the hi words, and flushing
// subnormals would change them.  The plain PyTorch version follows the same
// operations in the same order, so kernel and plain version agree bit for
// bit in both words.
//
// What bounds it: device-memory bytes.  Each row reads 2 * ndiags plane
// values and two x words and writes two y words: (2 * ndiags + 4) * 4 B per
// row (x's shifted re-reads hit in L2).  Each term costs ~30 float32
// operations, far below the card's rate for that traffic.  The design is the
// simplest one that streams at that bound: one thread per row, so the
// warp's reads of the four planes and of x are coalesced.  Staging x in
// shared memory with TMA is left for later work.
//
// Index math is 64-bit: d * n_total + e passes 2^31 at 7 planes of the
// 14.3M-row poisson_3d(243) system.  Offsets arrive as a host array and
// travel as a kernel parameter (at most kMaxDiags of them).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;

struct Offsets {
  int v[kMaxDiags];
};

struct Df {
  float hi, lo;
};

// Knuth's two_sum: a + b = s + e exactly.
__device__ __forceinline__ Df two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

// a + b = s + e exactly when |a| >= |b| or a == 0.
__device__ __forceinline__ Df fast_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// Accurate double-word + double-word (AccurateDWPlusDW).
__device__ __forceinline__ Df df_add(Df a, Df b) {
  const Df s = two_sum(a.hi, b.hi);
  const Df t = two_sum(a.lo, b.lo);
  const Df v = fast_two_sum(s.hi, __fadd_rn(s.lo, t.hi));
  return fast_two_sum(v.hi, __fadd_rn(t.lo, v.lo));
}

// Padded layout: planes (ndiags, n_total), x and y words (n_total,).  The
// layout's guards (at least -min(offsets) before lead, at least
// max(offsets) after the data) keep every read of an active row in bounds.
__global__ void __launch_bounds__(kThreads)
dia_padded_df_kernel(const float* __restrict__ dhi, const float* __restrict__ dlo,
                     const float* __restrict__ xh, const float* __restrict__ xl,
                     float* __restrict__ yh, float* __restrict__ yl, const Offsets offs,
                     int ndiags, long long n_total, long long lead, long long n_rows) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_total) return;
  Df acc{0.0f, 0.0f};
  if (e >= lead && e < lead + n_rows) {
#pragma unroll
    for (int d = 0; d < kMaxDiags; ++d) {
      if (d >= ndiags) break;
      const long long i = static_cast<long long>(d) * n_total + e;
      const float ah = dhi[i];
      const float al = dlo[i];
      const long long j = e + offs.v[d];
      const float wh = __ldg(xh + j);
      const float wl = __ldg(xl + j);
      const float p = __fmul_rn(ah, wh);
      float err = __fmaf_rn(ah, wh, -p);
      err = __fadd_rn(err, __fadd_rn(__fmul_rn(ah, wl), __fmul_rn(al, wh)));
      acc = df_add(acc, fast_two_sum(p, err));
    }
  }
  yh[e] = acc.hi;
  yl[e] = acc.lo;
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Returns
// cudaGetLastError() after the launch: 0 means the launch was taken.
extern "C" int smm_dia_spmv_padded_df(const void* diags_hi, const void* diags_lo,
                                      const void* xh, const void* xl, void* yh, void* yl,
                                      const void* offsets, int ndiags, long long n_total,
                                      long long lead, long long n_rows, void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  Offsets o{};
  const int* src = static_cast<const int*>(offsets);
  for (int d = 0; d < ndiags; ++d) o.v[d] = src[d];
  const unsigned int blocks = static_cast<unsigned int>((n_total + kThreads - 1) / kThreads);
  dia_padded_df_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(diags_hi), static_cast<const float*>(diags_lo),
      static_cast<const float*>(xh), static_cast<const float*>(xl), static_cast<float*>(yh),
      static_cast<float*>(yl), o, ndiags, n_total, lead, n_rows);
  return static_cast<int>(cudaGetLastError());
}
