// DIA sparse matrix-vector product y = A x for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sparse_matrix_math_tpu/ops/pallas_spmv.py:
//   _dia_kernel          (:91)  -> dia_kernel         one-shot, unpadded x
//   _dia_padded_kernel   (:254) -> dia_padded_kernel  padded layout
//   _dia_streamed_kernel (:281) -> dia_padded_kernel  the same kernel
//
// The TPU split x between a VMEM-resident kernel and one that streamed x
// windows from HBM by DMA, because VMEM holds ~40 MB.  The H100 has no such
// split: every read of x goes through the 50 MB L2, so one kernel serves
// every size and dia_spmv_streamed launches the padded kernel.
//
// What bounds it: device-memory bytes.  Each row reads ndiags diagonal
// values and writes one y value; x is read ndiags times but the shifted
// reads of neighbouring rows hit in L2, so about (ndiags + 2) * 4 B per row
// in f32 cross HBM (ndiags + 2) * 8 B in f64.  The design is the simplest
// one that streams at that bound: one thread per row, so the warp's reads
// of diags[d, :], x[e + off] and y are coalesced.  Staging x in shared
// memory with TMA is left for later work.
//
// Products and sums are rounded one by one (__fmul_rn / __fadd_rn, no FMA
// contraction) in ascending-offset order, the order of the JAX kernel.
// The plain PyTorch versions in ops/dia_spmv.py follow the same order, so
// kernel and plain version agree bit for bit.
//
// Index math is 64-bit: d * n_total + e reaches 2^31 at 27 diagonals and
// 80M rows.  Offsets arrive as a host array and travel as a kernel
// parameter (at most kMaxDiags of them, the DIA format's max_diags).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;
constexpr int kThreads = 256;

struct Offsets {
  int v[kMaxDiags];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Padded layout: diags (ndiags, n_total), xp and y (n_total,).  Rows
// outside [lead, lead + n_rows) are guard rows: they write an exact 0 and
// read nothing.  The layout's guards (at least -min(offsets) before lead,
// at least max(offsets) after the data) keep every read of an active row
// in bounds, so no clamp is needed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_padded_kernel(const T* __restrict__ diags, const T* __restrict__ xp,
                  T* __restrict__ y, const Offsets offs, int ndiags,
                  long long n_total, long long lead, long long n_rows) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_total) return;
  T acc = T(0);
  if (e >= lead && e < lead + n_rows) {
    acc = mul_rn(diags[e], __ldg(xp + e + offs.v[0]));
#pragma unroll
    for (int d = 1; d < kMaxDiags; ++d) {
      if (d >= ndiags) break;
      const T a = diags[static_cast<long long>(d) * n_total + e];
      acc = add_rn(acc, mul_rn(a, __ldg(xp + e + offs.v[d])));
    }
  }
  y[e] = acc;
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

template <typename T>
int launch_padded(const void* diags, const void* xp, void* y, const void* offsets,
                  int ndiags, long long n_total, long long lead, long long n_rows,
                  void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags) return static_cast<int>(cudaErrorInvalidValue);
  dia_padded_kernel<T><<<blocks_for(n_total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(diags), static_cast<const T*>(xp), static_cast<T*>(y),
      load_offsets(offsets, ndiags), ndiags, n_total, lead, n_rows);
  return static_cast<int>(cudaGetLastError());
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
// returns cudaGetLastError() after its launch: 0 means the launch was taken.
extern "C" {

int smm_dia_spmv_padded_f32(const void* diags, const void* xp, void* y, const void* offsets,
                            int ndiags, long long n_total, long long lead, long long n_rows,
                            void* stream) {
  return launch_padded<float>(diags, xp, y, offsets, ndiags, n_total, lead, n_rows, stream);
}

int smm_dia_spmv_padded_f64(const void* diags, const void* xp, void* y, const void* offsets,
                            int ndiags, long long n_total, long long lead, long long n_rows,
                            void* stream) {
  return launch_padded<double>(diags, xp, y, offsets, ndiags, n_total, lead, n_rows, stream);
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
