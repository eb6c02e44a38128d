// ELL sparse matrix-vector product y = A x for Hopper (sm_90a) (K6).
//
// Replaces the Pallas TPU kernel sparse_matrix_math_tpu/ops/pallas_spmv.py:
//   _ell_kernel (:392), called by _ell_spmv_call (:405) -> ell_kernel
// On the TPU that kernel never ran on the chip: Mosaic refused its 1-D
// gather, so ell_spmv fell back to XLA there (:446-449).  The card gathers
// natively, so the port's rmult on an ELLMatrix launches this kernel.
//
// What bounds it: device-memory bytes.  Every slot's value and int32 column
// are read once, x and y once each:
//   rows_padded * K * (itemsize + 4) + (n_cols + n_rows) * itemsize
// The design is the simplest one: one thread per row, summing its K slots
// in ascending order.  The planes are row-major (rows_padded, K), as the
// JAX format stores them, so neighbouring threads read K elements apart;
// each warp's 32 rows are one contiguous span that the k loop consumes
// through L1, so the lines are fetched once, but the loads are not
// coalesced.  A slot-major copy made at build time is later perf work.
//
// Summation order, as the TPU kernel: acc = vals[i,0] * x[cols[i,0]], then
// acc + vals[i,k] * x[cols[i,k]] for k = 1..K-1, each product and sum
// rounded on its own (no FMA contraction).  Padding slots hold value 0 and
// column 0, so they add 0 * x[0] as on the TPU.  ops/ell_spmv.py's plain
// version follows the same order, so kernel and plain version agree bit for
// bit.  Row offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// vals (rows_padded, k_slots), cols (rows_padded, k_slots) int32, x (n_cols,),
// y (n_rows,); rows past n_rows are padding and are not computed.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_kernel(const T* __restrict__ vals, const int* __restrict__ cols, const T* __restrict__ x,
           T* __restrict__ y, long long n_rows, int k_slots) {
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n_rows) return;
  const T* v = vals + row * k_slots;
  const int* c = cols + row * k_slots;
  T acc = mul_rn(v[0], __ldg(x + c[0]));
  for (int k = 1; k < k_slots; ++k) acc = add_rn(acc, mul_rn(v[k], __ldg(x + c[k])));
  y[row] = acc;
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, void* y, long long n_rows,
           int k_slots, void* stream) {
  if (k_slots < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  ell_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, k_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each function
// returns cudaGetLastError() after its launch: 0 means the launch was taken.
extern "C" {

int smm_ell_spmv_f32(const void* vals, const void* cols, const void* x, void* y,
                     long long n_rows, int k_slots, void* stream) {
  return launch<float>(vals, cols, x, y, n_rows, k_slots, stream);
}

int smm_ell_spmv_f64(const void* vals, const void* cols, const void* x, void* y,
                     long long n_rows, int k_slots, void* stream) {
  return launch<double>(vals, cols, x, y, n_rows, k_slots, stream);
}

}  // extern "C"
