// One R-SELL routing pass for Hopper (sm_90a): the stream gather (K11).
//
// Replaces the Pallas TPU kernels of sparse_matrix_math_tpu/ops/pallas_rsell.py:
//   _stream_kernel      (:32) and _stream_kernel_hbm (:47), entry stream_gather (:89),
//   with the select pipeline _gather_products (pallas_wsell.py:45-69) at nway 1
//   -> stream_gather_kernel<T>   (smm_stream_gather_f32 / _f64)
// The layout is formats/rsell.py's StreamPass: per vreg v (plane rows
// 8v..8v+7, 128 lanes), meta holds SW | LSRC << sw_bits, and the slot at
// (p, L) is
//   out[(8v+p) * 128 + L] = vals[8v+p, L] * table[(base[v] + sw) * 128 + lsrc]
// with lsrc from the slot's own meta word and sw from meta[8v+p, lsrc]: the
// W-SELL gather without the slab accumulate.  Every vreg writes its own 1024
// output slots, so there is no sum, no atomic and no order to keep: one
// product per slot, rounded once (__fmul_rn / __dmul_rn), and the plain
// version in ops/stream_gather.py computes the same product, so kernel and
// plain version agree bit for bit.
//
// What bounds it: device-memory bytes.  Each slot's value and meta word are
// read once and its output written once, the bases and the table read once:
//   n_vregs * 1024 * (2 * itemsize + 4) + 4 * n_vregs + table_len * itemsize
// The table is gathered, but a vreg's 1024 reads fall into one window stack
// of 8F rows (F <= 16: at most 64 KB in f32) and neighbouring vregs share
// stacks, so the windows stay in the 50 MB L2.  The TPU's split into a
// VMEM-resident table and an HBM table with per-window DMA
// (_VMEM_TABLE_BYTES, force_hbm, pallas_rsell.py:80-82, 116) is one kernel
// here.  A table index at or past table_len reads 0: the JAX wrapper pads
// the table with zeros up to x_rows * 128 (:114) and the port does not copy.
//
// Design.  A block is 4 groups of 128 threads, one thread per lane, one vreg
// per group: each thread loads its lane's 8 meta words and 8 values
// (coalesced 512 B rows), stages the meta words in shared memory, and after
// one barrier looks up sw at lane lsrc, reads the table, multiplies and
// stores its 8 outputs (coalesced again).  Plane offsets and table indices
// are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kGroups = 4;
constexpr int kThreads = kGroups * kLane;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// vals, meta, out: (n_vregs * 8, 128); base: (n_vregs,); table: (table_len,)
template <typename T>
__global__ void __launch_bounds__(kThreads)
stream_gather_kernel(const T* __restrict__ vals, const int* __restrict__ meta,
                     const int* __restrict__ base, const T* __restrict__ table,
                     T* __restrict__ out, long long n_vregs, long long table_len,
                     int sw_bits) {
  __shared__ int smeta[kGroups][8][kLane];
  const int g = threadIdx.x / kLane;
  const int lane = threadIdx.x % kLane;
  const long long v = static_cast<long long>(blockIdx.x) * kGroups + g;
  const bool active = v < n_vregs;
  const int sw_mask = (1 << sw_bits) - 1;
  const long long at0 = v * 8 * kLane + lane;

  int m[8];
  T val[8];
  if (active) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      m[p] = meta[at0 + p * kLane];
      val[p] = vals[at0 + p * kLane];
      smeta[g][p][lane] = m[p];
    }
  }
  __syncthreads();
  if (!active) return;
  const long long b = base[v];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int lsrc = (m[p] >> sw_bits) & (kLane - 1);
    const int sw = smeta[g][p][lsrc] & sw_mask;
    const long long idx = (b + sw) * kLane + lsrc;
    const T t = idx < table_len ? __ldg(table + idx) : T(0);
    out[at0 + p * kLane] = mul_rn(val[p], t);
  }
}

template <typename T>
int launch(const void* vals, const void* meta, const void* base, const void* table, void* out,
           long long n_vregs, long long table_len, int sw_bits, void* stream) {
  if (sw_bits < 3 || sw_bits > 7 || n_vregs < 0 || table_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_vregs == 0) return 0;
  const long long blocks = (n_vregs + kGroups - 1) / kGroups;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  stream_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(meta),
      static_cast<const int*>(base), static_cast<const T*>(table), static_cast<T*>(out),
      n_vregs, table_len, sw_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each function
// returns cudaGetLastError() after its launch: 0 means the launch was taken.
extern "C" {

int smm_stream_gather_f32(const void* vals, const void* meta, const void* base,
                          const void* table, void* out, long long n_vregs,
                          long long table_len, int sw_bits, void* stream) {
  return launch<float>(vals, meta, base, table, out, n_vregs, table_len, sw_bits, stream);
}

int smm_stream_gather_f64(const void* vals, const void* meta, const void* base,
                          const void* table, void* out, long long n_vregs,
                          long long table_len, int sw_bits, void* stream) {
  return launch<double>(vals, meta, base, table, out, n_vregs, table_len, sw_bits, stream);
}

}  // extern "C"
