// Slab-sorted SELL-32 sparse matrix-vector product y = A x for Hopper
// (sm_90a): the kernel behind K6 (ELL) and K7 (W-SELL, one column).
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_math_tpu/ops/pallas_spmv.py:  _ell_kernel (:392), called by
//     _ell_spmv_call (:405) -> ell_spmv (K6; Mosaic refused its gather, so on
//     the TPU it fell back to XLA, :446-449)
//   sparse_matrix_math_tpu/ops/pallas_wsell.py: _wsell_kernel (:89) and
//     _wsell_kernel_hbm (:119), helper _gather_products (:45) -> wsell_spmv
//     (K7).  K8, Y = A X for 2..8 columns, stays on csrc/wsell_spmv.cu over
//     the W-SELL planes.
// It reads the layout of formats/sell.py, derived with the matrix from its
// ELL or W-SELL planes: per 1024-row slab, rows sorted by term count
// (longest first) and cut into 32-row chunks; chunk c holds slot t of its 32
// rows at (chunk_ptr[c] + t) * 32 + lane, value and int32 column word, bit
// 31 of the word set where the product continues the previous term.
//
// What bounds it: device-memory bytes.  Each slot's value and column word
// are read once, the chunk pointers and row map once, x and y once each:
//   slots * (itemsize + 4) + 8 * (n_chunks + 1) + 2 * 1024 * n_slabs
//     + (n_cols + n_rows) * itemsize
// with slots about 1.02 per nonzero on a 3-D stencil-like pattern: the ELL
// planes pad every row to the longest (K6 read 2.06 slots per nonzero on
// the jittered 3-D Laplacian), the W-SELL planes carry the TPU's lane
// routing padding (K7 2.62, the IC0 strict factor 4.63).
//
// Design.  One block per slab, one warp per chunk, one thread per row.
// Value and column loads of a warp are one coalesced 128 B row each and
// stream, read once, with ld.global.nc.L1::no_allocate so that they do not
// evict x from L1; x is read through __ldg (L1 and the 50 MB L2 hold it).
// The term loop is unrolled by 2: two value/column pairs, then two x
// gathers, are in flight per thread before the first product, and 32
// registers a thread let two blocks (64 warps) share an SM in float32 and
// float64 alike.  On the jittered 3-D Laplacian (tools/sell_tune.py,
// PERF.md) a second float64 block per SM gained 7-11%, unroll 4 or 8 moved
// the time by a few percent either way, and the kernel moves its bytes at
// 88-94% of a plain stream's rate with the SM's warp slots 96-97% resident:
// bandwidth-bound, so no cp.async or TMA stage.  Each thread
// stages its row's sum in shared memory at the row's place in the slab, and
// after one barrier the block writes y in natural row order, coalesced.
// Chunk offsets are 64-bit (a routed final pass reads a 28M-slot table).
//
// Summation order, as the planes' kernels: acc = 0, then acc + term for each
// term in order, a term being its first product plus each continuing
// product in order; every product and sum rounded on its own (__f*_rn, no
// FMA contraction).  Padding slots (value 0, column 0) start a term of
// 0 * x[0].  ops/sell_spmv.py's plain version follows the same order, so
// kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 1024;
constexpr int kChunk = 32;
constexpr int kUnroll = 2;     // value/column pairs in flight per thread
constexpr int kMinBlocks = 2;  // blocks per SM asked of the compiler
constexpr int kColMask = 0x7fffffff;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// Read-once loads: non-coherent path, no L1 allocation.
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm volatile("ld.global.nc.L1::no_allocate.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// One product into the running row: a continuing product joins the open
// term, any other closes it into acc and opens a new one.
template <typename T>
__device__ __forceinline__ void step(T& acc, T& term, T prod, int word) {
  if (word < 0) {
    term = add_rn(term, prod);
  } else {
    acc = add_rn(acc, term);
    term = prod;
  }
}

// vals, cols: (slots,); chunk_ptr: (n_slabs * 32 + 1,); row_of: (n_slabs * 1024,);
// x: (n_cols,); y: (n_rows,).
template <typename T>
__global__ void __launch_bounds__(kSlab, kMinBlocks)
sell_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
            const long long* __restrict__ chunk_ptr, const short* __restrict__ row_of,
            const T* __restrict__ x, T* __restrict__ y, long long n_rows) {
  __shared__ T ys[kSlab];
  const long long slab = blockIdx.x;
  const int lane = threadIdx.x % kChunk;
  const long long chunk = slab * (kSlab / kChunk) + threadIdx.x / kChunk;
  const long long begin = chunk_ptr[chunk];
  const int width = static_cast<int>(chunk_ptr[chunk + 1] - begin);
  const T* v = vals + begin * kChunk + lane;
  const int* c = cols + begin * kChunk + lane;

  T acc = T(0), term = T(0);
  int t = 0;
  for (; t + kUnroll <= width; t += kUnroll) {
    int w[kUnroll];
    T val[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = ld_stream(c + (t + u) * kChunk);
      val[u] = ld_stream(v + (t + u) * kChunk);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = __ldg(x + (w[u] & kColMask));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step(acc, term, mul_rn(val[u], xv[u]), w[u]);
  }
  for (; t < width; ++t) {
    const int w = ld_stream(c + t * kChunk);
    step(acc, term, mul_rn(ld_stream(v + t * kChunk), __ldg(x + (w & kColMask))), w);
  }
  ys[row_of[slab * kSlab + threadIdx.x]] = add_rn(acc, term);
  __syncthreads();
  const long long row = slab * kSlab + threadIdx.x;
  if (row < n_rows) y[row] = ys[threadIdx.x];
}

template <typename T>
int launch(const void* vals, const void* cols, const void* chunk_ptr, const void* row_of,
           const void* x, void* y, int n_slabs, long long n_rows, void* stream) {
  if (n_slabs < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slabs == 0 || n_rows == 0) return 0;
  sell_kernel<T><<<n_slabs, kSlab, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols),
      static_cast<const long long*>(chunk_ptr), static_cast<const short*>(row_of),
      static_cast<const T*>(x), static_cast<T*>(y), n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each function
// returns cudaGetLastError() after its launch: 0 means the launch was taken.
extern "C" {

int smm_sell_spmv_f32(const void* vals, const void* cols, const void* chunk_ptr,
                      const void* row_of, const void* x, void* y, int n_slabs, long long n_rows,
                      void* stream) {
  return launch<float>(vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, stream);
}

int smm_sell_spmv_f64(const void* vals, const void* cols, const void* chunk_ptr,
                      const void* row_of, const void* x, void* y, int n_slabs, long long n_rows,
                      void* stream) {
  return launch<double>(vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, stream);
}

}  // extern "C"
