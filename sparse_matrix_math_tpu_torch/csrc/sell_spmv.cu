// Slab-sorted SELL-32 sparse matrix products for Hopper (sm_90a), one
// template over the column count K: y = A x (K = 1) is the kernel behind K6
// (ELL) and K7 (W-SELL); Y = A X for K = 2..8 columns is K8.
//
// Replaces the Pallas TPU kernels
//   sparse_matrix_math_tpu/ops/pallas_spmv.py:  _ell_kernel (:392), called by
//     _ell_spmv_call (:405) -> ell_spmv (K6; Mosaic refused its gather, so on
//     the TPU it fell back to XLA, :446-449)
//   sparse_matrix_math_tpu/ops/pallas_wsell.py: _wsell_kernel (:89) and
//     _wsell_kernel_hbm (:119), helper _gather_products (:45) -> wsell_spmv
//     (K7); _wsell_spmm_kernel (:165) -> wsell_spmm (:287, K8)
// It reads the layout of formats/sell.py, derived with the matrix from its
// ELL or W-SELL planes: per 1024-row slab, rows sorted by term count
// (longest first) and cut into 32-row chunks; chunk c holds slot t of its 32
// rows at (chunk_ptr[c] + t) * 32 + lane, value and int32 column word, bit
// 31 of the word set where the product continues the previous term.  X and
// Y are row-major, (n_cols, K) and (n_rows, K): a column word names one row
// of X, K contiguous values.
//
// What bounds it: device-memory bytes.  Each slot's value and column word
// are read once per launch, for all K columns, the chunk pointers and row
// map once, X and Y once each:
//   slots * (itemsize + 4) + 8 * (n_chunks + 1) + 2 * 1024 * n_slabs
//     + K * (n_cols + n_rows) * itemsize
// with slots about 1.02 per nonzero on a 3-D stencil-like pattern: the ELL
// planes pad every row to the longest (K6 read 2.06 slots per nonzero on
// the jittered 3-D Laplacian), the W-SELL planes carry the TPU's lane
// routing padding (K7 and K8 2.62, the IC0 strict factor 4.63).
//
// Design.  One warp per chunk, one thread per row.  Value and column loads
// of a warp are one coalesced 128 B row each and stream, read once, with
// ld.global.nc.L1::no_allocate so that they do not evict X from L1; X is
// read through __ldg (L1 and the 50 MB L2 hold it), a row of X as 16 B
// vector loads where K * itemsize allows (float32 K = 4: one float4).  The
// term loop is unrolled by 2: two value/column pairs, then two rows of X,
// are in flight per thread before the first product.
//   K = 1: one block per slab.  32 registers a thread let two blocks (64
// warps) share an SM in float32 and float64 alike.  On the jittered 3-D
// Laplacian (tools/sell_tune.py, PERF.md) a second float64 block per SM
// gained 7-11%, unroll 4 or 8 moved the time by a few percent either way,
// and the kernel moves its bytes at 88-94% of a plain stream's rate with
// the SM's warp slots 96-97% resident: bandwidth-bound, so no cp.async or
// TMA stage.  Each thread stages its row's sum in shared memory at the
// row's place in the slab, and after one barrier the block writes y in
// natural row order, coalesced.
//   K > 1: 2K running values a thread (acc and open term per column) and
// the 2K values of two rows of X in flight take more registers than two
// 1024-thread blocks per SM leave (64 at K = 8 float64, before addresses),
// and a slab's rows in shared memory would take 1024 * K * itemsize (64 KB
// at K = 8 float64).  So a block is a quarter
// slab (kPanelThreads rows, 8 chunks) with its own register bound
// (PanelShape), and each thread writes its row of Y straight from
// registers, K contiguous values as vector stores: a sorted place maps to
// one row.  No barrier: a block's warps retire as their chunks end.
// Chunk offsets are 64-bit (a routed final pass reads a 28M-slot table).
//
// Summation order, per column as the planes' kernels: acc = 0, then acc +
// term for each term in order, a term being its first product plus each
// continuing product in order; every product and sum rounded on its own
// (__f*_rn, no FMA contraction).  Padding slots (value 0, column 0) start a
// term of 0 * x[0].  So column j of a K > 1 launch equals the K = 1 launch
// on column j bit for bit, and ops/sell_spmv.py's plain versions follow the
// same order: kernel and plain version agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kSlab = 1024;
constexpr int kChunk = 32;
constexpr int kUnroll = 2;     // value/column pairs in flight per thread
constexpr int kMinBlocks = 2;  // blocks per SM asked of the compiler, K = 1
constexpr int kPanelThreads = 256;  // rows per block, K > 1: a quarter slab
constexpr int kMaxColumns = 8;
constexpr int kColMask = 0x7fffffff;

// Threads and blocks per SM asked of the compiler for each instantiation.
// K > 1: four 256-thread blocks per SM (64 registers a thread); two (128)
// for float64 at K > 4, where the 4K values a thread holds (running values
// and two rows of X) alone take 40-64 registers.
template <typename T, int K>
struct PanelShape {
  static constexpr int threads = K == 1 ? kSlab : kPanelThreads;
  static constexpr int min_blocks = K == 1 ? kMinBlocks : (sizeof(T) * K > 32 ? 2 : 4);
};

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

// The row of X a column word names.
template <int K, typename T>
__device__ __forceinline__ const T* x_row(const T* x, int word) {
  if constexpr (K == 1) {
    return x + (word & kColMask);
  } else {
    return x + static_cast<long long>(word & kColMask) * K;
  }
}

// A row of K values through the read-only path, 16 B at a time where the
// row's size allows it (rows start at multiples of K * itemsize).
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&o)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      o[i] = v.x;
      o[i + 1] = v.y;
      o[i + 2] = v.z;
      o[i + 3] = v.w;
    }
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(p + i));
      o[i] = v.x;
      o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = __ldg(p + i);
  }
}
template <int K>
__device__ __forceinline__ void load_row(const double* p, double (&o)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2) {
      const double2 v = __ldg(reinterpret_cast<const double2*>(p + i));
      o[i] = v.x;
      o[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) o[i] = __ldg(p + i);
  }
}

// A row of K values of Y, stored as load_row reads one.
template <int K>
__device__ __forceinline__ void store_row(float* p, const float (&v)[K]) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
}
template <int K>
__device__ __forceinline__ void store_row(double* p, const double (&v)[K]) {
  if constexpr (K % 2 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 2)
      *reinterpret_cast<double2*>(p + i) = make_double2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = v[i];
  }
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
// x: (n_cols, K); y: (n_rows, K).
template <typename T, int K>
__global__ void __launch_bounds__(PanelShape<T, K>::threads, PanelShape<T, K>::min_blocks)
sell_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
            const long long* __restrict__ chunk_ptr, const short* __restrict__ row_of,
            const T* __restrict__ x, T* __restrict__ y, long long n_rows) {
  constexpr int kThreads = PanelShape<T, K>::threads;
  constexpr int kPerSlab = kSlab / kThreads;
  __shared__ T ys[K == 1 ? kSlab : 1];
  const long long slab = blockIdx.x / kPerSlab;
  const unsigned place = (blockIdx.x % kPerSlab) * kThreads + threadIdx.x;  // place in the slab
  const int lane = threadIdx.x % kChunk;
  const long long chunk = slab * (kSlab / kChunk) + place / kChunk;
  const long long begin = chunk_ptr[chunk];
  const int width = static_cast<int>(chunk_ptr[chunk + 1] - begin);
  const T* v = vals + begin * kChunk + lane;
  const int* c = cols + begin * kChunk + lane;

  T acc[K], term[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = term[j] = T(0);
  int t = 0;
  for (; t + kUnroll <= width; t += kUnroll) {
    int w[kUnroll];
    T val[kUnroll], xv[kUnroll][K];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      w[u] = ld_stream(c + (t + u) * kChunk);
      val[u] = ld_stream(v + (t + u) * kChunk);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row<K>(x_row<K>(x, w[u]), xv[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < K; ++j) step(acc[j], term[j], mul_rn(val[u], xv[u][j]), w[u]);
  }
  for (; t < width; ++t) {
    const int w = ld_stream(c + t * kChunk);
    const T val = ld_stream(v + t * kChunk);
    T xv[K];
    load_row<K>(x_row<K>(x, w), xv);
#pragma unroll
    for (int j = 0; j < K; ++j) step(acc[j], term[j], mul_rn(val, xv[j]), w);
  }
  if constexpr (K == 1) {
    ys[row_of[slab * kSlab + threadIdx.x]] = add_rn(acc[0], term[0]);
    __syncthreads();
    const long long row = slab * kSlab + threadIdx.x;
    if (row < n_rows) y[row] = ys[threadIdx.x];
  } else {
    const long long row = slab * kSlab + row_of[slab * kSlab + place];
    if (row < n_rows) {
      T out[K];
#pragma unroll
      for (int j = 0; j < K; ++j) out[j] = add_rn(acc[j], term[j]);
      store_row<K>(y + row * K, out);
    }
  }
}

template <typename T, int K>
int launch(const void* vals, const void* cols, const void* chunk_ptr, const void* row_of,
           const void* x, void* y, int n_slabs, long long n_rows, void* stream) {
  if (n_slabs < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slabs == 0 || n_rows == 0) return 0;
  constexpr int kThreads = PanelShape<T, K>::threads;
  sell_kernel<T, K><<<n_slabs * (kSlab / kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int*>(cols),
      static_cast<const long long*>(chunk_ptr), static_cast<const short*>(row_of),
      static_cast<const T*>(x), static_cast<T*>(y), n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_panel(const void* vals, const void* cols, const void* chunk_ptr, const void* row_of,
                 const void* x, void* y, int n_slabs, long long n_rows, int k, void* stream) {
  switch (k) {
#define SMM_SELL_CASE(K) \
  case K:                \
    return launch<T, K>(vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, stream);
    SMM_SELL_CASE(1)
    SMM_SELL_CASE(2)
    SMM_SELL_CASE(3)
    SMM_SELL_CASE(4)
    SMM_SELL_CASE(5)
    SMM_SELL_CASE(6)
    SMM_SELL_CASE(7)
    SMM_SELL_CASE(8)
#undef SMM_SELL_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
static_assert(kMaxColumns == 8, "launch_panel instantiates K = 1..8");

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py): x (n_cols, k) and
// y (n_rows, k) row-major, 1 <= k <= 8 (k = 1: vectors; k > 1: both 16 B
// aligned).  Each function returns cudaGetLastError() after its launch: 0
// means the launch was taken.
extern "C" {

int smm_sell_spmm_f32(const void* vals, const void* cols, const void* chunk_ptr,
                      const void* row_of, const void* x, void* y, int n_slabs, long long n_rows,
                      int k, void* stream) {
  return launch_panel<float>(vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, k, stream);
}

int smm_sell_spmm_f64(const void* vals, const void* cols, const void* chunk_ptr,
                      const void* row_of, const void* x, void* y, int n_slabs, long long n_rows,
                      int k, void* stream) {
  return launch_panel<double>(vals, cols, chunk_ptr, row_of, x, y, n_slabs, n_rows, k, stream);
}

}  // extern "C"
