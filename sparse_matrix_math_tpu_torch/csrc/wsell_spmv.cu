// W-SELL sparse matrix product for Hopper (sm_90a): Y = A X for up to 8
// columns of X (K8), over the W-SELL planes.
//
// Replaces the Pallas TPU kernel of sparse_matrix_math_tpu/ops/pallas_wsell.py:
//   _wsell_spmm_kernel  (:165), helper _gather_products (:45)
//     -> wsell_kernel<T, 8, NWAY>   (smm_wsell_spmm_*, k = 1..8)
// K7 (y = A x, TPU _wsell_kernel :89 / _wsell_kernel_hbm :119) reads the
// slab-sorted SELL-32 layout derived from these planes instead
// (csrc/sell_spmv.cu); this kernel computes the same sums in the same order.
// The layout is formats/wsell.py's: per vreg v (plane rows 8v..8v+7, 128
// lanes), meta holds SW | LSRC << sw_bits | SHIFT << (sw_bits + 7); the
// slot at (p, L) multiplies vals[8v+p, L] by x[(base[v] + sw) * 128 + lsrc]
// with lsrc from its own meta and sw from meta[8v+p, lsrc], and the product
// lands on output sublane (p + shift) % 8 of slab slab[v].
//
// What bounds it: device-memory bytes.  Each slot's value and meta word are
// read once, x and y once each:
//   n_vregs * 1024 * (itemsize + 4) + 8 * n_vregs + k * (n_cols + n_rows) * itemsize
// (the W-SELL padding, slot_ratio slots per nonzero, is part of the planes).
// x is gathered, but its windows are reused by neighbouring vregs and stay
// in the 50 MB L2, so the TPU's VMEM-resident / HBM-streamed split is one
// kernel here.
//
// Design.  One block per 1024-row slab, so a slab's rows are summed by one
// block in a fixed order and no float atomics are needed; slab_ptr (built
// with the matrix) gives each block its vreg range.  The block is 4 groups
// of 128 threads, one thread per lane: each pass, group g takes vreg
// vb + g, loads its 8 meta words and values (coalesced 512 B rows), stages
// the meta in shared memory for the SW lookup at lane lsrc, gathers x,
// multiplies, applies the nway rotation in registers and stages the 8
// routed products.  Then each thread adds the staged products of its two
// output rows (sublanes g and g + 4) in vreg order.  The 4 groups keep 4
// vregs' loads in flight per pass.  Blocks start from the last slab, which
// also holds the layout's chunk-pad vregs (up to 255 of them), so the
// longest block starts first.  A K8 launch reads each slot once and applies
// it to every column of the launch (the columns loop inside the pass).
//
// Summation order, as _gather_products (:67-86): a routed product is the
// shift-0 product of its position, then the rotated ones in rotation order,
// each a separate rounding; the slab's rows then add the routed products of
// their vregs in ascending vreg order.  Chunk-pad vregs multiply 0 * x like
// the TPU kernel.  Products and sums are rounded one by one (no FMA
// contraction); ops/wsell_spmv.py's plain version follows the same order,
// so kernel and plain version agree bit for bit.  Plane offsets are 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kGroups = 4;
constexpr int kThreads = kGroups * kLane;
constexpr int kMaxColumns = 8;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// vals, meta: (n_vregs * 8, 128); base: (n_vregs,); slab_ptr: (n_slabs + 1,);
// x: (n_cols, k) and y: (n_rows, k), row-major; k <= KMAX.
template <typename T, int KMAX, int NWAY>
__global__ void __launch_bounds__(kThreads)
wsell_kernel(const T* __restrict__ vals, const int* __restrict__ meta,
             const int* __restrict__ base, const int* __restrict__ slab_ptr,
             const T* __restrict__ x, T* __restrict__ y, int n_slabs, long long n_rows,
             long long n_cols, int k, int sw_bits) {
  __shared__ int smeta[kGroups][8][kLane];
  __shared__ T tbuf[kGroups][8][kLane];
  const int g = threadIdx.x / kLane;
  const int lane = threadIdx.x % kLane;
  const int s = n_slabs - 1 - blockIdx.x;  // the chunk-padded last slab first
  const int v_begin = slab_ptr[s];
  const int v_end = slab_ptr[s + 1];
  const int sw_mask = (1 << sw_bits) - 1;
  constexpr int kStep = 8 / NWAY;

  T acc[2][KMAX];  // output sublanes g and g + 4
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[h][j] = T(0);

  for (int vb = v_begin; vb < v_end; vb += kGroups) {
    const int v = vb + g;
    const bool active = v < v_end;
    int m[8];
    T val[8];
    long long col[8];
    if (active) {
      const long long row0 = static_cast<long long>(v) * 8;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const long long at = (row0 + p) * kLane + lane;
        m[p] = meta[at];
        val[p] = vals[at];
        smeta[g][p][lane] = m[p];
      }
    }
    __syncthreads();
    if (active) {
      const long long b = base[v];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int lsrc = (m[p] >> sw_bits) & (kLane - 1);
        const int sw = smeta[g][p][lsrc] & sw_mask;
        col[p] = (b + sw) * kLane + lsrc;
      }
    }
    const int nv = min(kGroups, v_end - vb);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j >= k) break;  // k is the same in every thread
      if (active) {
        T prod[8];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const T xv = col[p] < n_cols ? __ldg(x + col[p] * k + j) : T(0);
          prod[p] = mul_rn(val[p], xv);
        }
        if (NWAY == 1) {
#pragma unroll
          for (int q = 0; q < 8; ++q) tbuf[g][q][lane] = prod[q];
        } else {
          int sh[8];
#pragma unroll
          for (int p = 0; p < 8; ++p) sh[p] = (m[p] >> (sw_bits + 7)) & 7;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            T t = sh[q] == 0 ? prod[q] : T(0);
#pragma unroll
            for (int r = 1; r < NWAY; ++r) {
              const int p = (q - r * kStep) & 7;
              t = add_rn(t, sh[p] == r * kStep ? prod[p] : T(0));
            }
            tbuf[g][q][lane] = t;
          }
        }
      }
      __syncthreads();
      for (int i = 0; i < nv; ++i) {
        acc[0][j] = add_rn(acc[0][j], tbuf[i][g][lane]);
        acc[1][j] = add_rn(acc[1][j], tbuf[i][g + 4][lane]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = static_cast<long long>(s) * 1024 + (g + 4 * h) * kLane + lane;
    if (row < n_rows) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < k) y[row * k + j] = acc[h][j];
    }
  }
}

template <typename T, int KMAX>
int launch_nway(const void* vals, const void* meta, const void* base, const void* slab_ptr,
                const void* x, void* y, int n_slabs, long long n_rows, long long n_cols,
                int k, int sw_bits, int nway, cudaStream_t stream) {
  const dim3 grid(n_slabs), block(kThreads);
#define SMM_WSELL_LAUNCH(N)                                                              \
  wsell_kernel<T, KMAX, N><<<grid, block, 0, stream>>>(                                  \
      static_cast<const T*>(vals), static_cast<const int*>(meta),                       \
      static_cast<const int*>(base), static_cast<const int*>(slab_ptr),                 \
      static_cast<const T*>(x), static_cast<T*>(y), n_slabs, n_rows, n_cols, k, sw_bits)
  switch (nway) {
    case 1: SMM_WSELL_LAUNCH(1); break;
    case 2: SMM_WSELL_LAUNCH(2); break;
    case 4: SMM_WSELL_LAUNCH(4); break;
    case 8: SMM_WSELL_LAUNCH(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SMM_WSELL_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* vals, const void* meta, const void* base, const void* slab_ptr,
           const void* x, void* y, int n_slabs, long long n_rows, long long n_cols, int k,
           int sw_bits, int nway, void* stream) {
  if (k < 1 || k > kMaxColumns || sw_bits < 3 || sw_bits > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slabs == 0) return 0;
  return launch_nway<T, kMaxColumns>(vals, meta, base, slab_ptr, x, y, n_slabs, n_rows,
                                     n_cols, k, sw_bits, nway,
                                     static_cast<cudaStream_t>(stream));
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Each function
// returns cudaGetLastError() after its launch: 0 means the launch was taken.
extern "C" {

int smm_wsell_spmm_f32(const void* vals, const void* meta, const void* base,
                       const void* slab_ptr, const void* x, void* y, int n_slabs,
                       long long n_rows, long long n_cols, int k, int sw_bits, int nway,
                       void* stream) {
  return launch<float>(vals, meta, base, slab_ptr, x, y, n_slabs, n_rows, n_cols, k, sw_bits,
                       nway, stream);
}

int smm_wsell_spmm_f64(const void* vals, const void* meta, const void* base,
                       const void* slab_ptr, const void* x, void* y, int n_slabs,
                       long long n_rows, long long n_cols, int k, int sw_bits, int nway,
                       void* stream) {
  return launch<double>(vals, meta, base, slab_ptr, x, y, n_slabs, n_rows, n_cols, k, sw_bits,
                        nway, stream);
}

}  // extern "C"
