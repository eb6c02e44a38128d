// Fused triangular-sweep preconditioner applies for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel family of
// sparse_matrix_math_tpu/ops/pallas_trisweep.py:54 _make_kernel:
//   sgs_apply_fused      (:168, pallas_call :213)  use_mid=True   -> smm_sgs_apply_*
//   tri_pair_apply_fused (:243, pallas_call :278)  use_mid=False  -> smm_tri_pair_apply_*
//
// Both compute z = M^{-1} r in the flat padded layout of ops/dia_spmv.py's
// PaddedDIA, with the strict factors L and U stored as padded DIA
// diagonals that share the full matrix's geometry:
//
//   forward : x_0 = r * invd_l ;  x_{s+1} = (r - sum_d L_d[e] x_s[e+off_d]) * invd_l
//   middle  : rhs2 = diag * x    (SGS)   |   rhs2 = x   (IC0 / ILU0 pair)
//   backward: y_0 = rhs2 * invd_u ; y_{s+1} = (rhs2 - sum_d U_d[e] y_s[e+off_d]) * invd_u
//
// with sweeps-1 sweeps in each direction.  For SGS invd_u == invd_l; for an
// ILU0 pair invd_l is 1 on data rows (unit L).  An empty strict part is a
// pure diagonal scale.
//
// Design: one thread per padded element and one launch per step, 2*sweeps
// launches per apply on the caller's stream.  A sweep reads neighbours up to
// max|offset| rows away that other blocks write in the previous sweep, so
// the launch boundary is the grid-wide barrier.  The TPU kernel instead ran
// every sweep inside one grid step over halo-deepened VMEM windows
// (pallas_trisweep.py:188-193) fed by double-buffered DMA (:87-132); fusing
// the sweeps of one apply into a single launch (cooperative grid sync, or
// shared-memory halo tiles) is left for later work.
//
// What bounds it: device-memory bytes.  A sweep reads the strict diagonals,
// the rhs, the inverse diagonal and x, and writes x: about
// (nd_strict + 4) * itemsize per row, the shifted reads of x hitting in L2.
// The init step reads r (and diag) and the inverse diagonal and writes one
// or two vectors.
//
// Exactness: every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn and the __d* forms; no FMA
// contraction), the strict diagonals are summed in ascending-offset order,
// then subtracted from the rhs, then scaled by the inverse diagonal; SGS's
// middle is diag * x, then * invd_u, as two roundings.  The plain PyTorch
// versions in ops/trisweep.py do the same operations in the same order, so
// kernel and plain version agree bit for bit.
//
// Guards: rows outside [lead, lead + n_rows) write an exact 0 and read
// nothing.  The shared geometry's guards cover max|offset| on both sides,
// so every read of a data row stays in bounds.  Index math is 64-bit.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;  // DIA's max_diags, as in dia_spmv.cu
constexpr int kThreads = 256;

struct Offsets {
  int v[kMaxDiags];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Init step of one direction: v = src (times mid, when mid is given);
// rhs2[e] = v when rhs2 is given; out[e] = v * invd.  src and rhs2 may be
// the same buffer (SGS's middle scale in place): each element is read
// before it is written, by the same thread.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scale_kernel(const T* src, const T* __restrict__ mid, const T* __restrict__ invd,
             T* rhs2, T* __restrict__ out, long long n_total, long long lead,
             long long n_rows) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_total) return;
  if (e < lead || e >= lead + n_rows) {
    if (rhs2 != nullptr) rhs2[e] = T(0);
    out[e] = T(0);
    return;
  }
  T v = src[e];
  if (mid != nullptr) v = mul_rn(mid[e], v);
  if (rhs2 != nullptr) rhs2[e] = v;
  out[e] = mul_rn(v, invd[e]);
}

// One Jacobi sweep: y[e] = (rhs[e] - sum_d diags[d, e] * x[e + off_d]) * invd[e].
template <typename T>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ diags, const Offsets offs, int ndiags,
             const T* __restrict__ rhs, const T* __restrict__ invd,
             const T* __restrict__ x, T* __restrict__ y, long long n_total,
             long long lead, long long n_rows) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n_total) return;
  if (e < lead || e >= lead + n_rows) {
    y[e] = T(0);
    return;
  }
  T acc = mul_rn(diags[e], __ldg(x + e + offs.v[0]));
#pragma unroll
  for (int d = 1; d < kMaxDiags; ++d) {
    if (d >= ndiags) break;
    const T a = diags[static_cast<long long>(d) * n_total + e];
    acc = add_rn(acc, mul_rn(a, __ldg(x + e + offs.v[d])));
  }
  y[e] = mul_rn(sub_rn(rhs[e], acc), invd[e]);
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

// One direction: the init step writes `first`, then each of the sweeps-1
// sweeps (none when the strict part is empty) writes the other buffer of
// the pair.  *result is the buffer holding the last write.
template <typename T>
int direction(const T* src, const T* mid, const T* invd, T* rhs2_out, const T* diags,
              const void* offsets, int ndiags, int sweeps, T* first, T* second,
              long long n_total, long long lead, long long n_rows, cudaStream_t stream,
              T** result) {
  const unsigned int grid = blocks_for(n_total);
  scale_kernel<T><<<grid, kThreads, 0, stream>>>(src, mid, invd, rhs2_out, first, n_total,
                                                 lead, n_rows);
  int code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  // the rhs of the sweeps: rhs2 when it was written, else src itself
  const T* rhs = rhs2_out != nullptr ? rhs2_out : src;
  T* cur = first;
  T* nxt = second;
  if (ndiags > 0) {
    const Offsets offs = load_offsets(offsets, ndiags);
    for (int s = 1; s < sweeps; ++s) {
      sweep_kernel<T><<<grid, kThreads, 0, stream>>>(diags, offs, ndiags, rhs, invd, cur, nxt,
                                                     n_total, lead, n_rows);
      code = static_cast<int>(cudaGetLastError());
      if (code != 0) return code;
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  *result = cur;
  return 0;
}

// The whole apply.  w0 and w1 are scratch vectors of n_total elements and
// out receives z; none of them may alias r or each other.  mid is the SGS
// diagonal, or null for a factor pair.
template <typename T>
int launch_apply(const void* r_, const void* invd_l_, const void* invd_u_, const void* mid_,
                 const void* ld_, const void* l_offsets, int nd_l, const void* ud_,
                 const void* u_offsets, int nd_u, void* w0_, void* w1_, void* out_,
                 int sweeps, long long n_total, long long lead, long long n_rows,
                 void* stream_) {
  if (sweeps < 1 || nd_l < 0 || nd_l > kMaxDiags || nd_u < 0 || nd_u > kMaxDiags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* r = static_cast<const T*>(r_);
  const T* invd_l = static_cast<const T*>(invd_l_);
  const T* invd_u = static_cast<const T*>(invd_u_);
  const T* mid = static_cast<const T*>(mid_);
  T* w0 = static_cast<T*>(w0_);
  T* w1 = static_cast<T*>(w1_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);

  // forward, in w0 / w1
  T* xw = nullptr;  // w0 or w1: the forward result
  int code = direction<T>(r, nullptr, invd_l, nullptr, static_cast<const T*>(ld_), l_offsets,
                          nd_l, sweeps, w0, w1, n_total, lead, n_rows, stream, &xw);
  if (code != 0) return code;
  T* other = xw == w0 ? w1 : w0;

  // backward: rhs2 is xw (scaled by mid in place for SGS); the iterates
  // alternate between `other` and `out`, starting so that the last write
  // is `out`.
  const int writes = nd_u > 0 ? sweeps : 1;
  T* first = (writes % 2 == 1) ? out : other;
  T* second = (writes % 2 == 1) ? other : out;
  T* z = nullptr;
  code = direction<T>(xw, mid, invd_u, mid != nullptr ? xw : nullptr,
                      static_cast<const T*>(ud_), u_offsets, nd_u, sweeps, first, second,
                      n_total, lead, n_rows, stream, &z);
  if (code != 0) return code;
  return z == out ? 0 : static_cast<int>(cudaErrorUnknown);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Every function
// returns the first non-zero cudaGetLastError() of its launches, or 0.
extern "C" {

// r, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1, out,
// sweeps, n_total, lead, n_rows, stream
int smm_sgs_apply_f32(const void* r, const void* invd, const void* diag, const void* ld,
                      const void* l_offsets, int nd_l, const void* ud, const void* u_offsets,
                      int nd_u, void* w0, void* w1, void* out, int sweeps, long long n_total,
                      long long lead, long long n_rows, void* stream) {
  return launch_apply<float>(r, invd, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0,
                             w1, out, sweeps, n_total, lead, n_rows, stream);
}

int smm_sgs_apply_f64(const void* r, const void* invd, const void* diag, const void* ld,
                      const void* l_offsets, int nd_l, const void* ud, const void* u_offsets,
                      int nd_u, void* w0, void* w1, void* out, int sweeps, long long n_total,
                      long long lead, long long n_rows, void* stream) {
  return launch_apply<double>(r, invd, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0,
                              w1, out, sweeps, n_total, lead, n_rows, stream);
}

// r, invd_l, invd_u, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1, out,
// sweeps, n_total, lead, n_rows, stream
int smm_tri_pair_apply_f32(const void* r, const void* invd_l, const void* invd_u,
                           const void* ld, const void* l_offsets, int nd_l, const void* ud,
                           const void* u_offsets, int nd_u, void* w0, void* w1, void* out,
                           int sweeps, long long n_total, long long lead, long long n_rows,
                           void* stream) {
  return launch_apply<float>(r, invd_l, invd_u, nullptr, ld, l_offsets, nd_l, ud, u_offsets,
                             nd_u, w0, w1, out, sweeps, n_total, lead, n_rows, stream);
}

int smm_tri_pair_apply_f64(const void* r, const void* invd_l, const void* invd_u,
                           const void* ld, const void* l_offsets, int nd_l, const void* ud,
                           const void* u_offsets, int nd_u, void* w0, void* w1, void* out,
                           int sweeps, long long n_total, long long lead, long long n_rows,
                           void* stream) {
  return launch_apply<double>(r, invd_l, invd_u, nullptr, ld, l_offsets, nd_l, ud, u_offsets,
                              nd_u, w0, w1, out, sweeps, n_total, lead, n_rows, stream);
}

}  // extern "C"
