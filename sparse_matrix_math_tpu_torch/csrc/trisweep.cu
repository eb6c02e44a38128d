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
//   backward: y_0 = rhs2 * invd_u ; y_{s+1} = (rhs2 - U y_s) * invd_u
//
// with sweeps-1 sweeps in each direction.  For SGS invd_u == invd_l; for an
// ILU0 pair invd_l is 1 on data rows (unit L).  An empty strict part is a
// pure diagonal scale.
//
// What bounds it: device-memory bytes.  An apply must read r, the inverse
// diagonal(s), D (SGS) and the strict diagonals once and write z once; at
// poisson_2d(1414) float32 that is 64 MB, 0.019 ms at 3.35 TB/s.
//
// Design: halo windows ("temporal blocking"), one launch per direction,
// window_kernel.  The windows are one-sided: L's offsets are negative, so
// forward sweep s+1 of row e reads only rows below e; U's are positive, so
// the backward sweeps read only rows above.  Each CTA (one per SM) owns a
// tile of `tile` consecutive padded rows and walks its window
// [tile_start - (levels - 1) * reach, tile_end) (mirrored upward for the
// backward launch) in chunks of kChunk rows, in the direction of the
// dependences.  A chunk's operands (rhs, inverse diagonal, D, strict
// diagonals) are read from device memory once, by 16-byte cp.async copies
// into a staging ring kStages chunks deep, and serve every level (x_0 ..
// x_{levels-1}) of the chunk.  Level k of a row reads level k-1 of rows up
// to `reach` behind it, so each level but the last keeps a ring of
// reach + kChunk rows in shared memory; the last level is written to
// device memory, on the tile's rows only.  Level k runs on the chunks its
// dependence cone (rows from tile_start - (levels-1-k) * reach) reaches, so
// the rows of the tile depend on nothing outside the window; a row of such
// a chunk outside the cone leaves a ring value no row of the cone reads.
// A __syncthreads() follows each level of a chunk.  The halo rows are read
// again by the neighbouring CTAs, mostly from L2: at poisson_2d(1414) a tile
// is 15,360 rows and the halo at sweeps 4 4,242.  Shared memory holds only
// the rings and the staging, independent of the tile.  With 1-4 strict
// diagonals (every 2-D stencil, the 3-D 7-point one) the kernel is
// instantiated for the count, the offsets and each chunk's coefficients
// held in registers across the levels.  The TPU kernel ran every sweep
// inside one grid step over halo-deepened VMEM windows too
// (pallas_trisweep.py:188-193), two-sided and with a margin; this one is
// one-sided and walks the window as a stream.
//
// Large reach: the ring kernel (ring_kernel), one launch per direction
// too.  Where a level's ring outgrows the shared memory (poisson_3d(243):
// reach 59,049 rows, 236 KB a level in float32) or the halo reaches two
// tiles (every CTA would sweep most of a neighbour's rows again), the
// levels go to device memory instead, but only to a small ring of them
// that stays in L2.  The padded vector is cut into chunks (4,096 float32
// or 2,048 float64 rows with 1-4 strict diagonals, else 1,024), taken in
// the dependences' order (ascending forward, descending backward) by
// persistent CTAs, two an SM, through an atomic ticket.  A CTA copies its
// chunk's operands (rhs, inverse diagonal, strict diagonals) from device
// memory once, by 16-byte cp.async runs marked L2 evict-first, into shared
// memory, and computes every level of the chunk: level k of row e reads
// level k-1 of rows up to `reach` behind it, from the chunk itself (a
// shared-memory copy of its previous level) or from the level's global
// ring, `ring_rows` rows allocated by the caller, with L2-only loads and
// stores (ld/st.global.cg; an offset of a chunk or more issues all its
// loads before it uses one); the last level is written to the output.
// Per chunk a flag counts its levels done: level k of chunk c waits until
// level k-1 of the chunks its rows read (for each offset, the chunks of
// its first and last row) is published, and a chunk waits before it
// starts until every level of the readers of its slot's previous chunk
// (c - ring_chunks .. c - ring_chunks + h, h = ceil(reach / chunk);
// mirrored backward) is done.  Publishing is the stores, a barrier, then
// one thread's fence.acq_rel.gpu and relaxed flag store; waiting is
// ld.acquire.gpu, then a barrier.  The chunks in flight stagger by one
// level (chunk c's level k needs chunk c-1's level k-1), so they do not
// serialize, but every level costs a publish and a poll: the kernel is
// bound by that latency and the rows two CTAs hold, not by device-memory
// bytes.  The caller sizes the ring h + 1 + grid chunks (ops/trisweep.py
// ring_chunks), so the reuse wait rarely blocks; a ring shorter than h + 1
// chunks is refused (a chunk would wait on itself).  No deadlock: a CTA
// waits only on chunks of lower tickets, each held by a running CTA (a
// ticket is taken only by a running CTA, so the grid need not be
// resident), and the lowest unfinished chunk waits on nothing unfinished.
// The tickets and flags (2 + 2 * ceil(n_total / kChunk) ints, the forward
// launch's apart from the backward's) are zeroed by a cudaMemsetAsync on
// the stream at every apply, so a captured CUDA graph replays the reset.
// Traffic per direction: each operand read once, the output written once,
// the levels' ring through L2.
//
// Which variant runs is the caller's explicit rule (ops/trisweep.py
// variant_of): the window kernels when each direction's rings and staging
// fit the 227 KB of shared memory a block may use and the halo
// (levels - 1) * reach is shorter than two tiles (tile = the chunks of the
// layout split over the card's SMs; every CTA sweeps its halo again); else
// the ring kernel where each of its CTAs gets a chunk and its diagonals
// stay in shared memory (poisson_3d(243), poisson_3d_27pt(128) float32,
// poisson_3d(100) float64); else the per-sweep kernels of the first port,
// one launch per step (scale_kernel, then sweep_kernel once per sweep),
// whose iterates go through device memory: they measured faster on the
// smaller large-reach shapes, and they alone take strict offsets of the
// wrong sign for their direction (the ordered walks cannot).  The split is
// not a fallback on failure: a refused launch still returns its error.
// tile > 0 asks for the window kernels, tile == 0 the ring kernel,
// tile == -1 the per-sweep kernels.  The kernels are opted in to the
// card's shared memory once per device (smm_trisweep_prepare), and the
// ring kernel's grid comes from smm_trisweep_ring_blocks_per_sm, both
// called once by the wrapper.
//
// Constant coefficients: the scalar variant (scalar_sweep, its own entry
// smm_sgs_apply_scalar_*).  Where the SGS factors are those of a grid
// stencil with one value a diagonal (HPCG's operator, the Laplacians: each
// strict diagonal one value where its neighbour lies inside the grid and an
// exact 0 across a face, the main diagonal one value), the rule gives the
// shapes the window kernels do not take to the per-sweep scheme with each
// strict diagonal read as one scalar and its face mask computed from the
// row's grid position.  A sweep then streams the rhs, x and its output
// alone: 3 vectors against the 27-point float64 sweep's 17.  The init step
// is formed inside the first sweep from its source (sweeps - 1 launches a
// direction), and SGS's middle scale d * x inside every backward step, so
// an SGS(4) apply moves 16 vectors (2.15 GB at 256^3 float64, 0.64 ms at
// 3.35 TB/s).  ops/trisweep.py finds the property in the stored values when
// the factors are built (scalar_check: one pass over the diagonals, one
// host read) and never from a description of the operator.
//
// Exactness: every product, sum and difference is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn and the __d* forms; no FMA
// contraction), the strict diagonals are summed in ascending-offset order,
// then subtracted from the rhs, then scaled by the inverse diagonal; SGS's
// middle is diag * x, then * invd_u, as two roundings.  The plain PyTorch
// versions in ops/trisweep.py do the same operations in the same order, so
// kernel and plain version agree bit for bit, in every variant.
//
// Guards: rows outside [lead, lead + n_rows) write an exact 0 (the ring
// kernel also into its ring, where a data row may read them) and read
// nothing.  The shared geometry's guards cover max|offset| on both sides,
// so every read of a data row stays in bounds.  Index math is 64-bit, and
// 32-bit inside a window kernel's window, which the C entry bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDiags = 64;  // DIA's max_diags, as in dia_spmv.cu
constexpr int kThreads = 256;  // the large-reach variant's blocks
constexpr int kChunk = 1024;   // rows per chunk of the window kernels
// threads per window CTA, kChunk / threads rows each (512 measured 4-6%
// slower in float32 and the same in float64 on an H100)
constexpr int kWindowThreads = 256;
constexpr int kRowsPerThread = kChunk / kWindowThreads;
constexpr int kStages = 3;     // chunks of operands in flight per CTA
// dynamic shared memory of a window CTA: the 227 KB one block may use, less
// the kernel's static copy of the offsets
constexpr int kSmemMax = 232448 - kMaxDiags * static_cast<int>(sizeof(int));
static_assert(kChunk % kWindowThreads == 0 && kRowsPerThread <= 8, "window threads");

struct Offsets {
  int v[kMaxDiags];
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// cp.async of kRowsPerThread consecutive elements into shared memory: 16-byte
// copies through L2 only, or one 4- or 8-byte copy through L1.  Both
// addresses are aligned to the copy (the C entry checks the vectors).
template <typename T>
__device__ __forceinline__ void copy_rows(T* smem, const T* gmem) {
  constexpr int kBytes = kRowsPerThread * static_cast<int>(sizeof(T));
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int b = 0; b < kBytes; b += 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s + b),
                   "l"(reinterpret_cast<const char*>(gmem) + b));
    }
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(kBytes));
  }
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- the window kernel: one direction of an apply ------------------------------

// Rows of one level's ring: the reach behind a chunk, in whole chunks, and
// the chunk itself.  ops/trisweep.py:ring_rows is the same formula.
__host__ __device__ inline int ring_rows(int reach) {
  return ((reach + kChunk - 1) / kChunk + 1) * kChunk;
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One direction (kForward: rows ascending, offsets < 0; else descending,
// offsets > 0) over the tile blockIdx.x.  kMid: the rhs is mid * src (SGS's
// middle scale, fused into the backward init).  ND > 0: exactly ND strict
// diagonals, their offsets and each chunk's coefficients held in
// registers; ND == 0: nd of them, read from shared memory.  Shared memory:
// levels - 1 rings of ring_rows elements, then kStages staging slots of
// nv * kChunk elements (rhs, inverse diagonal, [mid], and the strict
// diagonals when there is a sweep).  A thread copies kRowsPerThread
// consecutive rows of each operand and computes the rows
// tid + i * kWindowThreads, so that neighbouring threads read neighbouring
// words of the rings; the barrier after the copies' wait makes each
// chunk's staging visible to all.  A level runs on every chunk its cone
// reaches and computes all the chunk's rows: a row outside the cone reads
// stale ring rows and leaves a value no row of the cone reads, and only
// the tile's rows are written out.  Row indices inside the kernel are
// 32-bit, relative to the window's first chunk (the window is at most a
// tile and a halo long).
template <typename T, bool kForward, bool kMid, int ND>
__global__ void __launch_bounds__(kWindowThreads, 1)
window_kernel(const T* src, const T* __restrict__ mid, const T* __restrict__ invd,
              const T* __restrict__ diags, const Offsets offs, int nd, T* __restrict__ out,
              int levels, int reach, long long tile, long long n_total, long long lead,
              long long n_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_off[kMaxDiags];
  constexpr int kFixed = kMid ? 3 : 2;
  constexpr int R = kRowsPerThread;
  constexpr int W = kWindowThreads;
  const int tid = threadIdx.x;
  const int rows = levels > 1 ? ring_rows(reach) : kChunk;
  const int nds = levels > 1 ? (ND > 0 ? ND : nd) : 0;  // diagonals staged
  const int nv = kFixed + nds;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* stage = ring + (levels - 1) * rows;
  int off[ND > 0 ? ND : 1];
  if constexpr (ND > 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) off[d] = offs.v[d];
  } else {
    for (int d = tid; d < nds; d += W) s_off[d] = offs.v[d];
  }

  // the window [w_lo, w_hi) and its first chunk `base`, in 64-bit once
  const long long seg0 = static_cast<long long>(blockIdx.x) * tile;
  const long long seg1 = seg0 + tile < n_total ? seg0 + tile : n_total;
  const long long halo = static_cast<long long>(levels - 1) * reach;
  const long long w_lo = kForward ? (seg0 - halo > 0 ? seg0 - halo : 0) : seg0;
  const long long w_hi = kForward ? seg1 : (seg1 + halo < n_total ? seg1 + halo : n_total);
  const long long base = w_lo / kChunk * kChunk;
  const int nchunks = static_cast<int>((w_hi - base + kChunk - 1) / kChunk);
  const int span = nchunks * kChunk;
  // relative bounds: the tile, the window's data rows, the levels' cones
  const int t_lo = static_cast<int>(seg0 - base);
  const int t_hi = static_cast<int>(seg1 - base);
  const int d_lo = static_cast<int>(clamp_ll(lead > w_lo ? lead - base : w_lo - base, 0, span));
  const long long end = lead + n_rows < w_hi ? lead + n_rows : w_hi;
  const int d_hi = static_cast<int>(clamp_ll(end - base, 0, span));
  const int r_hi = static_cast<int>(clamp_ll(n_total - base, 0, span));  // last row + 1
  // level k's cone is the relative rows [lo(k), hi(k))
  auto lo = [&](int k) { return kForward ? t_lo - (levels - 1 - k) * reach : t_lo; };
  auto hi = [&](int k) {
    if (kForward) return t_hi;
    const int h = t_hi + (levels - 1 - k) * reach;
    return h < r_hi ? h : r_hi;
  };
  const T* src_b = src + base;
  const T* invd_b = invd + base;
  const T* mid_b = kMid ? mid + base : nullptr;
  const T* diags_b = diags + base;
  T* out_b = out + base;
  const int lo1 = levels > 1 ? lo(1) : 0;
  const int hi1 = levels > 1 ? hi(1) : 0;
  __syncthreads();  // s_off

  auto load = [&](int j, int slot) {
    if (j >= nchunks) return;
    const int c0 = (kForward ? j : nchunks - 1 - j) * kChunk;
    const int g = c0 + tid * R;  // this thread's rows g .. g + R - 1
    if (g + R <= d_lo || g >= d_hi) return;
    T* st = stage + slot * nv * kChunk + tid * R;
    copy_rows(st, src_b + g);
    copy_rows(st + kChunk, invd_b + g);
    if (kMid) copy_rows(st + 2 * kChunk, mid_b + g);
    // the strict diagonals only where a sweep level reaches the chunk
    if (nds > 0 && (kForward ? c0 + kChunk > lo1 : c0 < hi1)) {
      const T* dp = diags_b + g;
      for (int d = 0; d < nds; ++d, dp += n_total) copy_rows(st + (kFixed + d) * kChunk, dp);
    }
  };

  int lslot = 0;
  for (int s = 0; s < kStages - 1; ++s) {
    load(s, lslot);
    copy_commit();
    lslot = lslot + 1 == kStages ? 0 : lslot + 1;
  }
  const int ring_chunks = rows / kChunk;
  int p0 = levels > 1 ? static_cast<int>((base / kChunk + (kForward ? 0 : nchunks - 1)) %
                                         ring_chunks) * kChunk
                      : 0;
  int slot = 0;
  for (int j = 0; j < nchunks; ++j) {
    load(j + kStages - 1, lslot);
    copy_commit();
    lslot = lslot + 1 == kStages ? 0 : lslot + 1;
    copy_wait<kStages - 1>();  // this thread's copies of chunk j have landed
    __syncthreads();           // and every other thread's
    const int c0 = (kForward ? j : nchunks - 1 - j) * kChunk;
    const T* st = stage + slot * nv * kChunk + tid;
    T rhs[R], inv[R];
    bool data[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = c0 + tid + i * W;
      data[i] = r >= d_lo && r < d_hi;
      rhs[i] = T(0);
      inv[i] = T(0);
      if (data[i]) {
        rhs[i] = kMid ? mul_rn(st[2 * kChunk + i * W], st[i * W]) : st[i * W];
        inv[i] = st[kChunk + i * W];
      }
    }
    // ND > 0: the chunk's coefficients, once for every level
    T coef[ND > 0 ? ND : 1][R];
    if constexpr (ND > 0) {
      if (levels > 1 && (kForward ? c0 + kChunk > lo1 : c0 < hi1)) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
#pragma unroll
          for (int i = 0; i < R; ++i) coef[d][i] = st[(kFixed + d) * kChunk + i * W];
        }
      }
    }
    for (int k = 0; k < levels; ++k) {
      const int l = lo(k), h = hi(k);
      if (c0 + kChunk <= l || c0 >= h) continue;  // uniform over the block
      T v[R];
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) v[i] = data[i] ? mul_rn(rhs[i], inv[i]) : T(0);
      } else {
        // prev[q] is level k-1 at ring position tid + q
        const T* prev = ring + (k - 1) * rows + tid;
        T acc[R];
        auto term = [&](int d, int i, int o, T c) {
          int q = p0 + i * W + o;
          if (kForward) {
            q = q < -tid ? q + rows : q;
          } else {
            q = q + tid >= rows ? q - rows : q;
          }
          const T t = mul_rn(c, prev[q]);
          acc[i] = d == 0 ? t : add_rn(acc[i], t);
        };
        if constexpr (ND > 0) {
#pragma unroll
          for (int d = 0; d < ND; ++d) {
#pragma unroll
            for (int i = 0; i < R; ++i) term(d, i, off[d], coef[d][i]);
          }
        } else {
          for (int d = 0; d < nds; ++d) {
            const int o = s_off[d];
            const T* cf = st + (kFixed + d) * kChunk;
#pragma unroll
            for (int i = 0; i < R; ++i) term(d, i, o, cf[i * W]);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          v[i] = data[i] ? mul_rn(sub_rn(rhs[i], acc[i]), inv[i]) : T(0);
        }
      }
      if (k == levels - 1) {
        // the tile's rows: its first row starts a chunk, its end may not
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = c0 + tid + i * W;
          if (r < h) out_b[r] = v[i];
        }
      } else {
        T* cur = ring + k * rows + p0 + tid;
#pragma unroll
        for (int i = 0; i < R; ++i) cur[i * W] = v[i];
      }
      __syncthreads();
    }
    slot = slot + 1 == kStages ? 0 : slot + 1;
    if (kForward) {
      p0 = p0 + kChunk == rows ? 0 : p0 + kChunk;
    } else {
      p0 = p0 == 0 ? rows - kChunk : p0 - kChunk;
    }
  }
  copy_wait<0>();
}

// -- the ring kernel: one direction of a large-reach apply ---------------------

constexpr int kRingPollNs = 32;  // the back-off of a poll that found a level not ready

// Threads and rows per thread of the ring kernel.  With 1-4 strict
// diagonals a chunk holds 16 KB of each operand (4,096 float32 or 2,048
// float64 rows), so that its operands and its two level copies take at
// most 128 KB and two CTAs share an SM (half the rows and four CTAs, or no
// register cap and one CTA, measured 1-37% slower on an H100), on 512
// threads in float32 (7-13% faster than 256 at poisson_3d(243) and (100))
// and 256 in float64 (5% faster than 512); the general instantiation 4
// rows on 256 threads.
template <typename T, int ND>
__host__ __device__ constexpr int ring_threads() {
  return ND > 0 && sizeof(T) == 4 ? 512 : 256;
}
template <typename T, int ND>
__host__ __device__ constexpr int ring_rows_per_thread() {
  return ND > 0 ? 16384 / ring_threads<T, ND>() / static_cast<int>(sizeof(T)) : 4;
}

// Shared memory of one direction of the ring kernel (chunk rows C): with a
// sweep, the chunk's previous and current level, its rhs and inverse
// diagonal, and its strict diagonals where they fit (always with 1-4; the
// general instantiation's while two CTAs still fit an SM, else they are
// read from global memory at each level); a scale stages nothing.
template <typename T>
long long ring_smem(int nd, int levels, int rows, bool* coef_smem) {
  *coef_smem = false;
  if (levels == 1) return 0;
  const long long vec = static_cast<long long>(rows) * static_cast<long long>(sizeof(T));
  *coef_smem = nd <= 4 || (4 + nd) * vec <= kSmemMax / 2;
  return (4 + (*coef_smem ? nd : 0)) * vec;
}


__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Release of a chunk's level: the fence orders every store the block made
// before its barrier ahead of the flag's store.
__device__ __forceinline__ void publish(int* p, int v) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// cp.async of N consecutive elements (a multiple of 16 bytes) into shared
// memory through L2 only, marked evict-first there.
template <typename T, int N>
__device__ __forceinline__ void copy_run(T* smem, const T* gmem, unsigned long long policy) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  static_assert(kBytes % 16 == 0, "copy_run");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
#pragma unroll
  for (int b = 0; b < kBytes; b += 16) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(s + b),
                 "l"(reinterpret_cast<const char*>(gmem) + b), "l"(policy));
  }
}

// One direction (kForward: chunks ascending, offsets < 0; else descending,
// offsets > 0) of a large-reach apply, chunk by chunk in ticket order, on
// chunks of W * R rows (ring_threads, ring_rows_per_thread).  kMid: the
// rhs is mid * src.  ND > 0: exactly ND strict diagonals; ND == 0: nd of
// them (the diagonals in shared memory when coef_smem, else read at each
// level).  A chunk's operands are copied by 16-byte cp.async runs, R
// consecutive rows a thread; then thread tid computes the rows tid + i * W,
// so a warp's reads and writes of a ring are 32 consecutive
// words.  `ticket` counts the chunks taken, `flags[c]` the levels of chunk c
// done; ring level k is ring + k * ring_rows, chunk c at rows
// (c % (ring_rows / C)) * C.  Rows past n_total (the last chunk's tail) and
// guard rows compute an exact 0 and read no level.
template <typename T, bool kForward, bool kMid, int ND>
__global__ void __launch_bounds__(ring_threads<T, ND>(), 2)
ring_kernel(const T* __restrict__ src, const T* __restrict__ mid, const T* __restrict__ invd,
            const T* __restrict__ diags, const Offsets offs, int nd, T* __restrict__ out,
            T* ring, int ring_rows, int* ticket, int* flags, int levels, int reach,
            bool coef_smem, long long n_total, long long lead, long long n_rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_ticket;
  constexpr int W = ring_threads<T, ND>();
  constexpr int R = ring_rows_per_thread<T, ND>();
  constexpr int C = W * R;
  const int tid = threadIdx.x;
  const int nchunks = static_cast<int>((n_total + C - 1) / C);
  const int ring_chunks = ring_rows / C;
  const int h = (reach + C - 1) / C;  // chunks behind a chunk that its rows read
  const int nds = levels > 1 ? (ND > 0 ? ND : nd) : 0;
  T* lvl = reinterpret_cast<T*>(smem_raw);  // [2][C]: the chunk's levels k-1, k
  T* s_rhs = lvl + 2 * C;                   // [C]
  T* s_inv = s_rhs + C;                     // [C]
  T* s_coef = s_inv + C;                    // [nds][C] when coef_smem
  unsigned long long evict_first;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(evict_first));

  for (;;) {
    if (tid == 0) s_ticket = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_ticket;  // thread 0 writes it again only after two more barriers
    if (t >= nchunks) break;
    const int c = kForward ? t : nchunks - 1 - t;
    const long long c0 = static_cast<long long>(c) * C;
    const int p0 = (c % ring_chunks) * C;
    // the chunk's data rows, relative to c0
    const int d_lo = static_cast<int>(lead > c0 ? (lead - c0 < C ? lead - c0 : C) : 0);
    const long long end = lead + n_rows - c0;
    const int d_hi = static_cast<int>(end < 0 ? 0 : (end > C ? C : end));

    // the chunk's operands, read once: rhs, inverse diagonal, the strict
    // diagonals (a scale reads its rows in place of staging them)
    T mid_r[kMid ? R : 1];
    if (levels > 1) {
      const int g = tid * R;  // this thread's rows g .. g + R - 1
      if (g + R > d_lo && g < d_hi) {
        copy_run<T, R>(s_rhs + g, src + c0 + g, evict_first);
        copy_run<T, R>(s_inv + g, invd + c0 + g, evict_first);
        if (coef_smem) {
          const T* dp = diags + c0 + g;
          for (int d = 0; d < nds; ++d, dp += n_total) copy_run<T, R>(s_coef + d * C + g, dp, evict_first);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::);
    }
    if constexpr (kMid) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tid + i * W;
        mid_r[i] = r >= d_lo && r < d_hi ? __ldcs(mid + c0 + r) : T(0);
      }
    }
    // before the chunk overwrites its slots: every level of the readers of
    // the slots' previous chunk done
    if (levels > 1) {
      for (int u = tid; u <= h; u += W) {
        const int q = kForward ? c - ring_chunks + u : c + ring_chunks - u;
        if (q < 0 || q >= nchunks) continue;
        while (load_acquire(flags + q) < levels) __nanosleep(kRingPollNs);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();

    if (levels == 1) {
      // a scale: each data row's rhs times its inverse diagonal
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tid + i * W;
        if (c0 + r >= n_total) continue;
        T v = T(0);
        if (r >= d_lo && r < d_hi) {
          const T sv = __ldcs(src + c0 + r);
          v = mul_rn(kMid ? mul_rn(mid_r[i], sv) : sv, __ldcs(invd + c0 + r));
        }
        __stcs(out + c0 + r, v);
      }
      continue;
    }
    if constexpr (kMid) {
      // rhs = mid * src, in place: from here on each row is its owner's
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = tid + i * W;
        if (r >= d_lo && r < d_hi) s_rhs[r] = mul_rn(mid_r[i], s_rhs[r]);
      }
    }

    for (int k = 0; k < levels; ++k) {
      if (k > 0) {
        // wait for level k-1 of the chunks this level reads: for each
        // offset, the chunks of its first and last row
        for (int j = tid; j < 2 * nds; j += W) {
          const long long g = c0 + offs.v[j >> 1] + ((j & 1) ? C - 1 : 0);
          if (g < 0) continue;
          const long long q = g / C;
          if (q == c || q >= nchunks) continue;
          while (load_acquire(flags + q) < k) __nanosleep(kRingPollNs);
        }
        __syncthreads();
      }

      T v[R];
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = tid + i * W;
          v[i] = r >= d_lo && r < d_hi ? mul_rn(s_rhs[r], s_inv[r]) : T(0);
        }
      } else {
        const T* prev_s = lvl + ((k - 1) & 1) * C;
        const T* prev_g = ring + static_cast<long long>(k - 1) * ring_rows;
        // level k-1 at row + o of this thread's rows: an offset of a chunk
        // or more reads the ring alone, its loads issued before any is
        // used; a shorter one the chunk's own copy, and the ring for the
        // rows behind the chunk
        auto gather = [&](int o, T (&x)[R]) {
          if (kForward ? o <= -C : o >= C) {
            int qb = p0 + o + tid;  // the ring row of row tid + o
            if (kForward) {
              qb = qb < 0 ? qb + ring_rows : qb;
            } else {
              qb = qb >= ring_rows ? qb - ring_rows : qb;
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const int q = qb + i * W;
              x[i] = __ldcg(prev_g + (q >= ring_rows ? q - ring_rows : q));
            }
          } else {
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const int rel = tid + i * W + o;
              x[i] = prev_s[kForward ? (rel > 0 ? rel : 0) : (rel < C ? rel : C - 1)];
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              if (kForward ? i * W + o >= 0 : i * W + W - 1 + o < C) continue;  // block-uniform
              const int rel = tid + i * W + o;
              if (kForward ? rel < 0 : rel >= C) {
                int q = p0 + rel;
                if (kForward) {
                  q = q < 0 ? q + ring_rows : q;
                } else {
                  q = q >= ring_rows ? q - ring_rows : q;
                }
                x[i] = __ldcg(prev_g + q);
              }
            }
          }
        };
        T acc[R];
        // the terms of diagonal d, summed in ascending-offset order
        auto add_terms = [&](int d, const T (&x)[R]) {
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const int r = tid + i * W;
            const T cf = coef_smem             ? s_coef[d * C + r]
                         : r >= d_lo && r < d_hi ? __ldg(diags + d * n_total + c0 + r)
                                                 : T(0);
            const T p = mul_rn(cf, x[i]);
            acc[i] = d == 0 ? p : add_rn(acc[i], p);
          }
        };
        if constexpr (ND > 0) {
          T x[ND][R];
#pragma unroll
          for (int d = 0; d < ND; ++d) gather(offs.v[d], x[d]);
#pragma unroll
          for (int d = 0; d < ND; ++d) add_terms(d, x[d]);
        } else {
          for (int d = 0; d < nds; ++d) {
            T x[R];
            gather(offs.v[d], x);
            add_terms(d, x);
          }
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = tid + i * W;
          v[i] = r >= d_lo && r < d_hi ? mul_rn(sub_rn(s_rhs[r], acc[i]), s_inv[r]) : T(0);
        }
      }
      if (k < levels - 1) {
        T* cur_g = ring + static_cast<long long>(k) * ring_rows + p0 + tid;
        T* cur_s = lvl + (k & 1) * C + tid;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          __stcg(cur_g + i * W, v[i]);
          cur_s[i * W] = v[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const long long e = c0 + tid + i * W;
          if (e < n_total) __stcs(out + e, v[i]);
        }
      }
      __syncthreads();
      // the last thread publishes, while the first ones poll for the next level
      if (tid == W - 1) publish(flags + c, k + 1);
    }
  }
}

// -- the large-reach variant: one launch per step ------------------------------

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

// One direction of the large-reach variant: the init step writes `first`,
// then each of the sweeps-1 sweeps (none when the strict part is empty)
// writes the other buffer of the pair.  *result is the buffer holding the
// last write.
template <typename T>
int direction(const T* src, const T* mid, const T* invd, T* rhs2_out, const T* diags,
              const Offsets& offs, int ndiags, int sweeps, T* first, T* second,
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

// -- the scalar variant: a constant-coefficient stencil's diagonals as scalars --

// A row's position on the grid: rows of nx points, planes of ny rows (0: a
// 2-D grid), the global row of the layout's first data row, and the
// system's rows.  Global row g lies at padded row lead + g - row0.  The
// caller bounds n_global below 2^31.
struct Grid {
  unsigned nx, ny;
  long long row0, n_global;
};

// The faces of the grid a row lies on, and that a diagonal's neighbour
// crosses when its row lies on them: x and y by the row's position in its
// line and plane, the outermost axis (z, or y on a 2-D grid) by the
// system's first and last plane (line).  A diagonal's neighbour lies inside
// the grid, and its stored value is the diagonal's one value, where the
// row lies on none of the diagonal's faces; elsewhere the stored value is
// an exact 0 (ops/trisweep.py:_row_faces and _faces are the same bits).
constexpr int kXLo = 1, kXHi = 2, kYLo = 4, kYHi = 8, kZLo = 16, kZHi = 32;

__device__ __forceinline__ int faces_at(const Grid& grid, unsigned ix, unsigned iy,
                                        long long g) {
  int at = (ix == 0 ? kXLo : 0) | (ix + 1 == grid.nx ? kXHi : 0);
  long long outer = grid.nx;
  int lo = kYLo, hi = kYHi;
  if (grid.ny != 0) {
    at |= (iy == 0 ? kYLo : 0) | (iy + 1 == grid.ny ? kYHi : 0);
    outer *= grid.ny;
    lo = kZLo;
    hi = kZHi;
  }
  return at | (g < outer ? lo : 0) | (g >= grid.n_global - outer ? hi : 0);
}

__device__ __forceinline__ int faces_of(const Grid& grid, long long g) {
  const unsigned gu = static_cast<unsigned>(g);
  return faces_at(grid, gu % grid.nx, grid.ny != 0 ? (gu / grid.nx) % grid.ny : 0, g);
}

struct DiagFaces {
  int off[kMaxDiags];
  int faces[kMaxDiags];
};

// One direction's strict part: each diagonal's offset, faces and one value.
template <typename T>
struct ScalarDiags {
  DiagFaces f;
  T c[kMaxDiags];
};

// Consecutive rows a thread of the scalar variant computes: the grid
// position, found by two divisions, serves them all.  SGS(4) on an H100 at
// 1 / 2 / 4 rows: 1.450 / 1.392 / 1.722 ms at poisson_3d_27pt(256) float64,
// 0.632 / 0.501 / 0.598 ms at poisson_3d(243) float32 (CUDA graphs).  The
// kernel is bound by its instructions as much as by its bytes: with a range
// test of each neighbour's global row in place of the outermost axis' face
// bits, 1 row took 1.79 / 0.65 ms.
constexpr int kScalarRows = 2;

// One launch of a direction: y[e] = (rhs[e] - sum_k c_k x[e + off_k]) * invd,
// c_k read as an exact 0 where the row lies on one of the diagonal's faces,
// as the stored diagonal holds it; rhs = d * src (kMid, SGS's middle scale)
// or src.  kFirst: x is the direction's init step x_0 = rhs * invd, formed at
// each neighbour from src (an exact 0 off the data rows, as scale_kernel
// writes it) instead of read, so the init step needs no launch of its own.
// nd == 0: the init step alone.  The same roundings in the same order as
// scale_kernel then sweep_kernel on the stored diagonals.
template <typename T, bool kFirst, bool kMid>
__global__ void __launch_bounds__(kThreads)
scalar_sweep(const T* __restrict__ src, const T* __restrict__ x, T* __restrict__ y,
             const ScalarDiags<T> s, int nd, const Grid grid, T d, T invd, long long n_total,
             long long lead, long long n_rows) {
  const long long e0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kScalarRows;
  long long g = grid.row0 + (e0 - lead);
  unsigned ix = 0, iy = 0;
  bool placed = false;
#pragma unroll
  for (int j = 0; j < kScalarRows; ++j, ++g) {
    const long long e = e0 + j;
    if (e >= n_total) return;
    if (e < lead || e >= lead + n_rows) {
      y[e] = T(0);
      continue;
    }
    if (!placed) {
      const unsigned gu = static_cast<unsigned>(g);
      ix = gu % grid.nx;
      iy = grid.ny != 0 ? (gu / grid.nx) % grid.ny : 0;
      placed = true;
    }
    const int at = faces_at(grid, ix, iy, g);
    const T rhs = kMid ? mul_rn(d, src[e]) : src[e];
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kMaxDiags; ++k) {
      if (k >= nd) break;
      const long long h = e + s.f.off[k];
      T v;
      if constexpr (kFirst) {
        v = T(0);
        if (h >= lead && h < lead + n_rows) {
          v = __ldg(src + h);
          v = mul_rn(kMid ? mul_rn(d, v) : v, invd);
        }
      } else {
        v = __ldg(x + h);
      }
      const T t = mul_rn((at & s.f.faces[k]) == 0 ? s.c[k] : T(0), v);
      acc = k == 0 ? t : add_rn(acc, t);
    }
    y[e] = nd > 0 ? mul_rn(sub_rn(rhs, acc), invd) : mul_rn(rhs, invd);
    if (++ix == grid.nx) {
      ix = 0;
      if (grid.ny != 0 && ++iy == grid.ny) iy = 0;
    }
  }
}

// One direction of the scalar variant: a launch for the init step fused into
// the first sweep, then one per further sweep, alternating first / second;
// the init step alone where there is no sweep.  *result is the buffer
// holding the last write.
template <typename T, bool kMid>
int scalar_direction(const T* src, const ScalarDiags<T>& s, int nd, const Grid& grid, T d,
                     T invd, int sweeps, T* first, T* second, long long n_total,
                     long long lead, long long n_rows, cudaStream_t stream, T** result) {
  const unsigned int blocks = blocks_for((n_total + kScalarRows - 1) / kScalarRows);
  const int launches = nd == 0 || sweeps == 1 ? 1 : sweeps - 1;
  T* cur = nullptr;
  T* nxt = first;
  for (int k = 1; k <= launches; ++k) {
    if (k == 1) {
      scalar_sweep<T, true, kMid><<<blocks, kThreads, 0, stream>>>(
          src, nullptr, nxt, s, sweeps == 1 ? 0 : nd, grid, d, invd, n_total, lead, n_rows);
    } else {
      scalar_sweep<T, false, kMid><<<blocks, kThreads, 0, stream>>>(
          src, cur, nxt, s, nd, grid, d, invd, n_total, lead, n_rows);
    }
    const int code = static_cast<int>(cudaGetLastError());
    if (code != 0) return code;
    cur = nxt;
    nxt = cur == first ? second : first;
  }
  *result = cur;
  return 0;
}

// The detection's check, one pass over the stored words: each diagonal k of
// rows [first, first + rows) (row stride `stride`) holds its word at row
// `ref` where the neighbour lies inside the grid and an exact 0 (all bits
// clear) elsewhere, and the inverse diagonal holds its word at `ref` on
// every row.  A warp with a row that does not sets *bad.
template <typename W>
__global__ void __launch_bounds__(kThreads)
scalar_check(const W* __restrict__ diags, long long stride, const DiagFaces f, int nd,
             const W* __restrict__ invd, const Grid grid, long long first, long long rows,
             long long ref, int* bad) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  bool ok = true;
  if (i < rows) {
    const long long e = first + i;
    const long long g = grid.row0 + i;
    const int at = faces_of(grid, g);
    for (int k = 0; k < nd; ++k) {
      const W want = (at & f.faces[k]) == 0 ? __ldg(diags + k * stride + ref) : W(0);
      ok &= __ldg(diags + k * stride + e) == want;
    }
    ok &= __ldg(invd + e) == __ldg(invd + ref);
  }
  if (!__all_sync(0xffffffffu, ok) && (threadIdx.x & 31) == 0) atomicOr(bad, 1);
}

bool load_grid(long long nx, long long ny, long long row0, long long n_global, Grid* grid) {
  if (nx < 1 || ny < 0 || nx > 0x7fffffff || ny > 0x7fffffff || row0 < 0 || n_global < 1 ||
      n_global > 0x7fffffff) {
    return false;
  }
  *grid = Grid{static_cast<unsigned>(nx), static_cast<unsigned>(ny), row0, n_global};
  return true;
}

bool load_faces(const void* offsets, const void* faces, int nd, DiagFaces* f) {
  if (nd < 0 || nd > kMaxDiags) return false;
  *f = DiagFaces{};
  for (int k = 0; k < nd; ++k) {
    f->off[k] = static_cast<const int*>(offsets)[k];
    f->faces[k] = static_cast<const int*>(faces)[k];
  }
  return true;
}

template <typename T>
bool load_scalar(const void* offsets, const void* faces, const void* coefs, int nd,
                 ScalarDiags<T>* s) {
  *s = ScalarDiags<T>{};
  if (!load_faces(offsets, faces, nd, &s->f)) return false;
  for (int k = 0; k < nd; ++k) s->c[k] = static_cast<const T*>(coefs)[k];
  return true;
}

// The whole SGS apply in the scalar variant: forward from r into w0 / w1,
// backward (rhs = d * the forward result) ending in out.  The data rows of
// the layout are global rows [row0, row0 + n_rows) of the grid.
template <typename T>
int launch_scalar(const void* r_, void* w0_, void* w1_, void* out_, int sweeps,
                  long long n_total, long long lead, long long n_rows, const void* l_offsets,
                  const void* l_faces, const void* l_coefs, int nd_l, const void* u_offsets,
                  const void* u_faces, const void* u_coefs, int nd_u, T d, T invd, long long nx,
                  long long ny, long long row0, long long n_global, void* stream_) {
  ScalarDiags<T> lower, upper;
  Grid grid;
  if (sweeps < 1 || n_rows < 1 || lead < 0 || lead + n_rows > n_total ||
      !load_scalar(l_offsets, l_faces, l_coefs, nd_l, &lower) ||
      !load_scalar(u_offsets, u_faces, u_coefs, nd_u, &upper) ||
      !load_grid(nx, ny, row0, n_global, &grid) || row0 + n_rows > n_global) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* w0 = static_cast<T*>(w0_);
  T* w1 = static_cast<T*>(w1_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  T* xw = nullptr;
  int code = scalar_direction<T, false>(static_cast<const T*>(r_), lower, nd_l, grid, d, invd,
                                        sweeps, w0, w1, n_total, lead, n_rows, stream, &xw);
  if (code != 0) return code;
  T* other = xw == w0 ? w1 : w0;
  const int writes = nd_u > 0 && sweeps > 1 ? sweeps - 1 : 1;
  T* z = nullptr;
  code = scalar_direction<T, true>(xw, upper, nd_u, grid, d, invd, sweeps,
                                   writes % 2 == 1 ? out : other, writes % 2 == 1 ? other : out,
                                   n_total, lead, n_rows, stream, &z);
  if (code != 0) return code;
  return z == out ? 0 : static_cast<int>(cudaErrorUnknown);
}

// -- launching -----------------------------------------------------------------

// max |offset|, and whether every offset has the direction's sign.
bool reach_of(const Offsets& offs, int nd, bool forward, int* reach) {
  int r = 0;
  for (int d = 0; d < nd; ++d) {
    const int o = offs.v[d];
    if (forward ? o >= 0 : o <= 0) return false;
    r = o < 0 ? (-o > r ? -o : r) : (o > r ? o : r);
  }
  *reach = r;
  return true;
}

// One direction through the window kernel, on tiles of `tile` rows, at
// one instantiation of the strict diagonals' count.
template <typename T, bool kForward, bool kMid, int ND>
int window_launch(const T* src, const T* mid, const T* invd, const T* diags,
                  const Offsets& offs, int nd, T* out, int levels, int reach, long long smem,
                  long long tile, long long n_total, long long lead, long long n_rows,
                  cudaStream_t stream) {
  const unsigned int grid = static_cast<unsigned int>((n_total + tile - 1) / tile);
  window_kernel<T, kForward, kMid, ND><<<grid, kWindowThreads, smem, stream>>>(
      src, mid, invd, diags, offs, nd, out, levels, reach, tile, n_total, lead, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// One direction through the window kernel: checks, then the instantiation
// for 1-4 strict diagonals under a sweep, or the general one.
template <typename T, bool kForward, bool kMid>
int window_direction(const T* src, const T* mid, const T* invd, const T* diags,
                     const Offsets& offs, int nd, T* out, int sweeps, long long tile,
                     long long n_total, long long lead, long long n_rows,
                     cudaStream_t stream) {
  const int levels = nd > 0 ? sweeps : 1;
  int reach = 0;
  if (!reach_of(offs, nd, kForward, &reach)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = levels > 1 ? ring_rows(reach) : 0;
  const long long nv = (kMid ? 3 : 2) + (levels > 1 ? nd : 0);
  const long long smem =
      static_cast<long long>(sizeof(T)) * ((levels - 1) * rows + kStages * nv * kChunk);
  // the window (a tile and its halo) indexed in 32 bits
  if (smem > kSmemMax || tile + (levels - 1) * static_cast<long long>(reach) + kChunk >
                             (1LL << 31) - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 16-byte copies need every vector they read aligned to 16 bytes
  // (rows of the diagonals lie n_total elements apart, a multiple of 128)
  const unsigned long long addr_bits = reinterpret_cast<unsigned long long>(src) |
                                       reinterpret_cast<unsigned long long>(mid) |
                                       reinterpret_cast<unsigned long long>(invd) |
                                       reinterpret_cast<unsigned long long>(diags);
  if (addr_bits % 16 != 0 || n_total % 128 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
#define SMM_WINDOW(ND)                                                                   \
  window_launch<T, kForward, kMid, ND>(src, mid, invd, diags, offs, nd, out, levels, reach, \
                                       smem, tile, n_total, lead, n_rows, stream)
  switch (levels > 1 ? nd : 0) {
    case 1:
      return SMM_WINDOW(1);
    case 2:
      return SMM_WINDOW(2);
    case 3:
      return SMM_WINDOW(3);
    case 4:
      return SMM_WINDOW(4);
    default:
      return SMM_WINDOW(0);
  }
#undef SMM_WINDOW
}

// Flags of one direction in the ring kernel's sync buffer: [forward
// ticket, backward ticket, forward flags, backward flags], each direction's
// flags one per chunk of the smallest chunk, kChunk rows.
inline long long ring_flag_stride(long long n_total) { return (n_total + kChunk - 1) / kChunk; }

// One direction through the ring kernel at one instantiation.
template <typename T, bool kForward, bool kMid, int ND>
int ring_launch(const T* src, const T* mid, const T* invd, const T* diags, const Offsets& offs,
                int nd, T* out, T* ring, int ring_rows, int* sync, int levels, int reach,
                int grid, long long n_total, long long lead, long long n_rows,
                cudaStream_t stream) {
  constexpr int C = ring_threads<T, ND>() * ring_rows_per_thread<T, ND>();
  if (levels > 1 && (ring == nullptr || ring_rows % C != 0 ||
                     ring_rows / C < (reach + C - 1) / C + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the 16-byte copies need every vector they read aligned to 16 bytes
  // (rows of the diagonals lie n_total elements apart, a multiple of 128)
  const unsigned long long addr_bits = reinterpret_cast<unsigned long long>(src) |
                                       reinterpret_cast<unsigned long long>(invd) |
                                       reinterpret_cast<unsigned long long>(diags);
  if (levels > 1 && (addr_bits % 16 != 0 || n_total % 128 != 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  bool coef_smem = false;
  const long long smem = ring_smem<T>(nd, levels, C, &coef_smem);
  const long long nchunks = (n_total + C - 1) / C;
  int* ticket = sync + (kForward ? 0 : 1);
  int* flags = sync + 2 + (kForward ? 0 : ring_flag_stride(n_total));
  const int blocks = static_cast<int>(grid < nchunks ? grid : nchunks);
  ring_kernel<T, kForward, kMid, ND><<<blocks, ring_threads<T, ND>(), smem, stream>>>(
      src, mid, invd, diags, offs, nd, out, ring, ring_rows, ticket, flags, levels, reach,
      coef_smem, n_total, lead, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// One direction through the ring kernel: checks, then the instantiation
// for 1-4 strict diagonals under a sweep, or the general one.  A ring
// shorter than the reach and a chunk (a chunk would wait on itself) is
// refused, never wrapped.
template <typename T, bool kForward, bool kMid>
int ring_direction(const T* src, const T* mid, const T* invd, const T* diags,
                   const Offsets& offs, int nd, T* out, int sweeps, T* ring, int ring_rows,
                   int* sync, int grid, long long n_total, long long lead, long long n_rows,
                   cudaStream_t stream) {
  const int levels = nd > 0 ? sweeps : 1;
  int reach = 0;
  if (!reach_of(offs, nd, kForward, &reach)) return static_cast<int>(cudaErrorInvalidValue);
#define SMM_RING(ND)                                                                       \
  ring_launch<T, kForward, kMid, ND>(src, mid, invd, diags, offs, nd, out, ring, ring_rows, \
                                     sync, levels, reach, grid, n_total, lead, n_rows, stream)
  switch (levels > 1 ? nd : 0) {
    case 1:
      return SMM_RING(1);
    case 2:
      return SMM_RING(2);
    case 3:
      return SMM_RING(3);
    case 4:
      return SMM_RING(4);
    default:
      return SMM_RING(0);
  }
#undef SMM_RING
}

// Blocks per SM and chunk rows of one direction's ring kernel instantiation.
template <typename T, bool kForward, bool kMid, int ND>
int ring_blocks_at(int nd, int levels, int* blocks, int* chunk) {
  constexpr int C = ring_threads<T, ND>() * ring_rows_per_thread<T, ND>();
  bool coef_smem = false;
  const long long smem = ring_smem<T>(nd, levels, C, &coef_smem);
  *chunk = C;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ring_kernel<T, kForward, kMid, ND>, ring_threads<T, ND>(),
      static_cast<size_t>(smem)));
}

template <typename T, bool kForward, bool kMid>
int ring_blocks(int nd, int sweeps, int* blocks, int* chunk) {
  const int levels = nd > 0 ? sweeps : 1;
  switch (levels > 1 ? nd : 0) {
    case 1:
      return ring_blocks_at<T, kForward, kMid, 1>(nd, levels, blocks, chunk);
    case 2:
      return ring_blocks_at<T, kForward, kMid, 2>(nd, levels, blocks, chunk);
    case 3:
      return ring_blocks_at<T, kForward, kMid, 3>(nd, levels, blocks, chunk);
    case 4:
      return ring_blocks_at<T, kForward, kMid, 4>(nd, levels, blocks, chunk);
    default:
      return ring_blocks_at<T, kForward, kMid, 0>(nd, levels, blocks, chunk);
  }
}

// The opt-in of every window and ring instantiation of one direction to
// the block's 227 KB of shared memory.
template <typename T, bool kForward, bool kMid>
int opt_in_direction() {
  const void* fns[] = {
      reinterpret_cast<const void*>(window_kernel<T, kForward, kMid, 0>),
      reinterpret_cast<const void*>(window_kernel<T, kForward, kMid, 1>),
      reinterpret_cast<const void*>(window_kernel<T, kForward, kMid, 2>),
      reinterpret_cast<const void*>(window_kernel<T, kForward, kMid, 3>),
      reinterpret_cast<const void*>(window_kernel<T, kForward, kMid, 4>),
      reinterpret_cast<const void*>(ring_kernel<T, kForward, kMid, 0>),
      reinterpret_cast<const void*>(ring_kernel<T, kForward, kMid, 1>),
      reinterpret_cast<const void*>(ring_kernel<T, kForward, kMid, 2>),
      reinterpret_cast<const void*>(ring_kernel<T, kForward, kMid, 3>),
      reinterpret_cast<const void*>(ring_kernel<T, kForward, kMid, 4>)};
  for (const void* fn : fns) {
    const int code = static_cast<int>(
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax));
    if (code != 0) return code;
  }
  return 0;
}

template <typename T>
int opt_in_all() {
  int code = opt_in_direction<T, true, false>();
  if (code == 0) code = opt_in_direction<T, false, false>();
  if (code == 0) code = opt_in_direction<T, false, true>();
  return code;
}

// The whole apply.  w0 and w1 are scratch vectors of n_total elements (the
// window and ring variants use w0 alone) and out receives z; none of them
// may alias r or each other.  mid is the SGS diagonal, or null for a
// factor pair.  tile > 0: the window kernels on tiles of `tile` rows (a
// multiple of kChunk); tile == 0: the ring kernel, over `ring` (the
// levels but the last of both directions, ring_rows elements each, a whole
// number of either direction's chunks), `sync` (2 + 2 * ceil(n_total /
// kChunk) ints, zeroed here on the stream) and at most `grid` CTAs a
// direction; tile == -1: the per-sweep kernels.
template <typename T>
int launch_apply(const void* r_, const void* invd_l_, const void* invd_u_, const void* mid_,
                 const void* ld_, const void* l_offsets, int nd_l, const void* ud_,
                 const void* u_offsets, int nd_u, void* w0_, void* w1_, void* out_,
                 int sweeps, long long n_total, long long lead, long long n_rows,
                 long long tile, void* ring_, int ring_rows, void* sync_, int grid,
                 void* stream_) {
  if (sweeps < 1 || nd_l < 0 || nd_l > kMaxDiags || nd_u < 0 || nd_u > kMaxDiags ||
      tile < -1 || (tile > 0 && tile % kChunk != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* r = static_cast<const T*>(r_);
  const T* invd_l = static_cast<const T*>(invd_l_);
  const T* invd_u = static_cast<const T*>(invd_u_);
  const T* mid = static_cast<const T*>(mid_);
  const T* ld = static_cast<const T*>(ld_);
  const T* ud = static_cast<const T*>(ud_);
  T* w0 = static_cast<T*>(w0_);
  T* w1 = static_cast<T*>(w1_);
  T* out = static_cast<T*>(out_);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const Offsets l_offs = load_offsets(l_offsets, nd_l);
  const Offsets u_offs = load_offsets(u_offsets, nd_u);

  if (tile > 0) {
    // forward into w0, then backward (SGS: rhs2 = diag * w0) into out
    int code = window_direction<T, true, false>(r, nullptr, invd_l, ld, l_offs, nd_l, w0,
                                                sweeps, tile, n_total, lead, n_rows, stream);
    if (code != 0) return code;
    if (mid != nullptr) {
      return window_direction<T, false, true>(w0, mid, invd_u, ud, u_offs, nd_u, out, sweeps,
                                              tile, n_total, lead, n_rows, stream);
    }
    return window_direction<T, false, false>(w0, nullptr, invd_u, ud, u_offs, nd_u, out,
                                             sweeps, tile, n_total, lead, n_rows, stream);
  }

  if (tile == 0) {
    if (sync_ == nullptr || grid < 1 || ring_rows < 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int* sync = static_cast<int*>(sync_);
    T* ring = static_cast<T*>(ring_);
    int code = static_cast<int>(cudaMemsetAsync(
        sync, 0, (2 + 2 * ring_flag_stride(n_total)) * sizeof(int), stream));
    if (code != 0) return code;
    code = ring_direction<T, true, false>(r, nullptr, invd_l, ld, l_offs, nd_l, w0, sweeps,
                                          ring, ring_rows, sync, grid, n_total, lead, n_rows,
                                          stream);
    if (code != 0) return code;
    if (mid != nullptr) {
      return ring_direction<T, false, true>(w0, mid, invd_u, ud, u_offs, nd_u, out, sweeps,
                                            ring, ring_rows, sync, grid, n_total, lead, n_rows,
                                            stream);
    }
    return ring_direction<T, false, false>(w0, nullptr, invd_u, ud, u_offs, nd_u, out, sweeps,
                                           ring, ring_rows, sync, grid, n_total, lead, n_rows,
                                           stream);
  }

  // the per-sweep kernels, forward in w0 / w1
  T* xw = nullptr;  // w0 or w1: the forward result
  int code = direction<T>(r, nullptr, invd_l, nullptr, ld, l_offs, nd_l, sweeps, w0, w1,
                          n_total, lead, n_rows, stream, &xw);
  if (code != 0) return code;
  T* other = xw == w0 ? w1 : w0;

  // backward: rhs2 is xw (scaled by mid in place for SGS); the iterates
  // alternate between `other` and `out`, starting so that the last write
  // is `out`.
  const int writes = nd_u > 0 ? sweeps : 1;
  T* first = (writes % 2 == 1) ? out : other;
  T* second = (writes % 2 == 1) ? other : out;
  T* z = nullptr;
  code = direction<T>(xw, mid, invd_u, mid != nullptr ? xw : nullptr, ud, u_offs, nd_u, sweeps,
                      first, second, n_total, lead, n_rows, stream, &z);
  if (code != 0) return code;
  return z == out ? 0 : static_cast<int>(cudaErrorUnknown);
}

}  // namespace

// Plain C interface, bound with ctypes (ops/_build.py).  Every function
// returns the first non-zero CUDA error of its calls, or 0.
extern "C" {

// r, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1, out,
// sweeps, n_total, lead, n_rows, tile, ring, ring_rows, sync, grid, stream
int smm_sgs_apply_f32(const void* r, const void* invd, const void* diag, const void* ld,
                      const void* l_offsets, int nd_l, const void* ud, const void* u_offsets,
                      int nd_u, void* w0, void* w1, void* out, int sweeps, long long n_total,
                      long long lead, long long n_rows, long long tile, void* ring,
                      int ring_rows, void* sync, int grid, void* stream) {
  return launch_apply<float>(r, invd, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0,
                             w1, out, sweeps, n_total, lead, n_rows, tile, ring, ring_rows,
                             sync, grid, stream);
}

int smm_sgs_apply_f64(const void* r, const void* invd, const void* diag, const void* ld,
                      const void* l_offsets, int nd_l, const void* ud, const void* u_offsets,
                      int nd_u, void* w0, void* w1, void* out, int sweeps, long long n_total,
                      long long lead, long long n_rows, long long tile, void* ring,
                      int ring_rows, void* sync, int grid, void* stream) {
  return launch_apply<double>(r, invd, invd, diag, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0,
                              w1, out, sweeps, n_total, lead, n_rows, tile, ring, ring_rows,
                              sync, grid, stream);
}

// r, invd_l, invd_u, ld, l_offsets, nd_l, ud, u_offsets, nd_u, w0, w1, out,
// sweeps, n_total, lead, n_rows, tile, ring, ring_rows, sync, grid, stream
int smm_tri_pair_apply_f32(const void* r, const void* invd_l, const void* invd_u,
                           const void* ld, const void* l_offsets, int nd_l, const void* ud,
                           const void* u_offsets, int nd_u, void* w0, void* w1, void* out,
                           int sweeps, long long n_total, long long lead, long long n_rows,
                           long long tile, void* ring, int ring_rows, void* sync, int grid,
                           void* stream) {
  return launch_apply<float>(r, invd_l, invd_u, nullptr, ld, l_offsets, nd_l, ud, u_offsets,
                             nd_u, w0, w1, out, sweeps, n_total, lead, n_rows, tile, ring,
                             ring_rows, sync, grid, stream);
}

int smm_tri_pair_apply_f64(const void* r, const void* invd_l, const void* invd_u,
                           const void* ld, const void* l_offsets, int nd_l, const void* ud,
                           const void* u_offsets, int nd_u, void* w0, void* w1, void* out,
                           int sweeps, long long n_total, long long lead, long long n_rows,
                           long long tile, void* ring, int ring_rows, void* sync, int grid,
                           void* stream) {
  return launch_apply<double>(r, invd_l, invd_u, nullptr, ld, l_offsets, nd_l, ud, u_offsets,
                              nd_u, w0, w1, out, sweeps, n_total, lead, n_rows, tile, ring,
                              ring_rows, sync, grid, stream);
}

// r, w0, w1, out, sweeps, n_total, lead, n_rows, l_offsets, l_faces, l_coefs,
// nd_l, u_offsets, u_faces, u_coefs, nd_u, d, invd, nx, ny, row0, n_global,
// stream: the SGS apply of a constant-coefficient stencil (the scalar
// variant); offsets and faces are int32, coefs and d, invd the dtype's.
int smm_sgs_apply_scalar_f32(const void* r, void* w0, void* w1, void* out, int sweeps,
                             long long n_total, long long lead, long long n_rows,
                             const void* l_offsets, const void* l_faces, const void* l_coefs,
                             int nd_l, const void* u_offsets, const void* u_faces,
                             const void* u_coefs, int nd_u, float d, float invd, long long nx,
                             long long ny, long long row0, long long n_global, void* stream) {
  return launch_scalar<float>(r, w0, w1, out, sweeps, n_total, lead, n_rows, l_offsets, l_faces,
                              l_coefs, nd_l, u_offsets, u_faces, u_coefs, nd_u, d, invd, nx, ny,
                              row0, n_global, stream);
}

int smm_sgs_apply_scalar_f64(const void* r, void* w0, void* w1, void* out, int sweeps,
                             long long n_total, long long lead, long long n_rows,
                             const void* l_offsets, const void* l_faces, const void* l_coefs,
                             int nd_l, const void* u_offsets, const void* u_faces,
                             const void* u_coefs, int nd_u, double d, double invd, long long nx,
                             long long ny, long long row0, long long n_global, void* stream) {
  return launch_scalar<double>(r, w0, w1, out, sweeps, n_total, lead, n_rows, l_offsets,
                               l_faces, l_coefs, nd_l, u_offsets, u_faces, u_coefs, nd_u, d,
                               invd, nx, ny, row0, n_global, stream);
}

// The detection's check (scalar_check) of nd stored diagonals, rows [first,
// first + rows) at row stride `stride` elements, float64 (f64) or float32
// words; *bad (an int on the card, zeroed by the caller) is set where a row
// does not match.
int smm_scalar_stencil_check(int f64, const void* diags, long long stride, const void* offsets,
                             const void* faces, int nd, const void* invd, long long nx,
                             long long ny, long long row0, long long n_global, long long first,
                             long long rows, long long ref, void* bad, void* stream) {
  DiagFaces f;
  Grid grid;
  if (!load_faces(offsets, faces, nd, &f) || !load_grid(nx, ny, row0, n_global, &grid) ||
      rows < 1 || first < 0 || ref < first || ref >= first + rows || stride < first + rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(rows);
  int* flag = static_cast<int*>(bad);
  if (f64) {
    scalar_check<unsigned long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned long long*>(diags), stride, f, nd,
        static_cast<const unsigned long long*>(invd), grid, first, rows, ref, flag);
  } else {
    scalar_check<unsigned int><<<blocks, kThreads, 0, s>>>(
        static_cast<const unsigned int*>(diags), stride, f, nd,
        static_cast<const unsigned int*>(invd), grid, first, rows, ref, flag);
  }
  return static_cast<int>(cudaGetLastError());
}

// The opt-in of every window and ring kernel to the block's 227 KB of
// shared memory on the current device: once per device, before the first
// apply there (and before any capture).
int smm_trisweep_prepare(void) {
  const int code = opt_in_all<float>();
  return code != 0 ? code : opt_in_all<double>();
}

// CTAs of the ring kernel one SM holds in both directions of an apply
// (f64: float64, else float32; sgs: the backward direction scales by D),
// and each direction's chunk rows, after smm_trisweep_prepare.
int smm_trisweep_ring_blocks_per_sm(int f64, int sgs, int nd_l, int nd_u, int sweeps,
                                    int* blocks, int* chunk_l, int* chunk_u) {
  if (sweeps < 1 || nd_l < 0 || nd_l > kMaxDiags || nd_u < 0 || nd_u > kMaxDiags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int fwd = 0, bwd = 0;
  int code = f64 ? ring_blocks<double, true, false>(nd_l, sweeps, &fwd, chunk_l)
                 : ring_blocks<float, true, false>(nd_l, sweeps, &fwd, chunk_l);
  if (code != 0) return code;
  if (sgs) {
    code = f64 ? ring_blocks<double, false, true>(nd_u, sweeps, &bwd, chunk_u)
               : ring_blocks<float, false, true>(nd_u, sweeps, &bwd, chunk_u);
  } else {
    code = f64 ? ring_blocks<double, false, false>(nd_u, sweeps, &bwd, chunk_u)
               : ring_blocks<float, false, false>(nd_u, sweeps, &bwd, chunk_u);
  }
  if (code != 0) return code;
  *blocks = fwd < bwd ? fwd : bwd;
  return 0;
}

}  // extern "C"
