// Exact water-level projection of one row, by a breakpoint sort and scans.
//
// Replaces the TPU kernel src/repro/kernels/sortscan.py
// (_sortscan_water_level, _bitonic_sort_pairs, _kernel, proj_sortscan).
//
// P threads project one row of L lanes onto
// {0 <= y <= a, sum_l m_l y_l <= c}. P is a power of two >= max(32, 2L)
// (kernels/autotune.py: slots_for), and the row owns P breakpoint slots of
// shared memory. A thread block holds row_block such rows; each row
// synchronises on its own (RowGroup below), so a row that needs no
// projection, or a row past the end of the last block, leaves without
// stranding the others, and a row's arithmetic is the same whatever
// row_block is. Thread l < L of a row holds lane l in registers.
//
//   1. need = sum_l clip(z_l, 0, a_l) m_l > c; otherwise the box clip is
//      the projection.
//   2. The 2L breakpoints of g(tau) = sum_l m_l clip(z_l - tau, 0, a_l)
//      go to slots l (z_l - a_l, slope delta +m_l) and L + l (z_l, -m_l);
//      pad slots hold -1e30 with delta 0, so they sort to the front and
//      leave every prefix sum unchanged.
//   3. A bitonic sort of (value, delta) pairs in shared memory; ties are
//      never swapped, and tied breakpoints give g the same value whatever
//      their order.
//   4. An inclusive scan of the deltas gives the active-lane count n_seg
//      on each segment; a second scan of the drops n_seg * width walks g
//      down from g(-inf) = sum_l a_l m_l.
//   5. lo = max{v_j : g(v_j) >= c}, a row max.
//   6. As in the reference, g(lo) and the slope n at lo are recomputed
//      directly in O(L) and tau = lo + (g(lo) - c) / n solved in closed
//      form. The scans only SELECT the segment, so their rounding cannot
//      reach the result beyond a tie between segments.
//
// The breakpoints, sums and tau are double. In float32 the breakpoint
// z - a rounds by up to half an ulp of z, and tau inherits that error (the
// reference's own float32 sweep is off the float64 oracle by ~1e-6 at
// |z| ~ 16); in double the only rounding left that matters is the final
// store of each lane to float32.
//
// The Pallas kernel builds its sort and scans from 0/1 matmuls because
// Mosaic has no sort or gather; here they are plain shared-memory loops.
//
// Bound on the H100: bytes. The function reads 3 (N, L) rows and c and
// writes one (N, L) row: 4 N (4L + 1) bytes, some O(P log^2 P) compares
// per row. At L = 10 a row is one warp; row_block rows per block let an
// SM hold more than its 32 resident blocks' worth of rows.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro_torch {

constexpr double kNeg = -1e30;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// How the P threads of one row synchronise, chosen per launch:
//   kSyncWarp   P = 32: the row is one warp; __syncwarp orders its shared
//               memory (no block barrier at all).
//   kSyncBlock  one row per block: __syncthreads (barrier 0).
//   kSyncNamed  several rows of P > 32 threads: the row's warps meet at
//               named barrier `bar` (the row's index in its block, at most
//               15 since P >= 64 and row_block * P <= 1024) with P threads.
// A barrier id held in a register makes ptxas reserve all 16 named
// barriers of the block; one-warp blocks built that way ran 4x slower on an
// H100 (PERF.md), so only the launches that need a barrier per row get one.
constexpr int kSyncWarp = 0;
constexpr int kSyncBlock = 1;
constexpr int kSyncNamed = 2;

template <int kSync>
struct RowGroup {
  int p;    // threads (= breakpoint slots) of the row
  int i;    // this thread's slot in the row
  int bar;  // the row's index in its block

  __device__ __forceinline__ void sync() const {
    if constexpr (kSync == kSyncWarp) {
      __syncwarp();
    } else if constexpr (kSync == kSyncBlock) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(p) : "memory");
    }
  }
};

template <typename T>
__device__ __forceinline__ T clip0(T v, T hi) {
  return fmin(fmax(v, T(0)), hi);
}

// Butterfly reductions: every lane ends with the same bits, because each
// step adds the same two values in both partner lanes.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Row-wide sum (or max): every thread of the row gets the same result.
// `red` holds one T per warp of the row.
template <bool kMax, typename T, typename Row>
__device__ T row_reduce(T v, T* red, const Row& row) {
  const T ident = kMax ? T(kNeg) : T(0);
  v = kMax ? warp_max(v) : warp_sum(v);
  const int nw = row.p / kWarp;
  if (nw == 1) return v;
  const int lane = row.i & (kWarp - 1);
  row.sync();  // a previous reduction may still be reading red
  if (lane == 0) red[row.i / kWarp] = v;
  row.sync();
  const T t = lane < nw ? red[lane] : ident;
  return kMax ? warp_max(t) : warp_sum(t);
}

// Inclusive Hillis-Steele scan of buf[0, P), one slot per thread of the
// row. The caller has synchronised after writing buf; it is synchronised
// on return.
template <typename Row>
__device__ void row_scan(double* buf, const Row& row) {
  const int i = row.i;
  for (int off = 1; off < row.p; off <<= 1) {
    const double t = i >= off ? buf[i - off] : 0.0;
    row.sync();
    buf[i] += t;
    row.sync();
  }
}

// Ascending bitonic sort of (v, d) pairs over the row's P slots.
template <typename Row>
__device__ void bitonic_sort_pairs(double* v, double* d, const Row& row) {
  const int i = row.i;
  for (int k = 2; k <= row.p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int partner = i ^ j;
      if (partner > i) {
        const bool ascending = (i & k) == 0;
        const double vi = v[i], vp = v[partner];
        if (ascending ? (vi > vp) : (vi < vp)) {
          v[i] = vp;
          v[partner] = vi;
          const double di = d[i];
          d[i] = d[partner];
          d[partner] = di;
        }
      }
      row.sync();
    }
  }
}

// Shared memory of one row of `p` slots: breakpoints and deltas (one
// double each per slot) and one double per warp. A block of row_block rows
// takes row_block times this (kernels/autotune.py mirrors the formula).
__host__ __device__ constexpr size_t water_level_smem_bytes(int p) {
  return (2 * static_cast<size_t>(p) + kWarp) * sizeof(double);
}

// Launch layout shared by every kernel here: row_block rows of `p` threads
// per block (a power of two, at most 1024 threads, the rows' shared memory
// within the 48 KB a block gets without the opt-in attribute), a row per
// 2L breakpoints. kernels/autotune.py legal_row_block is the same test.
constexpr int kMaxThreads = 1024;
constexpr size_t kSmemBudget = 48 * 1024;

inline bool legal_launch(int n, int L, int p, int row_block) {
  return n > 0 && L >= 1 && p >= kWarp && p <= kMaxThreads && (p & (p - 1)) == 0 &&
         p >= 2 * L && row_block >= 1 && (row_block & (row_block - 1)) == 0 &&
         row_block <= kMaxThreads / p &&
         row_block * water_level_smem_bytes(p) <= kSmemBudget;
}

// Calls f(std::integral_constant<int, kSync>{}) with the sync mode of a
// launch of row_block rows of p threads, so each entry launches the kernel
// instantiated for it.
template <typename F>
void with_sync_mode(int p, int row_block, F&& f) {
  if (p == kWarp) {
    f(std::integral_constant<int, kSyncWarp>{});
  } else if (row_block == 1) {
    f(std::integral_constant<int, kSyncBlock>{});
  } else {
    f(std::integral_constant<int, kSyncNamed>{});
  }
}

// This thread's row: its group within the block and the row's index in the
// packed (N, L) layout. Rows of the block are consecutive.
template <int kSync>
__device__ __forceinline__ RowGroup<kSync> row_group(int p) {
  const int r = threadIdx.x / p;
  return RowGroup<kSync>{p, static_cast<int>(threadIdx.x) - r * p, r};
}

template <typename Row>
__device__ __forceinline__ long long row_index(const Row& g) {
  return static_cast<long long>(blockIdx.x) * (blockDim.x / g.p) + g.bar;
}

// The row's own slice of the block's dynamic shared memory.
template <typename Row>
__device__ __forceinline__ double* row_smem(double* smem, const Row& g) {
  return smem + g.bar * (water_level_smem_bytes(g.p) / sizeof(double));
}

// The water level tau of this row (0 when the capacity does not bind) and
// whether it binds. Lane (z, a, m) is valid when has_lane. `smem` is the
// row's own water_level_smem_bytes(row.p) bytes.
template <typename Row>
__device__ double sortscan_water_level(float zf, float af, float mf, bool has_lane,
                                       float cf, int L, double* smem,
                                       const Row& row, bool* need) {
  double* v = smem;
  double* d = smem + row.p;
  double* red = smem + 2 * row.p;
  const int i = row.i;
  const double z = zf, a = af, m = mf, c = cf;
  const double box = has_lane ? clip0(z, a) * m : 0.0;
  *need = row_reduce<false>(box, red, row) > c;
  if (!*need) return 0.0;  // the same branch in every thread of the row

  if (has_lane) {
    v[i] = z - a;
    d[i] = m;
    v[L + i] = z;
    d[L + i] = -m;
  }
  if (i >= 2 * L) {
    v[i] = kNeg;
    d[i] = 0.0;
  }
  row.sync();
  bitonic_sort_pairs(v, d, row);

  const double vs = v[i];
  const double v_prev = i > 0 ? v[i - 1] : vs;
  row_scan(d, row);                                 // d: n_seg per segment
  const double n_prev = i > 0 ? d[i - 1] : 0.0;
  const double drop = n_prev * (vs - v_prev);       // pads: 0 * width
  row.sync();
  d[i] = drop;
  row.sync();
  row_scan(d, row);                                 // d: g(v_0) - g(v_i)

  const double g0 = row_reduce<false>(has_lane ? a * m : 0.0, red, row);
  const double gv = g0 - d[i];
  const double lo = row_reduce<true>(gv >= c ? vs : kNeg, red, row);

  const double glo = row_reduce<false>(has_lane ? clip0(z - lo, a) * m : 0.0, red, row);
  const double inside = (has_lane && z - a <= lo && z > lo) ? m : 0.0;
  const double n = row_reduce<false>(inside, red, row);
  const double tau = n > 0.5 ? lo + (glo - c) / fmax(n, 1.0) : lo;
  return fmax(tau, 0.0);
}

// The projected lane, rounded once to float32: the box clip where the
// capacity does not bind.
__device__ __forceinline__ float water_fill(float z, float a, float m, double tau,
                                            bool need) {
  if (!need) return clip0(z, a) * m;
  return static_cast<float>(clip0(static_cast<double>(z) - tau, static_cast<double>(a)) * m);
}

}  // namespace repro_torch
