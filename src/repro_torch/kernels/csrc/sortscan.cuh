// Exact water-level projection of one row, in registers and warp shuffles.
//
// Replaces the TPU kernel src/repro/kernels/sortscan.py
// (_sortscan_water_level, _bitonic_sort_pairs, _kernel, proj_sortscan).
//
// Layout. A row of L lanes (ports) has P = slots_for(L) breakpoint slots, a
// power of two >= max(32, 2L). The row is a group of W lanes of one warp,
// and each lane holds E = P / W slots in registers:
//   L <= 16        W = 16, E = 2: two rows per warp; lane j owns port j's
//                  two breakpoints z - a and z, the rest is padding;
//   16 < L <= 256  W = 32, E = P / 32 (E = 8 at L = 100, 16 at L = 256).
// Lane j of a row holds ports j + W q, q < E / 2, loaded coalesced from
// the row's contiguous (L,) slice. A thread block holds row_block rows in
// whole warps (kernels/autotune.py: rows_per_warp, slots_per_lane and
// legal_row_block mirror the formulas here). Rows of 256 < L <= 4096
// lanes take one block a row instead (wide_water_level, at the end of this
// file): their slots would not fit a warp's registers.
//
// g(tau) = sum_l m_l clip(z_l - tau, 0, a_l) falls from sum_l a_l m_l to 0
// with breakpoints at every z_l - a_l and z_l. Both designs below compute
//   need = sum_l clip(z_l, 0, a_l) m_l > c (otherwise the box clip is the
//          projection; a warp skips the rest only when no row of it binds),
//   lo   = max{v breakpoint : g(v) >= c}, a row max,
// and, as the reference does, recompute g(lo) and the slope n at lo
// directly in O(L) and solve tau = lo + (g(lo) - c) / n in closed form, so
// how g(v) was found only SELECTS the segment: it reaches the result only
// through a breakpoint whose g lies within rounding of c.
//
// sortscan_water_level, 16 < L: slot q of a lane holds port q's z - a
// (slope delta +m), slot E / 2 + q its z (-m); pads hold -1e30 with delta
// 0, sort to the front and leave every prefix sum unchanged. The row's
// slot index is s = j E + e. An ascending bitonic sort of (value, delta)
// pairs, ties never swapped: a sub-step of partner distance s < E is a
// compare-exchange between two registers of a lane, one with s >= E a
// __shfl_xor_sync of lane distance s / E, width W. An inclusive scan of
// the deltas gives the active-lane count on each segment, a second scan of
// the drops count * width walks g down from g(-inf); each scan is a serial
// pass over the lane's E slots, a shuffle scan of log2 W steps and the
// lane's exclusive prefix added back.
//
// direct_water_level, L <= 16: each lane sums g at its own two breakpoints
// over the row's ports, fetched by shuffle. No sort and no scan: at two
// breakpoints a lane this is fewer instructions than the network (PERF.md,
// tools/sortscan_ablation.py), and it selects the same lo.
//
// No shared memory and no barrier: every lane of the warp reaches every
// shuffle (rows past the end carry padding and store nothing), and every
// reduction is a butterfly, so all lanes of a row get the same bits and a
// row's arithmetic does not depend on row_block.
//
// The breakpoints, sums and tau are double. In float32 the breakpoint
// z - a rounds by up to half an ulp of z, and tau inherits that error (the
// reference's own float32 sweep is off the float64 oracle by ~1e-6 at
// |z| ~ 16); in double the only rounding left that matters is the final
// store of each lane to float32. Products that feed a sum are __dmul_rn, so
// nvcc contracts none of them into an FMA, and the float64 emulation of
// tests/_sortscan_network.py gives the same bits.
//
// Bound on the H100: bytes, 4 N (4L + 1) for the projection. What holds
// the kernels above it is the instructions they issue: fully unrolled, a
// warp issues them all, ~450 (projection) to ~940 (fused step) at
// L <= 16 and ~2800 to ~4100 at L = 100 (the sort's ~120 cross-lane and
// ~84 in-lane compare-exchanges), against 4 issues per clock per SM; below
// one wave the row's chain of shuffles and the launch. The compare-exchanges, clamps and maxima are PTX predicate
// chains and selects: written in C++, nvcc builds each choice in integer
// registers, and fmin and fmax of doubles add a NaN fix-up.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace repro_torch {

constexpr double kNeg = -1e30;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxThreads = 1024;
// The widest row the kernels take (kernels/autotune.py MAX_L).
constexpr int kMaxL = 4096;
// Rows of at most kNarrowL lanes take half a warp each.
constexpr int kNarrowL = 16;
// Rows of more than kWideL lanes take one block of kWideThreads threads
// each, with the row's slots in shared memory (wide_water_level).
constexpr int kWideL = 256;
constexpr int kWideThreads = 512;
// Threads of a sortscan block: ptxas may give each up to 128 registers.
constexpr int kSortscanMaxThreads = 512;

template <typename T>
__device__ __forceinline__ T clip0(T v, T hi) {
  return fmin(fmax(v, T(0)), hi);
}

// clip(v, 0, hi) and max(x, y) of doubles by compare and select, in PTX:
// fmin and fmax of doubles, and the same selects written in C++, compile
// to a max, selects and a NaN-quieting fix-up each. No NaN reaches the
// water level.
__device__ __forceinline__ double clamp0(double v, double hi) {
  double r;
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.gt.f64 p, %1, 0d0000000000000000;\n\t"
      "selp.f64 %0, %1, 0d0000000000000000, p;\n\t"
      "setp.lt.f64 p, %0, %2;\n\t"
      "selp.f64 %0, %0, %2, p;\n\t"
      "}"
      : "=&d"(r)
      : "d"(v), "d"(hi));
  return r;
}

__device__ __forceinline__ double dmax(double x, double y) {
  double r;
  asm("{\n\t"
      ".reg .pred p;\n\t"
      "setp.gt.f64 p, %2, %1;\n\t"
      "selp.f64 %0, %2, %1, p;\n\t"
      "}"
      : "=d"(r)
      : "d"(x), "d"(y));
  return r;
}

// One slot of a compare-exchange across lanes: the slot takes its
// partner's pair (pv, pd) when it keeps the smaller value of the pair
// (keep_min != 0) and pv < v, or keeps the larger and pv > v; equal values
// never move. One predicate chain in PTX: nvcc otherwise builds the choice
// in integer registers.
__device__ __forceinline__ void take_if(double& v, float& d, double pv, float pd, int keep_min) {
  asm("{\n\t"
      ".reg .pred k, lt, gt;\n\t"
      "setp.ne.b32 k, %4, 0;\n\t"
      "setp.lt.and.f64 lt, %2, %0, k;\n\t"
      "setp.gt.and.f64 gt, %2, %0, !k;\n\t"
      "or.pred lt, lt, gt;\n\t"
      "selp.f64 %0, %2, %0, lt;\n\t"
      "selp.f32 %1, %3, %1, lt;\n\t"
      "}"
      : "+d"(v), "+f"(d)
      : "d"(pv), "f"(pd), "r"(keep_min));
}

// A compare-exchange inside a lane of slots e < f: swapped when up != 0
// (ascending) and ve > vf, or up == 0 and ve < vf; ties never.
__device__ __forceinline__ void exchange(double& ve, float& de, double& vf, float& df, int up) {
  asm("{\n\t"
      ".reg .pred k, lt, gt;\n\t"
      ".reg .f64 tv;\n\t"
      ".reg .f32 td;\n\t"
      "setp.ne.b32 k, %4, 0;\n\t"
      "setp.lt.and.f64 lt, %2, %0, k;\n\t"
      "setp.gt.and.f64 gt, %2, %0, !k;\n\t"
      "or.pred lt, lt, gt;\n\t"
      "mov.f64 tv, %0;\n\t"
      "selp.f64 %0, %2, %0, lt;\n\t"
      "selp.f64 %2, tv, %2, lt;\n\t"
      "mov.f32 td, %1;\n\t"
      "selp.f32 %1, %3, %1, lt;\n\t"
      "selp.f32 %3, td, %3, lt;\n\t"
      "}"
      : "+d"(ve), "+f"(de), "+d"(vf), "+f"(df)
      : "r"(up));
}

// Breakpoint slots of a row of L lanes: a power of two >= max(32, 2L).
__host__ __device__ constexpr int slots_for(int L) {
  int p = kWarp;
  while (p < 2 * L) p *= 2;
  return p;
}

// Threads that hold one sortscan row: lanes of a warp, or a whole block
// for a wide row.
__host__ __device__ constexpr int sortscan_lanes(int L) {
  return L <= kNarrowL ? kWarp / 2 : L <= kWideL ? kWarp : kWideThreads;
}

// Threads of a block of row_block sortscan rows of `lanes` lanes: whole
// warps (a lone row of 16 lanes leaves the other half of its warp idle).
__host__ __device__ constexpr int sortscan_block_threads(int lanes, int row_block) {
  return (row_block * lanes + kWarp - 1) / kWarp * kWarp;
}

// kernels/autotune.py legal_row_block(method="sortscan") is the same test;
// a wide row's block holds kWideThreads threads, so its row block is 1.
inline bool legal_sortscan_launch(int n, int L, int lanes, int row_block) {
  return n > 0 && L >= 1 && L <= kMaxL && lanes == sortscan_lanes(L) && row_block >= 1 &&
         (row_block & (row_block - 1)) == 0 &&
         sortscan_block_threads(lanes, row_block) <= kSortscanMaxThreads;
}

// Calls f(integral_constant<W>, integral_constant<E>) with the register
// layout of rows of L <= kWideL lanes, so each entry launches the
// instantiation for it.
template <typename F>
void with_sortscan_layout(int L, F&& f) {
  using std::integral_constant;
  if (L <= kNarrowL) return f(integral_constant<int, kWarp / 2>{}, integral_constant<int, 2>{});
  switch (slots_for(L) / kWarp) {
    case 2: return f(integral_constant<int, kWarp>{}, integral_constant<int, 2>{});
    case 4: return f(integral_constant<int, kWarp>{}, integral_constant<int, 4>{});
    case 8: return f(integral_constant<int, kWarp>{}, integral_constant<int, 8>{});
    default: return f(integral_constant<int, kWarp>{}, integral_constant<int, 16>{});
  }
}

// This thread's row in a sortscan launch: its index in the packed (N, L)
// layout, its lane j in the row, and whether the row exists (a lone row of
// 16 lanes pads its warp with a row that does not).
struct SortscanRow {
  long long row;
  int j;
  bool valid;
};

template <int W>
__device__ __forceinline__ SortscanRow sortscan_row(int row_block, int n) {
  const int r = static_cast<int>(threadIdx.x) / W;
  const long long row = static_cast<long long>(blockIdx.x) * row_block + r;
  return {row, static_cast<int>(threadIdx.x) % W, r < row_block && row < n};
}

// Butterflies over the W lanes of a row: every lane ends with the same
// bits, because each step adds the same two values in both partner lanes.
// Doubles for the sortscan water level, floats for the bisection
// (bisect.cuh).
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o, W);
  return v;
}

template <int W>
__device__ __forceinline__ double group_max(double v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = dmax(v, __shfl_xor_sync(kFullMask, v, o, W));
  return v;
}

template <int W>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o, W));
  return v;
}

// Inclusive scan of the row's P slots in slot order s = j E + e: a serial
// pass over the lane's E registers, a Hillis-Steele scan of the lane totals
// over the W lanes, and the lane's exclusive prefix added back.
template <int W, int E>
__device__ __forceinline__ void lane_scan(double (&x)[E], int j) {
#pragma unroll
  for (int e = 1; e < E; ++e) x[e] += x[e - 1];
  double inc = x[E - 1];
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const double t = __shfl_up_sync(kFullMask, inc, o, W);
    if (j >= o) inc += t;
  }
  const double before = __shfl_up_sync(kFullMask, inc, 1, W);
  if (j > 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) x[e] += before;
  }
}

// Sub-step (K, S) of an ascending bitonic sort of (v, d) pairs over the
// row's P = W E slots, then the sub-steps after it. Slot i = j E + e pairs
// with i ^ S, and the pair is ascending when i & K == 0. A pair is swapped
// only when its lower slot holds the larger value (ascending) or the
// smaller (descending). K and S are template arguments, so every register
// index is known at compile time and the slots never leave registers.
template <int W, int E, int K, int S>
__device__ __forceinline__ void sort_step(double (&v)[E], float (&d)[E], int j) {
  if constexpr (S < E) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int f = e ^ S;
      if (f > e) exchange(v[e], d[e], v[f], d[f], ((j * E + e) & K) == 0);
    }
  } else {
    constexpr int ls = S / E;  // lane distance of the partner
    // the lower slot of an ascending pair keeps the smaller value, as does
    // the upper slot of a descending one; the other keeps the larger. With
    // K > S >= E the direction is the lane's, the same for every register.
    const int keep_min = ((j & (K / E)) == 0) != ((j & ls) != 0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const double pv = __shfl_xor_sync(kFullMask, v[e], ls, W);
      const float pd = __shfl_xor_sync(kFullMask, d[e], ls, W);
      take_if(v[e], d[e], pv, pd, keep_min);
    }
  }
  if constexpr (S > 1) {
    sort_step<W, E, K, S / 2>(v, d, j);
  } else if constexpr (K < W * E) {
    sort_step<W, E, 2 * K, K>(v, d, j);
  }
}

template <int W, int E>
__device__ __forceinline__ void sort_slots(double (&v)[E], float (&d)[E], int j) {
  sort_step<W, E, 2, 1>(v, d, j);
}

// The water level tau of this lane's row (0 when the capacity does not
// bind) and whether it binds. The lane holds ports j + W q, q < E / 2, as
// (z, a, m); a port exists when the row is valid and j + W q < L. Every
// lane of the warp must call this (it shuffles).
template <int W, int E>
__device__ double sortscan_water_level(const float (&zf)[E / 2], const float (&af)[E / 2],
                                       const float (&mf)[E / 2], float cf, int j, int L,
                                       bool valid, bool* need) {
  constexpr int Q = E / 2;
  const double c = cf;
  double v[E];
  float d[E];
  double box = 0.0, g0 = 0.0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const bool has = valid && j + W * q < L;
    const double z = zf[q], a = af[q], m = mf[q];
    if (has) {
      box += __dmul_rn(clamp0(z, a), m);
      g0 += __dmul_rn(a, m);
    }
    v[q] = has ? z - a : kNeg;
    d[q] = has ? mf[q] : 0.0f;
    v[Q + q] = has ? z : kNeg;
    d[Q + q] = has ? -mf[q] : 0.0f;
  }
  *need = group_sum<W>(box) > c;
  // the same branch in every lane of the warp; a row that does not bind
  // beside one that does runs on, and its caller ignores tau
  if (!__any_sync(kFullMask, *need)) return 0.0;

  sort_slots<W, E>(v, d, j);
  double n[E];                                   // n_seg per segment
#pragma unroll
  for (int e = 0; e < E; ++e) n[e] = d[e];
  lane_scan<W, E>(n, j);
  const double v_up = __shfl_up_sync(kFullMask, v[E - 1], 1, W);
  const double n_up = __shfl_up_sync(kFullMask, n[E - 1], 1, W);
  double drop[E];                                // then g(v_0) - g(v_s)
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const double v_prev = e > 0 ? v[e - 1] : (j > 0 ? v_up : v[0]);
    const double n_prev = e > 0 ? n[e - 1] : (j > 0 ? n_up : 0.0);
    drop[e] = __dmul_rn(n_prev, v[e] - v_prev);  // pads: 0 * width
  }
  lane_scan<W, E>(drop, j);

  g0 = group_sum<W>(g0);
  double best = kNeg;
#pragma unroll
  for (int e = 0; e < E; ++e) best = g0 - drop[e] >= c ? dmax(best, v[e]) : best;
  const double lo = group_max<W>(best);

  double glo = 0.0, slope = 0.0;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const bool has = valid && j + W * q < L;
    const double z = zf[q], a = af[q], m = mf[q];
    if (has) {
      glo += __dmul_rn(clamp0(z - lo, a), m);
      slope += (z - a <= lo && z > lo) ? m : 0.0;
    }
  }
  glo = group_sum<W>(glo);
  slope = group_sum<W>(slope);
  const double tau = slope > 0.5 ? lo + (glo - c) / dmax(slope, 1.0) : lo;
  return dmax(tau, 0.0);
}

// The water level of a row of at most kNarrowL lanes, held one port per
// lane in W = 16 lanes: each lane evaluates g at its own two breakpoints
// z - a and z directly, g(v) = sum_l m_l clip(z_l - v, 0, a_l) summed over
// l = 0 .. L-1 in order with the row's (z, a, m) fetched by shuffle, and
// lo = max{v : g(v) >= c} is a row max. No sort and no scan; g(lo), the
// slope and tau as in sortscan_water_level. In exact arithmetic both
// select the same lo. Every lane of the warp must call this.
template <int W>
__device__ double direct_water_level(float zf, float af, float mf, float cf, int j, int L,
                                     bool valid, bool* need) {
  const bool has = valid && j < L;
  const double z = zf, a = af, m = mf, c = cf;
  *need = group_sum<W>(has ? __dmul_rn(clamp0(z, a), m) : 0.0) > c;
  if (!__any_sync(kFullMask, *need)) return 0.0;

  const double b0 = z - a, b1 = z;               // this lane's breakpoints
  double g0 = 0.0, g1 = 0.0;
  for (int l = 0; l < L; ++l) {                  // L is the same in every lane
    const double zl = __shfl_sync(kFullMask, z, l, W);
    const double al = __shfl_sync(kFullMask, a, l, W);
    const double ml = __shfl_sync(kFullMask, m, l, W);
    g0 += __dmul_rn(clamp0(zl - b0, al), ml);
    g1 += __dmul_rn(clamp0(zl - b1, al), ml);
  }
  double best = kNeg;
  if (has) {
    best = g0 >= c ? b0 : best;
    best = g1 >= c ? dmax(best, b1) : best;
  }
  const double lo = group_max<W>(best);

  const double glo = group_sum<W>(has ? __dmul_rn(clamp0(z - lo, a), m) : 0.0);
  const double slope = group_sum<W>(has && z - a <= lo && z > lo ? m : 0.0);
  const double tau = slope > 0.5 ? lo + (glo - c) / dmax(slope, 1.0) : lo;
  return dmax(tau, 0.0);
}

// The water level of this lane's row in the layout (W, E): the direct
// evaluation for rows of at most kNarrowL lanes (W = 16), the sorted
// sweep above. Every lane of the warp must call this.
template <int W, int E>
__device__ __forceinline__ double water_level(const float (&z)[E / 2], const float (&a)[E / 2],
                                              const float (&m)[E / 2], float c, int j, int L,
                                              bool valid, bool* need) {
  if constexpr (W < kWarp) {
    return direct_water_level<W>(z[0], a[0], m[0], c, j, L, valid, need);
  } else {
    return sortscan_water_level<W, E>(z, a, m, c, j, L, valid, need);
  }
}

// The projected lane, rounded once to float32: the box clip where the
// capacity does not bind.
__device__ __forceinline__ float water_fill(float z, float a, float m, double tau,
                                            bool need) {
  if (!need) return clip0(z, a) * m;
  return static_cast<float>(__dmul_rn(clamp0(static_cast<double>(z) - tau, a), m));
}

// ------------------------------------------------------------- wide rows --
// A row of kWideL < L <= kMaxL lanes is one block of kWideThreads threads.
// Thread t reads ports t + kWideThreads q, and the row's P = slots_for(L)
// breakpoint slots (1024 to 8192) live in shared memory: slot l holds port l's z - a (delta +m), slot P / 2 + l
// its z (-m), the rest -1e30 with delta 0. The same steps as
// sortscan_water_level, with block barriers in place of shuffles:
//   a bitonic sort of (value, delta) pairs, every sub-step P / 2
//   compare-exchanges spread over the threads (ties never swapped);
//   two scans, each thread owning a contiguous chunk of P / kWideThreads
//   slots: a serial pass over the chunk, a block scan of the chunk totals
//   (shuffles in a warp, the warps' totals through shared memory), and the
//   chunk's exclusive prefix added back;
//   lo a block max; g(lo), the slope and tau as in sortscan_water_level.
// Shared memory: P doubles and P floats for the slots, and kWideWarps
// doubles for the block reductions: 96.3 KiB at L = 4096, above the 48 KiB
// a block gets without the opt-in attribute (the entries set it). Every
// thread of the block must call wide_water_level (it synchronises).
constexpr int kWideWarps = kWideThreads / kWarp;

__host__ __device__ constexpr size_t wide_smem_bytes(int L) {
  return static_cast<size_t>(slots_for(L)) * (sizeof(double) + sizeof(float)) +
         kWideWarps * sizeof(double);
}

// Sum over the block: every thread gets the same bits (each warp reduces
// the same kWideWarps totals with the same butterfly).
__device__ __forceinline__ double block_sum(double v, double* red) {
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = group_sum<kWarp>(v);
  __syncthreads();  // an earlier reduction may still read red
  if (lane == 0) red[w] = v;
  __syncthreads();
  return group_sum<kWarp>(lane < kWideWarps ? red[lane] : 0.0);
}

__device__ __forceinline__ double block_max(double v, double* red) {
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = group_max<kWarp>(v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return group_max<kWarp>(lane < kWideWarps ? red[lane] : kNeg);
}

// The sum of v over the threads before this one (thread order).
__device__ __forceinline__ double block_exclusive_scan(double v, double* red) {
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  double inc = v;
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const double t = __shfl_up_sync(kFullMask, inc, o);
    if (lane >= o) inc += t;
  }
  const double up = __shfl_up_sync(kFullMask, inc, 1);
  __syncthreads();
  if (lane == kWarp - 1) red[w] = inc;
  __syncthreads();
  double before = 0.0;
  for (int i = 0; i < w; ++i) before += red[i];
  return lane > 0 ? before + up : before;
}

// A port of a wide row as the kernel reads it: z, cap a and mask m.
struct WidePort {
  float z, a, m;
};

// The water level of the block's row (0 when the capacity does not bind)
// and whether it binds. port(l) gives port l < L; thread t reads ports
// t + kWideThreads q before the sort and again after it, so no port stays
// in registers across the sort.
template <typename F>
__device__ __forceinline__ double wide_water_level(F&& port, float cf, int L, void* smem,
                                                   bool* need) {
  const int t = threadIdx.x;
  const int P = slots_for(L), half = P / 2;
  double* sv = static_cast<double*>(smem);
  float* sd = reinterpret_cast<float*>(sv + P);
  double* red = reinterpret_cast<double*>(sd + P);
  const double c = cf;
  double box = 0.0, g0 = 0.0;
  for (int l = t; l < half; l += kWideThreads) {
    // slots l and half + l hold port l's breakpoints, or padding
    const bool has = l < L;
    const WidePort p = has ? port(l) : WidePort{0.0f, 0.0f, 0.0f};
    if (has) {
      box += __dmul_rn(clamp0(static_cast<double>(p.z), static_cast<double>(p.a)), p.m);
      g0 += __dmul_rn(p.a, p.m);
    }
    sv[l] = has ? static_cast<double>(p.z) - p.a : kNeg;
    sd[l] = has ? p.m : 0.0f;
    sv[half + l] = has ? static_cast<double>(p.z) : kNeg;
    sd[half + l] = has ? -p.m : 0.0f;
  }
  *need = block_sum(box, red) > c;
  if (!*need) return 0.0;  // the same branch in every thread of the block
  // bitonic sort, ascending: pair i of a sub-step (K, S) is slots
  // lo = 2 i - (i mod S) and lo + S, ascending when lo & K == 0
  for (int K = 2; K <= P; K <<= 1) {
    for (int S = K >> 1; S > 0; S >>= 1) {
      for (int i = t; i < half; i += kWideThreads) {
        const int lo = 2 * i - (i & (S - 1)), hi = lo + S;
        double ve = sv[lo], vf = sv[hi];
        float de = sd[lo], df = sd[hi];
        exchange(ve, de, vf, df, (lo & K) == 0);
        sv[lo] = ve;
        sd[lo] = de;
        sv[hi] = vf;
        sd[hi] = df;
      }
      __syncthreads();
    }
  }

  // n_seg and g(v_0) - g(v_s) by scans over each thread's chunk of C slots
  const int C = P / kWideThreads, s0 = t * C;
  double n_tot = 0.0;
  for (int e = 0; e < C; ++e) n_tot += sd[s0 + e];
  const double n_before = block_exclusive_scan(n_tot, red);
  double n_loc = 0.0, drop_tot = 0.0;
  for (int e = 0; e < C; ++e) {
    const int s = s0 + e;
    const double n_prev = e > 0 ? n_loc + n_before : n_before;
    const double v_prev = s > 0 ? sv[s - 1] : sv[0];
    drop_tot += __dmul_rn(n_prev, sv[s] - v_prev);  // pads: 0 * width
    n_loc += sd[s];
  }
  const double drop_before = block_exclusive_scan(drop_tot, red);
  g0 = block_sum(g0, red);
  double best = kNeg, drop_loc = 0.0;
  n_loc = 0.0;
  for (int e = 0; e < C; ++e) {
    const int s = s0 + e;
    const double n_prev = e > 0 ? n_loc + n_before : n_before;
    const double v_prev = s > 0 ? sv[s - 1] : sv[0];
    drop_loc += __dmul_rn(n_prev, sv[s] - v_prev);
    n_loc += sd[s];
    best = g0 - (drop_loc + drop_before) >= c ? dmax(best, sv[s]) : best;
  }
  const double lo = block_max(best, red);

  double glo = 0.0, slope = 0.0;
  for (int l = t; l < L; l += kWideThreads) {
    const WidePort p = port(l);
    const double z = p.z, a = p.a, m = p.m;
    glo += __dmul_rn(clamp0(z - lo, a), m);
    slope += (z - a <= lo && z > lo) ? m : 0.0;
  }
  glo = block_sum(glo, red);
  slope = block_sum(slope, red);
  const double tau = slope > 0.5 ? lo + (glo - c) / dmax(slope, 1.0) : lo;
  return dmax(tau, 0.0);
}

}  // namespace repro_torch
