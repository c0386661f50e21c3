// Water level of one row by seeded bisection, in float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/proj_bisect.py (_water_level,
// _kernel, proj_bisect) and is the method="bisect" branch of the fused OGA
// step (src/repro/kernels/oga_step.py _kernel). It computes what
// _water_level computes, for the p = bisect_threads(L) = min(slots_for(L),
// 1024) threads of one row (RowGroup below), thread i holding lanes
// i + p q < L, q < kLanes (one lane a thread up to L = 512; kBisectLanes,
// up to four, above: with_bisect_layout):
//
//   box = clip(z, 0, a) m, need = sum box > c;
//   lo = max((sum box - c) / max(sum m, 1), 0): g is 1-Lipschitz per active
//        lane, so g(lo) >= c;
//   hi = max(max_{m > 0} z, lo);
//   `iters` halvings of [lo, hi] on g(mid) > c;
//   the secant tau = lo + (g(lo) - c)(hi - lo) / max(g(lo) - g(hi), 1e-30),
//   clipped to [lo, hi].
//
// Every g is a row reduction: a thread sums its own lanes in order, then
// the row reduces the threads' sums; no sort and no shared memory beyond
// one float per warp. |tau - tau*| <= (hi - lo) / 2^iters, so the result is
// within that of the exact sweep, not bitwise. Products and quotients use
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs.
//
// Bound on the H100: bytes, 4 N (4L + 1) for the projection, the same
// 4 N (6L + 5) as the sortscan branch for the fused step; (iters + 4)
// row reductions of L lanes are far below the float32 rate.
#pragma once

#include <type_traits>

#include "sortscan.cuh"

namespace repro_torch {

// How the P threads of one bisect row synchronise, chosen per launch:
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
  int p;    // threads of the row
  int i;    // this thread's index in the row
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

// Butterfly reductions over a warp: every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Row-wide sum (or max): every thread of the row gets the same result.
// `red` holds one float per warp of the row.
template <bool kMax, typename Row>
__device__ float row_reduce(float v, float* red, const Row& row) {
  const float ident = kMax ? static_cast<float>(kNeg) : 0.0f;
  v = kMax ? warp_max(v) : warp_sum(v);
  const int nw = row.p / kWarp;
  if (nw == 1) return v;
  const int lane = row.i & (kWarp - 1);
  row.sync();  // a previous reduction may still be reading red
  if (lane == 0) red[row.i / kWarp] = v;
  row.sync();
  const float t = lane < nw ? red[lane] : ident;
  return kMax ? warp_max(t) : warp_sum(t);
}

// Shared memory of one row of `p` threads: one float per warp (a one-warp
// row reduces by shuffles alone and never touches it). A launch takes
// row_block times this.
__host__ __device__ constexpr size_t bisect_smem_bytes(int p) {
  return static_cast<size_t>(p / kWarp) * sizeof(float);
}

// Launch layout of a bisect kernel: row_block rows of p = bisect_threads(L)
// threads per block (a power of two, at most 1024 threads, the rows'
// shared memory within the 48 KB a block gets without the opt-in
// attribute). kernels/autotune.py legal_row_block(method="bisect") is the
// same test.
constexpr size_t kSmemBudget = 48 * 1024;
// Lanes one bisect thread holds at most: a row of kMaxL lanes over
// kMaxThreads threads.
constexpr int kBisectLanes = kMaxL / kMaxThreads;
// Rows of at most this many lanes hold one lane a thread (2L slots fit a
// block of kMaxThreads threads).
constexpr int kBisectOneLaneL = kMaxThreads / 2;

__host__ __device__ constexpr int bisect_threads(int L) {
  return slots_for(L) < kMaxThreads ? slots_for(L) : kMaxThreads;
}

inline bool legal_bisect_launch(int n, int L, int p, int row_block) {
  return n > 0 && L >= 1 && L <= kMaxL && p == bisect_threads(L) && row_block >= 1 &&
         (row_block & (row_block - 1)) == 0 && row_block <= kMaxThreads / p &&
         row_block * bisect_smem_bytes(p) <= kSmemBudget;
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

// The row's own slice of a bisect launch's dynamic shared memory.
template <typename Row>
__device__ __forceinline__ float* bisect_row_smem(void* smem, const Row& g) {
  return static_cast<float*>(smem) + g.bar * (g.p / kWarp);
}

// Calls f(integral_constant<kSync>, integral_constant<kLanes>) with the
// layout of a bisect launch: one lane a thread and with_sync_mode's sync
// for rows of at most kBisectOneLaneL lanes; kBisectLanes lanes a thread
// and one row of kMaxThreads threads a block (barrier 0) above.
template <typename F>
void with_bisect_layout(int L, int p, int row_block, F&& f) {
  using std::integral_constant;
  if (L > kBisectOneLaneL) {
    f(integral_constant<int, kSyncBlock>{}, integral_constant<int, kBisectLanes>{});
    return;
  }
  with_sync_mode(p, row_block, [&](auto sync) { f(sync, integral_constant<int, 1>{}); });
}

// The lanes one thread of a bisect row holds: lane i + p q for q < kLanes,
// present where has[q] (so has[0] is false only on a thread past L).
template <int kLanes>
struct BisectLanes {
  float z[kLanes], a[kLanes], m[kLanes];
  bool has[kLanes];
};

// The thread's sum of f(q) over its lanes, in lane order: with one lane it
// is that lane's value (0 without one).
template <int kLanes, typename F>
__device__ __forceinline__ float lanes_sum(const BisectLanes<kLanes>& x, F&& f) {
  float t = x.has[0] ? f(0) : 0.0f;
#pragma unroll
  for (int q = 1; q < kLanes; ++q) t = x.has[q] ? __fadd_rn(t, f(q)) : t;
  return t;
}

// g(tau) = sum_l clip(z_l - tau, 0, a_l) m_l over the row.
template <int kLanes, typename Row>
__device__ __forceinline__ float clipped_sum(const BisectLanes<kLanes>& x, float tau, float* red,
                                             const Row& row) {
  const float t = lanes_sum(
      x, [&](int q) { return __fmul_rn(clip0(__fsub_rn(x.z[q], tau), x.a[q]), x.m[q]); });
  return row_reduce<false>(t, red, row);
}

// The water level of this row (0 when the capacity does not bind) and
// whether it binds. `red` holds one float per warp of the row.
template <int kLanes, typename Row>
__device__ float bisect_water_level(const BisectLanes<kLanes>& x, float c, int iters, float* red,
                                    const Row& row, bool* need) {
  const float box = lanes_sum(x, [&](int q) { return __fmul_rn(clip0(x.z[q], x.a[q]), x.m[q]); });
  const float s_box = row_reduce<false>(box, red, row);
  *need = s_box > c;
  if (!*need) return 0.0f;  // the same branch in every thread of the row

  const float n_act =
      fmaxf(row_reduce<false>(lanes_sum(x, [&](int q) { return x.m[q]; }), red, row), 1.0f);
  float lo = fmaxf(__fdiv_rn(__fsub_rn(s_box, c), n_act), 0.0f);
  float zmax = x.has[0] && x.m[0] > 0.0f ? x.z[0] : static_cast<float>(kNeg);
#pragma unroll
  for (int q = 1; q < kLanes; ++q) {
    if (x.has[q] && x.m[q] > 0.0f) zmax = fmaxf(zmax, x.z[q]);
  }
  zmax = row_reduce<true>(zmax, red, row);
  float hi = fmaxf(zmax, lo);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool too_big = clipped_sum(x, mid, red, row) > c;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const float glo = clipped_sum(x, lo, red, row);
  const float ghi = clipped_sum(x, hi, red, row);
  const float step = __fdiv_rn(__fmul_rn(__fsub_rn(glo, c), __fsub_rn(hi, lo)),
                               fmaxf(__fsub_rn(glo, ghi), 1e-30f));
  return fminf(fmaxf(__fadd_rn(lo, step), lo), hi);
}

// The projected lane: the box clip where the capacity does not bind.
__device__ __forceinline__ float bisect_fill(float z, float a, float m, float tau, bool need) {
  return __fmul_rn(clip0(need ? __fsub_rn(z, tau) : z, a), m);
}

}  // namespace repro_torch
