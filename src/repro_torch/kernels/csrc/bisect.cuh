// Water level of one row by seeded bisection, in float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/proj_bisect.py (_water_level,
// _kernel, proj_bisect) and is the method="bisect" branch of the fused OGA
// step (src/repro/kernels/oga_step.py _kernel). It computes what
// _water_level computes:
//
//   box = clip(z, 0, a) m, need = sum box > c;
//   lo = max((sum box - c) / max(sum m, 1), 0): g is 1-Lipschitz per active
//        lane, so g(lo) >= c;
//   hi = max(max_{m > 0} z, lo);
//   `iters` halvings of [lo, hi] on g(mid) > c;
//   the secant tau = lo + (g(lo) - c)(hi - lo) / max(g(lo) - g(hi), 1e-30),
//   clipped to [lo, hi].
//
// Layout: the sortscan kernels' (sortscan.cuh), so both methods launch by
// one rule (legal_sortscan_launch). A row of L <= kWideL lanes is W =
// sortscan_lanes(L) lanes of one warp (W = 16 and two rows a warp at
// L <= 16); lane j holds ports j + W q, q < Q = slots_for(L) / (2 W), in
// registers, loaded coalesced. A row of kWideL < L <= kMaxL lanes is one
// block of kWideThreads threads, thread t holding ports t + kWideThreads q,
// q < Q = slots_for(L) / (2 kWideThreads) <= 8. A missing port (past L, or
// in a row past n) is z = a = m = 0: it adds +0 to every sum and nothing
// to the max.
//
// Every g is a row sum: a lane sums its Q ports in order, then an xor
// butterfly over the row's W lanes gives every lane the same bits. A wide
// row's 16 warps each reduce so, and put one float each in shared memory;
// a second butterfly over those 16 gives every thread the same bits. The
// two buffers of 16 floats are used in turn, so a reduction takes one
// __syncthreads. Rows of L <= kWideL use no shared memory and no barrier:
// every lane of the warp reaches every shuffle, a row that does not bind
// beside one that does runs on and stores the box clip, and rows past n
// store nothing. A row's sums do not depend on the row block, so neither
// do its bits. Products, sums and quotients use round-to-nearest
// intrinsics, so nvcc contracts nothing into an FMA, and the float32 numpy
// emulation of tests/_bisect_network.py gives the same bits. |tau - tau*|
// <= (hi - lo) / 2^iters, so the result is within that of the exact sweep,
// not bitwise.
//
// Bound on the H100: bytes, 4 N (4L + 1) for the projection, the same
// 4 N (6L + 5) as the sortscan branch for the fused step; (iters + 4)
// row sums of L lanes are far below the float32 rate. What holds the
// kernels above the bytes is what a warp issues: (iters + 4) sums of
// ~5 Q instructions a lane and log2 W shuffles and adds, a dependent chain.
#pragma once

#include <type_traits>

#include "sortscan.cuh"

namespace repro_torch {

constexpr float kNegF = static_cast<float>(kNeg);
// Most halvings a launch takes (kernels/autotune.py MAX_BISECT_ITERS).
constexpr int kMaxIters = 64;
// A wide row's block fits the sortscan launch bound of every bisect kernel.
static_assert(kWideThreads <= kSortscanMaxThreads, "a wide bisect row exceeds the launch bound");

// Calls f(integral_constant<W>, integral_constant<Q>) with the layout of a
// bisect row of L lanes: W threads a row, Q ports a thread. Each entry
// launches the instantiation for it.
template <typename F>
void with_bisect_layout(int L, F&& f) {
  using std::integral_constant;
  if (L <= kWideL) {
    with_sortscan_layout(L, [&](auto w, auto e) {
      f(w, integral_constant<int, decltype(e)::value / 2>{});
    });
    return;
  }
  constexpr integral_constant<int, kWideThreads> wide{};
  switch (slots_for(L) / (2 * kWideThreads)) {
    case 1: return f(wide, integral_constant<int, 1>{});
    case 2: return f(wide, integral_constant<int, 2>{});
    case 4: return f(wide, integral_constant<int, 4>{});
    default: return f(wide, integral_constant<int, kMaxL / kWideThreads>{});
  }
}

// Sum (or max) over a wide row's block; every thread gets the same bits.
// `turn` alternates over every reduction of the row, sums and maxima
// alike: buffer `turn` is written after the barrier of the reduction
// before, which every warp reaches only after its read of that buffer two
// reductions back, so one barrier a reduction suffices. Every thread of the
// block must call it.
template <bool kMax>
__device__ __forceinline__ float wide_reduce(float v, int& turn) {
  __shared__ float red[2][kWideWarps];
  const int w = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  v = kMax ? group_max<kWarp>(v) : group_sum<kWarp>(v);
  if (lane == 0) red[turn][w] = v;
  __syncthreads();
  const float t = red[turn][lane % kWideWarps];
  turn ^= 1;
  return kMax ? group_max<kWideWarps>(t) : group_sum<kWideWarps>(t);
}

// Reductions over the W threads of a row: W lanes of a warp, or the
// kWideThreads threads of a wide row's block.
template <int W>
struct RowReduce {
  int turn = 0;  // wide rows: the shared buffer of the next reduction

  __device__ __forceinline__ float sum(float v) {
    if constexpr (W <= kWarp) {
      return group_sum<W>(v);
    } else {
      return wide_reduce<false>(v, turn);
    }
  }

  __device__ __forceinline__ float max(float v) {
    if constexpr (W <= kWarp) {
      return group_max<W>(v);
    } else {
      return wide_reduce<true>(v, turn);
    }
  }
};

// The ports one thread of a bisect row holds, as float32.
template <int Q>
struct BisectPorts {
  float z[Q], a[Q], m[Q];
};

// The thread's sum of f(q) over its Q ports, in order.
template <int Q, typename F>
__device__ __forceinline__ float ports_sum(F&& f) {
  float t = f(0);
#pragma unroll
  for (int q = 1; q < Q; ++q) t = __fadd_rn(t, f(q));
  return t;
}

// The water level of this thread's row (0 when the capacity does not bind)
// and whether it binds. Every thread of the warp (of the block, for a wide
// row) must call this: it shuffles, and a wide row synchronises.
template <int W, int Q>
__device__ float bisect_water_level(const BisectPorts<Q>& x, float c, int iters, bool* need) {
  RowReduce<W> row;
  // the box sum, the active lanes and the largest active z: three
  // independent reductions, issued together
  float zmax = kNegF;
#pragma unroll
  for (int q = 0; q < Q; ++q) zmax = x.m[q] > 0.0f ? fmaxf(zmax, x.z[q]) : zmax;
  const float s_box = row.sum(
      ports_sum<Q>([&](int q) { return __fmul_rn(clip0(x.z[q], x.a[q]), x.m[q]); }));
  const float n_act = fmaxf(row.sum(ports_sum<Q>([&](int q) { return x.m[q]; })), 1.0f);
  zmax = row.max(zmax);
  *need = s_box > c;
  // the same branch in every lane of the warp (a wide row's need is the
  // block's); a row that does not bind beside one that does runs on, and
  // its caller ignores tau
  if (!__any_sync(kFullMask, *need)) return 0.0f;

  float lo = fmaxf(__fdiv_rn(__fsub_rn(s_box, c), n_act), 0.0f);
  float hi = fmaxf(zmax, lo);
  // g(tau) = sum_l clip(z_l - tau, 0, a_l) m_l over the row
  const auto g = [&](float tau) {
    return row.sum(ports_sum<Q>(
        [&](int q) { return __fmul_rn(clip0(__fsub_rn(x.z[q], tau), x.a[q]), x.m[q]); }));
  };
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool too_big = g(mid) > c;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const float glo = g(lo);
  const float ghi = g(hi);
  const float step = __fdiv_rn(__fmul_rn(__fsub_rn(glo, c), __fsub_rn(hi, lo)),
                               fmaxf(__fsub_rn(glo, ghi), 1e-30f));
  return fminf(fmaxf(__fadd_rn(lo, step), lo), hi);
}

// The projected lane: the box clip where the capacity does not bind.
__device__ __forceinline__ float bisect_fill(float z, float a, float m, float tau, bool need) {
  return __fmul_rn(clip0(need ? __fsub_rn(z, tau) : z, a), m);
}

}  // namespace repro_torch
