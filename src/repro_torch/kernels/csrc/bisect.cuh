// Water level of one row by seeded bisection, in float32 throughout.
//
// Replaces the TPU kernel src/repro/kernels/proj_bisect.py (_water_level,
// _kernel, proj_bisect) and is the method="bisect" branch of the fused OGA
// step (src/repro/kernels/oga_step.py _kernel). It computes what
// _water_level computes, for the P threads of one row (RowGroup, as in
// sortscan.cuh), thread l < L holding lane l:
//
//   box = clip(z, 0, a) m, need = sum box > c;
//   lo = max((sum box - c) / max(sum m, 1), 0): g is 1-Lipschitz per active
//        lane, so g(lo) >= c;
//   hi = max(max_{m > 0} z, lo);
//   `iters` halvings of [lo, hi] on g(mid) > c;
//   the secant tau = lo + (g(lo) - c)(hi - lo) / max(g(lo) - g(hi), 1e-30),
//   clipped to [lo, hi].
//
// Every g is a row reduction; no sort and no shared memory beyond one
// float per warp. |tau - tau*| <= (hi - lo) / 2^iters, so the result is
// within that of the exact sweep, not bitwise. Products and quotients use
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs.
//
// Bound on the H100: bytes, 4 N (4L + 1) for the projection, the same
// 4 N (6L + 5) as the sortscan branch for the fused step; (iters + 4)
// row reductions of L lanes are far below the float32 rate.
#pragma once

#include "sortscan.cuh"

namespace repro_torch {

// g(tau) = sum_l clip(z_l - tau, 0, a_l) m_l over the row.
template <typename Row>
__device__ __forceinline__ float clipped_sum(float z, float a, float m, bool has_lane,
                                             float tau, float* red, const Row& row) {
  const float t = has_lane ? __fmul_rn(clip0(__fsub_rn(z, tau), a), m) : 0.0f;
  return row_reduce<false>(t, red, row);
}

// The water level of this row (0 when the capacity does not bind) and
// whether it binds. `red` holds one float per warp of the row.
template <typename Row>
__device__ float bisect_water_level(float z, float a, float m, bool has_lane, float c,
                                    int iters, float* red, const Row& row,
                                    bool* need) {
  const float box = has_lane ? __fmul_rn(clip0(z, a), m) : 0.0f;
  const float s_box = row_reduce<false>(box, red, row);
  *need = s_box > c;
  if (!*need) return 0.0f;  // the same branch in every thread of the row

  const float n_act = fmaxf(row_reduce<false>(has_lane ? m : 0.0f, red, row), 1.0f);
  float lo = fmaxf(__fdiv_rn(__fsub_rn(s_box, c), n_act), 0.0f);
  const float zmax = row_reduce<true>(has_lane && m > 0.0f ? z : static_cast<float>(kNeg),
                                      red, row);
  float hi = fmaxf(zmax, lo);
  for (int it = 0; it < iters; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    const bool too_big = clipped_sum(z, a, m, has_lane, mid, red, row) > c;
    lo = too_big ? mid : lo;
    hi = too_big ? hi : mid;
  }
  const float glo = clipped_sum(z, a, m, has_lane, lo, red, row);
  const float ghi = clipped_sum(z, a, m, has_lane, hi, red, row);
  const float step = __fdiv_rn(__fmul_rn(__fsub_rn(glo, c), __fsub_rn(hi, lo)),
                               fmaxf(__fsub_rn(glo, ghi), 1e-30f));
  return fminf(fmaxf(__fadd_rn(lo, step), lo), hi);
}

// Shared memory of one row of `p` threads: one float per warp (a one-warp
// row reduces by shuffles alone and never touches it). A bisect launch
// takes row_block times this; its legality is the shared legal_launch of
// sortscan.cuh, whose thread limit binds before either method's shared
// memory does.
__host__ __device__ constexpr size_t bisect_smem_bytes(int p) {
  return static_cast<size_t>(p / kWarp) * sizeof(float);
}

// The row's own slice of a bisect launch's dynamic shared memory.
template <typename Row>
__device__ __forceinline__ float* bisect_row_smem(void* smem, const Row& g) {
  return static_cast<float*>(smem) + g.bar * (g.p / kWarp);
}

// The projected lane: the box clip where the capacity does not bind.
__device__ __forceinline__ float bisect_fill(float z, float a, float m, float tau, bool need) {
  return __fmul_rn(clip0(need ? __fsub_rn(z, tau) : z, a), m);
}

}  // namespace repro_torch
