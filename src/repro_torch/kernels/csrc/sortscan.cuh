// Exact water-level projection of one row, by a breakpoint sort and scans.
//
// Replaces the TPU kernel src/repro/kernels/sortscan.py
// (_sortscan_water_level, _bitonic_sort_pairs, _kernel, proj_sortscan).
//
// One thread block projects one row of L lanes onto
// {0 <= y <= a, sum_l m_l y_l <= c}. The block has P threads and P
// breakpoint slots in shared memory, P a power of two >= max(32, 2L)
// (kernels/autotune.py: slots_for). Thread l < L holds lane l in registers.
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
//   5. lo = max{v_j : g(v_j) >= c}, a block max.
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
// per row. This first kernel does nothing about that bound yet: it is the
// simple, correct one (one block per row, no row batching, no overlap).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr double kNeg = -1e30;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T clip0(T v, T hi) {
  return fmin(fmax(v, T(0)), hi);
}

// Butterfly reductions: every lane ends with the same bits, because each
// step adds the same two values in both partner lanes.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Block-wide sum (or max): every thread gets the result. `red` holds one
// double per warp. blockDim.x is a multiple of 32.
template <bool kMax>
__device__ double block_reduce(double v, double* red) {
  v = kMax ? warp_max(v) : warp_sum(v);
  const int nw = blockDim.x >> 5;
  if (nw == 1) return v;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // a previous reduction may still be reading red
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const double t = lane < nw ? red[lane] : (kMax ? kNeg : 0.0);
  return kMax ? warp_max(t) : warp_sum(t);
}

// Inclusive Hillis-Steele scan of buf[0, blockDim.x), one slot per thread.
// The caller has synchronised after writing buf; it is synchronised on return.
__device__ void block_scan(double* buf) {
  const int i = threadIdx.x;
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const double t = i >= off ? buf[i - off] : 0.0;
    __syncthreads();
    buf[i] += t;
    __syncthreads();
  }
}

// Ascending bitonic sort of (v, d) pairs over blockDim.x slots.
__device__ void bitonic_sort_pairs(double* v, double* d) {
  const int i = threadIdx.x;
  const int p = blockDim.x;
  for (int k = 2; k <= p; k <<= 1) {
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
      __syncthreads();
    }
  }
}

// Shared memory the water level needs for a block of `threads` threads:
// breakpoints and deltas (one double each per slot) and one double per warp.
__host__ __device__ constexpr size_t water_level_smem_bytes(int threads) {
  return (2 * static_cast<size_t>(threads) + 32) * sizeof(double);
}

// The water level tau of this block's row (0 when the capacity does not
// bind) and whether it binds. Lane (z, a, m) is valid when has_lane.
// `smem` holds water_level_smem_bytes(blockDim.x) bytes.
__device__ double sortscan_water_level(float zf, float af, float mf, bool has_lane,
                                       float cf, int L, double* smem, bool* need) {
  double* v = smem;
  double* d = smem + blockDim.x;
  double* red = smem + 2 * blockDim.x;
  const int i = threadIdx.x;
  const double z = zf, a = af, m = mf, c = cf;
  const double box = has_lane ? clip0(z, a) * m : 0.0;
  *need = block_reduce<false>(box, red) > c;
  if (!*need) return 0.0;  // the same branch in every thread of the block

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
  __syncthreads();
  bitonic_sort_pairs(v, d);

  const double vs = v[i];
  const double v_prev = i > 0 ? v[i - 1] : vs;
  block_scan(d);                                    // d: n_seg per segment
  const double n_prev = i > 0 ? d[i - 1] : 0.0;
  const double drop = n_prev * (vs - v_prev);       // pads: 0 * width
  __syncthreads();
  d[i] = drop;
  __syncthreads();
  block_scan(d);                                    // d: g(v_0) - g(v_i)

  const double g0 = block_reduce<false>(has_lane ? a * m : 0.0, red);
  const double gv = g0 - d[i];
  const double lo = block_reduce<true>(gv >= c ? vs : kNeg, red);

  const double glo = block_reduce<false>(has_lane ? clip0(z - lo, a) * m : 0.0, red);
  const double inside = (has_lane && z - a <= lo && z > lo) ? m : 0.0;
  const double n = block_reduce<false>(inside, red);
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
