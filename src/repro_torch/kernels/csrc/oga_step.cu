// The fused OGA slot update and the standalone sortscan projection.
//
// oga_step_kernel replaces the TPU kernel src/repro/kernels/oga_step.py
// (oga_step_fused, _kernel, _util_grad), both of its projection methods:
// "sortscan", the exact water level of sortscan.cuh, and "bisect", the
// seeded bisection of bisect.cuh. proj_sortscan_kernel replaces
// src/repro/kernels/sortscan.py (proj_sortscan, _kernel).
//
// Layout: row_block rows n = cell (r, k) of the packed (N, L) layout per
// block, P = slots_for(L) threads per row (sortscan.cuh), lanes = ports.
// For its lane l a thread computes
//   g = f'(y m) - beta 1{k = k*_l}          (eq. 30, all seven kinds)
//   z = y + eta x g m                       (Alg. 1 step 5)
// and the row projects itself (steps 6-31). The products and sums of z
// use round-to-nearest intrinsics, so nvcc cannot contract them into an
// FMA and z rounds as the plain PyTorch version rounds it.
//
// Bound on the H100: bytes. One step reads y, a, mask, x, kstar (N, L) and
// scal (N, 5) and writes y(t+1) (N, L): 4 N (6L + 5) bytes, 0.20 MB at the
// Fig. 2 shape (768, 10) or 0.06 us at 3.35 TB/s; 14.9 MB at Fig. 5
// (6144, 100), 4.4 us; 12.8 MB for a 64-config Fig. 2 grid (49152, 10),
// 3.8 us. At Fig. 2 the launch itself costs far more than the bytes. The
// design answers the block count only: row_block (kernels/autotune.py)
// packs several rows into a block, so an SM is not capped at its 32
// resident one-warp blocks; PERF.md records what that gains.
#include <cuda_runtime.h>

#include "bisect.cuh"
#include "sortscan.cuh"

namespace repro_torch {

// Columns of the packed per-row scalars: kernels/oga_step.py SCAL_COLUMNS.
constexpr int kScalCols = 5;
// Projection methods, in the order of kernels/autotune.py PROJ_METHODS.
constexpr int kSortscan = 0;
constexpr int kBisect = 1;
constexpr int kMaxIters = 64;

// (f_r^k)'(y) of core/utilities.py util_grad, kinds 0-6; 0 for any other.
__device__ __forceinline__ float util_grad(int kind, float alpha, float y) {
  y = fmaxf(y, 0.0f);
  switch (kind) {
    case 0: return alpha;                                        // linear
    case 1: return alpha / (1.0f + y);                           // log
    case 2: { const float t = y + alpha; return 1.0f / (t * t); }  // reciprocal
    case 3: return alpha / (2.0f * sqrtf(y + 1.0f));             // poly
    case 4: return 0.25f * alpha * powf(y + 1.0f, -0.75f);       // pow25
    case 5: return 0.75f * alpha * powf(y + 1.0f, -0.25f);       // pow75
    case 6: return alpha * expf(-y);                             // expsat
    default: return 0.0f;
  }
}

template <int kMethod, int kSync>
__global__ void oga_step_kernel(const float* __restrict__ y,
                                const float* __restrict__ a,
                                const float* __restrict__ mask,
                                const float* __restrict__ x,
                                const float* __restrict__ kstar,
                                const float* __restrict__ scal,
                                float* __restrict__ out, int n, int L, int p, int iters) {
  extern __shared__ double smem[];
  const auto g = row_group<kSync>(p);
  const long long row = row_index(g);
  if (row >= n) return;  // a whole row leaves: it waits at no barrier of another
  const int i = g.i;
  const bool has_lane = i < L;
  const long long idx = row * L + i;
  const float* s = scal + row * kScalCols;
  const float alpha = s[0], beta = s[1], c = s[2], eta = s[4];
  const int kind = static_cast<int>(s[3]);

  float z = 0.0f, al = 0.0f, ml = 0.0f;
  if (has_lane) {
    const float yl = y[idx];
    al = a[idx];
    ml = mask[idx];
    float gr = util_grad(kind, alpha, __fmul_rn(yl, ml));
    gr = __fsub_rn(gr, __fmul_rn(beta, kstar[idx]));
    z = __fadd_rn(yl, __fmul_rn(__fmul_rn(__fmul_rn(eta, x[idx]), gr), ml));
  }
  bool need;
  if constexpr (kMethod == kSortscan) {
    const double tau = sortscan_water_level(z, al, ml, has_lane, c, L, row_smem(smem, g), g,
                                            &need);
    if (has_lane) out[idx] = water_fill(z, al, ml, tau, need);
  } else {
    float* red = bisect_row_smem(smem, g);
    const float tau = bisect_water_level(z, al, ml, has_lane, c, iters, red, g, &need);
    if (has_lane) out[idx] = bisect_fill(z, al, ml, tau, need);
  }
}

template <int kSync>
__global__ void proj_sortscan_kernel(const float* __restrict__ z,
                                     const float* __restrict__ a,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ c,
                                     float* __restrict__ out, int n, int L, int p) {
  extern __shared__ double smem[];
  const auto g = row_group<kSync>(p);
  const long long row = row_index(g);
  if (row >= n) return;
  const bool has_lane = g.i < L;
  const long long idx = row * L + g.i;
  const float zl = has_lane ? z[idx] : 0.0f;
  const float al = has_lane ? a[idx] : 0.0f;
  const float ml = has_lane ? mask[idx] : 0.0f;
  bool need;
  const double tau = sortscan_water_level(zl, al, ml, has_lane, c[row], L,
                                          row_smem(smem, g), g, &need);
  if (has_lane) out[idx] = water_fill(zl, al, ml, tau, need);
}

}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/_launch.py. Each returns
// the CUDA error of the launch (0 when it was accepted). `threads` is the
// row's P, `row_block` the rows per block.
extern "C" int repro_oga_step(const float* y, const float* a, const float* mask,
                              const float* x, const float* kstar, const float* scal,
                              float* out, int n, int L, int threads, int row_block,
                              int method, int iters, void* stream) {
  using namespace repro_torch;
  if (!legal_launch(n, L, threads, row_block) || iters < 0 || iters > kMaxIters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (method != kSortscan && method != kBisect) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + row_block - 1) / row_block;
  // each method takes its own shared memory per row
  const size_t smem = row_block * (method == kSortscan ? water_level_smem_bytes(threads)
                                                       : bisect_smem_bytes(threads));
  const auto st = static_cast<cudaStream_t>(stream);
  with_sync_mode(threads, row_block, [&](auto sync) {
    constexpr int kSync = decltype(sync)::value;
    if (method == kSortscan) {
      oga_step_kernel<kSortscan, kSync><<<blocks, row_block * threads, smem, st>>>(
          y, a, mask, x, kstar, scal, out, n, L, threads, iters);
    } else {
      oga_step_kernel<kBisect, kSync><<<blocks, row_block * threads, smem, st>>>(
          y, a, mask, x, kstar, scal, out, n, L, threads, iters);
    }
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_proj_sortscan(const float* z, const float* a, const float* mask,
                                   const float* c, float* out, int n, int L, int threads,
                                   int row_block, void* stream) {
  using namespace repro_torch;
  if (!legal_launch(n, L, threads, row_block)) return static_cast<int>(cudaErrorInvalidValue);
  with_sync_mode(threads, row_block, [&](auto sync) {
    proj_sortscan_kernel<decltype(sync)::value>
        <<<(n + row_block - 1) / row_block, row_block * threads,
           row_block * water_level_smem_bytes(threads), static_cast<cudaStream_t>(stream)>>>(
            z, a, mask, c, out, n, L, threads);
  });
  return static_cast<int>(cudaGetLastError());
}
