// The standalone bisection projection.
//
// proj_bisect_kernel replaces the TPU kernel src/repro/kernels/proj_bisect.py
// (proj_bisect, _kernel): each row of z (N, L) is projected onto
// {0 <= y <= a, sum_l m_l y_l <= c} with the seeded-bracket bisection and
// secant finish of bisect.cuh. Operands are float32 or bf16 (z, a, mask, c
// and the output of one type); the water level is solved in float32
// either way, and a bf16 output is rounded to nearest even once, at the
// store. Layout as in oga_step.cu's bisect kernel: the sortscan kernels'
// (bisect.cuh), row_block rows a block of W lanes each, one block of
// kWideThreads threads a row above L = 256.
//
// Bound on the H100: bytes, 4 N (4L + 1): 0.038 us at (768, 10) and
// 2.94 us at (6144, 100) at 3.35 TB/s. Per row (iters + 4) row sums of L
// float32 lanes, each a lane's in-order sum of its ports and a butterfly of
// shuffles; no sort.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bisect.cuh"

namespace repro_torch {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int W, int Q>
__global__ void __launch_bounds__(kSortscanMaxThreads)
proj_bisect_kernel(const T* __restrict__ z, const T* __restrict__ a, const T* __restrict__ mask,
                   const T* __restrict__ c, T* __restrict__ out, int n, int L, int row_block,
                   int iters) {
  const SortscanRow r = sortscan_row<W>(row_block, n);
  // every lane runs to the end: rows past n hold no port and store nothing
  BisectPorts<Q> x;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    const bool has = r.valid && l < L;
    const long long idx = r.row * L + l;
    x.z[q] = has ? load_f32(z + idx) : 0.0f;
    x.a[q] = has ? load_f32(a + idx) : 0.0f;
    x.m[q] = has ? load_f32(mask + idx) : 0.0f;
  }
  bool need;
  const float tau =
      bisect_water_level<W, Q>(x, r.valid ? load_f32(c + r.row) : 0.0f, iters, &need);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    if (r.valid && l < L) {
      store_as(out + r.row * L + l, bisect_fill(x.z[q], x.a[q], x.m[q], tau, need));
    }
  }
}

// `threads` is the lanes of one row (kernels/autotune.py row_threads): the
// bisection takes the sortscan launch rule.
template <typename T>
int launch_proj_bisect(const T* z, const T* a, const T* mask, const T* c, T* out, int n, int L,
                       int threads, int row_block, int iters, void* stream) {
  if (!legal_sortscan_launch(n, L, threads, row_block) || iters < 0 || iters > kMaxIters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  with_bisect_layout(L, [&](auto w, auto q) {
    constexpr int W = decltype(w)::value, Q = decltype(q)::value;
    proj_bisect_kernel<T, W, Q><<<(n + row_block - 1) / row_block,
                                  sortscan_block_threads(W, row_block), 0,
                                  static_cast<cudaStream_t>(stream)>>>(z, a, mask, c, out, n, L,
                                                                       row_block, iters);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/_launch.py; returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int repro_proj_bisect(const float* z, const float* a, const float* mask,
                                 const float* c, float* out, int n, int L, int threads,
                                 int row_block, int iters, void* stream) {
  return repro_torch::launch_proj_bisect(z, a, mask, c, out, n, L, threads, row_block, iters,
                                         stream);
}

extern "C" int repro_proj_bisect_bf16(const __nv_bfloat16* z, const __nv_bfloat16* a,
                                      const __nv_bfloat16* mask, const __nv_bfloat16* c,
                                      __nv_bfloat16* out, int n, int L, int threads,
                                      int row_block, int iters, void* stream) {
  return repro_torch::launch_proj_bisect(z, a, mask, c, out, n, L, threads, row_block, iters,
                                         stream);
}
