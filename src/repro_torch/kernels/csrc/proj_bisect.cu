// The standalone bisection projection.
//
// proj_bisect_kernel replaces the TPU kernel src/repro/kernels/proj_bisect.py
// (proj_bisect, _kernel): each row of z (N, L) is projected onto
// {0 <= y <= a, sum_l m_l y_l <= c} with the seeded-bracket bisection and
// secant finish of bisect.cuh. Operands are float32 or bf16 (z, a, mask, c
// and the output of one type); the water level is solved in float32
// either way, and a bf16 output is rounded to nearest even once, at the
// store. Layout as in oga_step.cu's bisect kernel: row_block rows of
// bisect_threads(L) threads per block, up to four lanes a thread, each row
// synchronising on its own (bisect.cuh).
//
// Bound on the H100: bytes, 4 N (4L + 1): 0.038 us at (768, 10) and
// 2.94 us at (6144, 100) at 3.35 TB/s. Per row (iters + 4) reductions of
// L float32 lanes; no sort, and no shared memory beyond one float per warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bisect.cuh"

namespace repro_torch {

constexpr int kMaxIters = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int kSync, int kLanes>
__global__ void proj_bisect_kernel(const T* __restrict__ z,
                                   const T* __restrict__ a,
                                   const T* __restrict__ mask,
                                   const T* __restrict__ c,
                                   T* __restrict__ out, int n, int L, int p, int iters) {
  extern __shared__ float smem[];
  const auto g = row_group<kSync>(p);
  const long long row = row_index(g);
  if (row >= n) return;  // a whole row leaves: it waits at no barrier of another
  BisectLanes<kLanes> lanes;
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    const int l = g.i + p * q;
    const long long idx = row * L + l;
    lanes.has[q] = l < L;
    lanes.z[q] = lanes.has[q] ? load_f32(z + idx) : 0.0f;
    lanes.a[q] = lanes.has[q] ? load_f32(a + idx) : 0.0f;
    lanes.m[q] = lanes.has[q] ? load_f32(mask + idx) : 0.0f;
  }
  float* red = bisect_row_smem(smem, g);
  bool need;
  const float tau = bisect_water_level(lanes, load_f32(c + row), iters, red, g, &need);
#pragma unroll
  for (int q = 0; q < kLanes; ++q) {
    if (lanes.has[q]) {
      store_as(out + row * L + g.i + p * q,
               bisect_fill(lanes.z[q], lanes.a[q], lanes.m[q], tau, need));
    }
  }
}

template <typename T>
int launch_proj_bisect(const T* z, const T* a, const T* mask, const T* c, T* out, int n, int L,
                       int threads, int row_block, int iters, void* stream) {
  if (!legal_bisect_launch(n, L, threads, row_block) || iters < 0 || iters > kMaxIters) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  with_bisect_layout(L, threads, row_block, [&](auto sync, auto lanes) {
    proj_bisect_kernel<T, decltype(sync)::value, decltype(lanes)::value>
        <<<(n + row_block - 1) / row_block, row_block * threads,
           row_block * bisect_smem_bytes(threads), static_cast<cudaStream_t>(stream)>>>(
            z, a, mask, c, out, n, L, threads, iters);
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
