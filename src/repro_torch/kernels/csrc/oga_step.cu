// The fused OGA slot update and the standalone sortscan projection.
//
// oga_step_kernel replaces the TPU kernel src/repro/kernels/oga_step.py
// (oga_step_fused, _kernel, _util_grad), method="sortscan" only;
// proj_sortscan_kernel replaces src/repro/kernels/sortscan.py
// (proj_sortscan, _kernel). Both project through the __device__ water
// level of sortscan.cuh.
//
// One thread block per row n = cell (r, k) of the packed (N, L) layout,
// lanes = ports. For its lane l a thread computes
//   g = f'(y m) - beta 1{k = k*_l}          (eq. 30, all seven kinds)
//   z = y + eta x g m                       (Alg. 1 step 5)
// and the block projects the row (steps 6-31). The products and sums of z
// use round-to-nearest intrinsics, so nvcc cannot contract them into an
// FMA and z rounds as the plain PyTorch version rounds it.
//
// Bound on the H100: bytes. One step reads y, a, mask, x, kstar (N, L) and
// scal (N, 5) and writes y(t+1) (N, L): 4 N (6L + 5) bytes, 0.20 MB at the
// Fig. 2 shape (768, 10) or 0.06 us at 3.35 TB/s; 14.9 MB at Fig. 5
// (6144, 100), 4.4 us; 12.8 MB for a 64-config Fig. 2 grid (49152, 10),
// 3.8 us. At Fig. 2 the launch itself costs far more than the bytes. This
// first kernel does nothing about either yet: it is the simple, correct
// one.
#include <cuda_runtime.h>

#include "sortscan.cuh"

namespace repro_torch {

// Columns of the packed per-row scalars: kernels/oga_step.py SCAL_COLUMNS.
constexpr int kScalCols = 5;
constexpr int kMaxThreads = 1024;

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

__global__ void oga_step_kernel(const float* __restrict__ y,
                                const float* __restrict__ a,
                                const float* __restrict__ mask,
                                const float* __restrict__ x,
                                const float* __restrict__ kstar,
                                const float* __restrict__ scal,
                                float* __restrict__ out, int L) {
  extern __shared__ double smem[];
  const long long row = blockIdx.x;
  const int i = threadIdx.x;
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
    float g = util_grad(kind, alpha, __fmul_rn(yl, ml));
    g = __fsub_rn(g, __fmul_rn(beta, kstar[idx]));
    z = __fadd_rn(yl, __fmul_rn(__fmul_rn(__fmul_rn(eta, x[idx]), g), ml));
  }
  bool need;
  const double tau = sortscan_water_level(z, al, ml, has_lane, c, L, smem, &need);
  if (has_lane) out[idx] = water_fill(z, al, ml, tau, need);
}

__global__ void proj_sortscan_kernel(const float* __restrict__ z,
                                     const float* __restrict__ a,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ c,
                                     float* __restrict__ out, int L) {
  extern __shared__ double smem[];
  const long long row = blockIdx.x;
  const int i = threadIdx.x;
  const bool has_lane = i < L;
  const long long idx = row * L + i;
  const float zl = has_lane ? z[idx] : 0.0f;
  const float al = has_lane ? a[idx] : 0.0f;
  const float ml = has_lane ? mask[idx] : 0.0f;
  bool need;
  const double tau = sortscan_water_level(zl, al, ml, has_lane, c[row], L, smem, &need);
  if (has_lane) out[idx] = water_fill(zl, al, ml, tau, need);
}

// A legal block for rows of width L: a power of two of at least one warp,
// at most kMaxThreads, with a slot for each of the 2L breakpoints.
static bool legal_block(int L, int threads) {
  return L >= 1 && threads >= 32 && threads <= kMaxThreads &&
         (threads & (threads - 1)) == 0 && threads >= 2 * L;
}

}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/build.py. Each returns
// the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_oga_step(const float* y, const float* a, const float* mask,
                              const float* x, const float* kstar, const float* scal,
                              float* out, int n, int L, int threads, void* stream) {
  using namespace repro_torch;
  if (n <= 0 || !legal_block(L, threads)) return static_cast<int>(cudaErrorInvalidValue);
  oga_step_kernel<<<n, threads, water_level_smem_bytes(threads), static_cast<cudaStream_t>(stream)>>>(
      y, a, mask, x, kstar, scal, out, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_proj_sortscan(const float* z, const float* a, const float* mask,
                                   const float* c, float* out, int n, int L, int threads,
                                   void* stream) {
  using namespace repro_torch;
  if (n <= 0 || !legal_block(L, threads)) return static_cast<int>(cudaErrorInvalidValue);
  proj_sortscan_kernel<<<n, threads, water_level_smem_bytes(threads), static_cast<cudaStream_t>(stream)>>>(
      z, a, mask, c, out, L);
  return static_cast<int>(cudaGetLastError());
}
