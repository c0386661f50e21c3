// The fused OGA slot update and the standalone sortscan projection.
//
// oga_step_sortscan_kernel and oga_step_bisect_kernel replace the TPU
// kernel src/repro/kernels/oga_step.py (oga_step_fused, _kernel,
// _util_grad), one per projection method: "sortscan", the exact water
// level of sortscan.cuh, and "bisect", the seeded bisection of bisect.cuh.
// proj_sortscan_kernel replaces src/repro/kernels/sortscan.py
// (proj_sortscan, _kernel).
//
// Layout: row n = cell (r, k) of the packed (N, L) layout, lanes = ports,
// row_block rows per block. The sortscan kernels hold a row of L <= 256
// lanes in W lanes of a warp, E breakpoint slots per lane (sortscan.cuh:
// two rows per warp at L <= 16), and a wider row in one block with its
// slots in shared memory (the *_wide kernels, row_block 1); the bisect
// kernel in the same lanes (one block of kWideThreads threads for a wide
// row), holding its ports' z, a and m in registers (bisect.cuh). For each
// of its ports a thread computes
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
// sortscan design answers the row's dependent chain: registers and
// shuffles, no shared memory and no barrier, half a warp per row at the
// Fig. 2 width, so an SM interleaves up to 128 rows.
#include <cuda_runtime.h>

#include "bisect.cuh"
#include "sortscan.cuh"

namespace repro_torch {

// Columns of the packed per-row scalars: kernels/oga_step.py SCAL_COLUMNS.
constexpr int kScalCols = 5;
// Projection methods, in the order of kernels/autotune.py PROJ_METHODS.
constexpr int kSortscan = 0;
constexpr int kBisect = 1;

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

// The row's packed scalars (kernels/oga_step.py SCAL_COLUMNS).
struct StepScalars {
  float alpha, beta, c, eta;
  int kind;
};

__device__ __forceinline__ StepScalars step_scalars(const float* scal, long long row) {
  const float* s = scal + row * kScalCols;
  return {s[0], s[1], s[2], s[4], static_cast<int>(s[3])};
}

// The ascent of one lane: z = y + eta x g m with g of eq. 30.
__device__ __forceinline__ float ascend(const StepScalars& s, float y, float m, float x,
                                        float kstar) {
  float gr = util_grad(s.kind, s.alpha, __fmul_rn(y, m));
  gr = __fsub_rn(gr, __fmul_rn(s.beta, kstar));
  return __fadd_rn(y, __fmul_rn(__fmul_rn(__fmul_rn(s.eta, x), gr), m));
}

template <int W, int E>
__global__ void __launch_bounds__(kSortscanMaxThreads)
oga_step_sortscan_kernel(const float* __restrict__ y, const float* __restrict__ a,
                         const float* __restrict__ mask, const float* __restrict__ x,
                         const float* __restrict__ kstar, const float* __restrict__ scal,
                         float* __restrict__ out, int n, int L, int row_block) {
  constexpr int Q = E / 2;
  const SortscanRow r = sortscan_row<W>(row_block, n);
  // every lane runs to the end: rows past n hold no port and store nothing
  const StepScalars s = r.valid ? step_scalars(scal, r.row) : StepScalars{0, 0, 0, 0, 0};
  float z[Q], al[Q], ml[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    z[q] = al[q] = ml[q] = 0.0f;
    if (r.valid && l < L) {
      const long long idx = r.row * L + l;
      al[q] = a[idx];
      ml[q] = mask[idx];
      z[q] = ascend(s, y[idx], ml[q], x[idx], kstar[idx]);
    }
  }
  bool need;
  const double tau = water_level<W, E>(z, al, ml, s.c, r.j, L, r.valid, &need);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    if (r.valid && l < L) out[r.row * L + l] = water_fill(z[q], al[q], ml[q], tau, need);
  }
}

template <int W, int Q>
__global__ void __launch_bounds__(kSortscanMaxThreads)
oga_step_bisect_kernel(const float* __restrict__ y, const float* __restrict__ a,
                       const float* __restrict__ mask, const float* __restrict__ x,
                       const float* __restrict__ kstar, const float* __restrict__ scal,
                       float* __restrict__ out, int n, int L, int row_block, int iters) {
  const SortscanRow r = sortscan_row<W>(row_block, n);
  // every lane runs to the end: rows past n hold no port and store nothing
  const StepScalars s = r.valid ? step_scalars(scal, r.row) : StepScalars{0, 0, 0, 0, 0};
  BisectPorts<Q> p;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    p.z[q] = p.a[q] = p.m[q] = 0.0f;
    if (r.valid && l < L) {
      const long long idx = r.row * L + l;
      p.a[q] = a[idx];
      p.m[q] = mask[idx];
      p.z[q] = ascend(s, y[idx], p.m[q], x[idx], kstar[idx]);
    }
  }
  bool need;
  const float tau = bisect_water_level<W, Q>(p, s.c, iters, &need);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    if (r.valid && l < L) out[r.row * L + l] = bisect_fill(p.z[q], p.a[q], p.m[q], tau, need);
  }
}

template <int W, int E>
__global__ void __launch_bounds__(kSortscanMaxThreads)
proj_sortscan_kernel(const float* __restrict__ z, const float* __restrict__ a,
                     const float* __restrict__ mask, const float* __restrict__ c,
                     float* __restrict__ out, int n, int L, int row_block) {
  constexpr int Q = E / 2;
  const SortscanRow r = sortscan_row<W>(row_block, n);
  float zl[Q], al[Q], ml[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    const bool has = r.valid && l < L;
    const long long idx = r.row * L + l;
    zl[q] = has ? z[idx] : 0.0f;
    al[q] = has ? a[idx] : 0.0f;
    ml[q] = has ? mask[idx] : 0.0f;
  }
  bool need;
  const double tau = water_level<W, E>(zl, al, ml, r.valid ? c[r.row] : 0.0f, r.j,
                                                L, r.valid, &need);
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int l = r.j + W * q;
    if (r.valid && l < L) out[r.row * L + l] = water_fill(zl[q], al[q], ml[q], tau, need);
  }
}

// One block a row of kWideL < L <= kMaxL lanes (sortscan.cuh,
// wide_water_level): the fused step and the projection. A port is read
// (and its ascent computed) each time the water level asks for it, the
// same bits every time.
__global__ void __launch_bounds__(kWideThreads)
oga_step_sortscan_wide_kernel(const float* __restrict__ y, const float* __restrict__ a,
                              const float* __restrict__ mask, const float* __restrict__ x,
                              const float* __restrict__ kstar, const float* __restrict__ scal,
                              float* __restrict__ out, int L) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const long long row = blockIdx.x;
  const StepScalars s = step_scalars(scal, row);
  const auto port = [&](int l) {
    const long long idx = row * L + l;
    const float m = mask[idx];
    return WidePort{ascend(s, y[idx], m, x[idx], kstar[idx]), a[idx], m};
  };
  bool need;
  const double tau = wide_water_level(port, s.c, L, wide_smem, &need);
  for (int l = threadIdx.x; l < L; l += kWideThreads) {
    const WidePort p = port(l);
    out[row * L + l] = water_fill(p.z, p.a, p.m, tau, need);
  }
}

__global__ void __launch_bounds__(kWideThreads)
proj_sortscan_wide_kernel(const float* __restrict__ z, const float* __restrict__ a,
                          const float* __restrict__ mask, const float* __restrict__ c,
                          float* __restrict__ out, int L) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const long long row = blockIdx.x;
  const auto port = [&](int l) {
    const long long idx = row * L + l;
    return WidePort{z[idx], a[idx], mask[idx]};
  };
  bool need;
  const double tau = wide_water_level(port, c[row], L, wide_smem, &need);
  for (int l = threadIdx.x; l < L; l += kWideThreads) {
    const WidePort p = port(l);
    out[row * L + l] = water_fill(p.z, p.a, p.m, tau, need);
  }
}

// The dynamic shared memory of a wide launch, opting in above the 48 KiB a
// block gets without the attribute; the CUDA error of the attribute call
// (0 when accepted).
constexpr size_t kSmemBudget = 48 * 1024;

template <typename Kernel>
cudaError_t allow_wide_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kSmemBudget) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// An empty kernel: chip_smoke.py times it on a launch's grid as the floor
// under that launch.
__global__ void empty_kernel() {}

}  // namespace repro_torch

// Plain C interface, loaded with ctypes by kernels/_launch.py. Each returns
// the CUDA error of the launch (0 when it was accepted). `threads` is the
// threads of one row (kernels/autotune.py row_threads), the same for both
// methods: W (kWideThreads for a wide row); `row_block` the rows per block.
extern "C" int repro_oga_step(const float* y, const float* a, const float* mask,
                              const float* x, const float* kstar, const float* scal,
                              float* out, int n, int L, int threads, int row_block,
                              int method, int iters, void* stream) {
  using namespace repro_torch;
  const auto st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + row_block - 1) / row_block;
  if (!legal_sortscan_launch(n, L, threads, row_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (method == kSortscan) {
    if (L > kWideL) {
      const size_t smem = wide_smem_bytes(L);
      const cudaError_t err = allow_wide_smem(oga_step_sortscan_wide_kernel, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      oga_step_sortscan_wide_kernel<<<n, kWideThreads, smem, st>>>(y, a, mask, x, kstar, scal,
                                                                   out, L);
      return static_cast<int>(cudaGetLastError());
    }
    with_sortscan_layout(L, [&](auto w, auto e) {
      constexpr int W = decltype(w)::value, E = decltype(e)::value;
      oga_step_sortscan_kernel<W, E><<<blocks, sortscan_block_threads(W, row_block), 0, st>>>(
          y, a, mask, x, kstar, scal, out, n, L, row_block);
    });
  } else if (method == kBisect) {
    if (iters < 0 || iters > kMaxIters) return static_cast<int>(cudaErrorInvalidValue);
    with_bisect_layout(L, [&](auto w, auto q) {
      constexpr int W = decltype(w)::value, Q = decltype(q)::value;
      oga_step_bisect_kernel<W, Q><<<blocks, sortscan_block_threads(W, row_block), 0, st>>>(
          y, a, mask, x, kstar, scal, out, n, L, row_block, iters);
    });
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_proj_sortscan(const float* z, const float* a, const float* mask,
                                   const float* c, float* out, int n, int L, int threads,
                                   int row_block, void* stream) {
  using namespace repro_torch;
  if (!legal_sortscan_launch(n, L, threads, row_block)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (L > kWideL) {
    const size_t smem = wide_smem_bytes(L);
    const cudaError_t err = allow_wide_smem(proj_sortscan_wide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    proj_sortscan_wide_kernel<<<n, kWideThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        z, a, mask, c, out, L);
    return static_cast<int>(cudaGetLastError());
  }
  with_sortscan_layout(L, [&](auto w, auto e) {
    constexpr int W = decltype(w)::value, E = decltype(e)::value;
    proj_sortscan_kernel<W, E><<<(n + row_block - 1) / row_block,
                                 sortscan_block_threads(W, row_block), 0,
                                 static_cast<cudaStream_t>(stream)>>>(z, a, mask, c, out, n, L,
                                                                      row_block);
  });
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_empty_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > repro_torch::kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  repro_torch::empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
