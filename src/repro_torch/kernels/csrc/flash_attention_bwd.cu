// Gradient of causal GQA flash attention with a sliding window and a logit
// softcap: dq, dk and dv.
//
// Replaces no TPU kernel. The Pallas kernel src/repro/kernels/flash_attention.py
// (flash_attention, :64) has no backward: the JAX package trains through its
// jnp blockwise attention (src/repro/models/attention.py, attention) and
// takes this gradient by autodiff. The port's forward on the card is a
// hand-written kernel (flash_attention.cu), so its gradient is one too;
// models/attention.py wires both into one torch.autograd.Function.
//
// The function, for q (B, S, H, hd), k and v (B, S, G, hd), H = G * rep,
// query head h reading KV head h / rep, o the forward's output and dO the
// gradient of o:
//
//   s = (q k^T) hd^-0.5; with a softcap c, s_c = c tanh(s / c), else s_c = s
//   a key is visible when kpos <= qpos and, for window > 0,
//   qpos - kpos < window; masked entries contribute exactly zero
//   lse = log sum_visible exp(s_c),  P = exp(s_c - lse),  D = rowsum(dO o)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D) (1 - (s_c / c)^2)
//   dQ = dS K hd^-0.5,  dK = dS^T Q hd^-0.5
//
// with dK and dV summed over the rep query heads of each KV head. Every
// product runs in float32 (FFMA); bf16 inputs are widened as they are
// loaded and the gradients rounded once as they are stored.
//
// Bound on the H100. Five causal-halved products of 2 S^2/2 hd H B FLOPs
// each (QK^T, dO V^T, P^T dO, dS^T Q, dS K): at stablelm-3b's training
// shape (4, 4096, 32, 32, 80) 8.6e11 FLOPs, 0.87 ms at the bf16 tensor-core
// peak and 12.8 ms at the float32 FMA peak, far above the bytes (q, k, v,
// o, dO read once, dq, dk, dv written once: 0.03 ms in bf16). This simple
// kernel takes neither route to the bound: it recomputes QK^T three times
// and dO V^T twice (8 products, not 5) and runs every product on the CUDA
// cores; ROADMAP Queue 1 lists the wgmma/TMA redesign with a log-sum-exp
// written by the forward.
//
// Three kernels, launched in order on one stream by one C entry:
//
//   1. flash_bwd_stats_kernel, one block per (query tile, head, batch): each
//      row's lse by an online max and sum over its visible keys, from q and
//      k (the forward kernels do not write it), and D = sum_d dO o.
//   2. flash_bwd_dkdv_kernel, one block per (key tile, KV head, batch): it
//      holds its K and V tile and loops over the rep query heads of the KV
//      head and over the query tiles that can see the key tile (at or after
//      it, within the window), recomputing s and dP per tile; dK and dV
//      stay in registers and are written once.
//   3. flash_bwd_dq_kernel, one block per (query tile, head, batch): it
//      holds its Q and dO tile and loops over the visible key tiles.
//
// Tiles wholly outside the causal band or the window are skipped; inside a
// visited tile a masked entry gets p = 0 and dS = 0. No atomics: every
// gradient element is summed by one thread in a fixed order and written
// once, so two launches give the same bits.
//
// Layout. kBlockQ = kBlockK = 64 rows a tile, 256 threads as a 16 x 16
// grid (ty, tx). Tiles sit in shared memory as float rows of hd + 4 (the pad
// makes the eight rows of a quarter warp's float4 loads fall on distinct
// banks at every hd that is a multiple of 16). A score tile (s and dP) is
// computed as 4 x 4 microtiles: rows ty + 16 i, columns tx + 16 j, each a
// dot product over hd taken in float4 steps (8 FMAs a 16-byte load). P and
// dS go through shared memory (kernel 3 stores dS transposed), and the
// accumulating products are outer products over the tile's rows: a thread
// owns 4 consecutive rows (4 ty + i) of dK / dV / dQ and the column groups
// tx, tx + 16, ... of 4 floats. Shared memory at hd 128: kernel 2 holds K,
// V, Q, dO (132 KB), P and dS (34 KB); kernel 3 K, V, Q, dO and dS^T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace repro_torch {
namespace bwd {

using bf16 = __nv_bfloat16;

// Tile constants; kernels/autotune.py (FLASH_BWD_BLOCK_Q, FLASH_BWD_BLOCK_K,
// FLASH_BWD_THREADS) passes them to the C entry, which refuses others.
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kSide = 16;   // the thread grid is kSide x kSide
constexpr int kMicro = 4;   // a thread's microtile: kMicro x kMicro scores
constexpr int kPad = 4;     // floats past each shared-memory row
constexpr int kLdP = kBlockK + kPad;  // a row of P or dS (and of dS^T)
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kBlockQ == kSide * kMicro && kBlockK == kSide * kMicro, "tile = grid x microtile");
static_assert(kThreads == kSide * kSide, "one thread per (ty, tx)");
static_assert(kBlockQ == kBlockK, "P, dS and dS^T share one row length");

// Element strides of a (B, S, heads, hd) tensor; the hd stride is 1.
struct Strides {
  long long b, s, h;
};

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "hd: a multiple of 16 from 16 to 128");
  static constexpr int kLd = HD + kPad;                              // a tile row
  static constexpr int kGroups = HD / 4;                             // float4 column groups
  static constexpr int kGroupsPerThread = (kGroups + kSide - 1) / kSide;
  static constexpr int kTile = kBlockQ * kLd;                        // floats of one tile
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + kBlockQ) of one head of a (B, S, heads, hd) tensor into
// shared memory as float rows of kLd; rows at or past S read as zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, Strides st,
                                          int b, int head, int row0, int S) {
  const T* base = src + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int pos = row0 + r;
    dst[r * Dims<HD>::kLd + d] = pos < S ? to_f(base[pos * st.s + d]) : 0.0f;
  }
}

// A row statistic (lse or D) of rows [row0, row0 + kBlockQ) of one (b, h)
// into shared memory; rows at or past S read as 0.
__device__ __forceinline__ void load_stat(float* dst, const float* __restrict__ src,
                                          long long row_base, int row0, int S) {
  for (int r = threadIdx.x; r < kBlockQ; r += kThreads) {
    dst[r] = row0 + r < S ? src[row_base + row0 + r] : 0.0f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * Bt[tx + 16 j][d]: a 4 x 4 microtile of a
// product of two row-major tiles over hd, in float4 steps of d.
template <int HD>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bt, int ty, int tx,
                                         float acc[kMicro][kMicro]) {
  constexpr int ld = Dims<HD>::kLd;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
  }
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float4 a[kMicro], bt[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + kSide * i) * ld + d);
    }
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      bt[j] = *reinterpret_cast<const float4*>(Bt + (tx + kSide * j) * ld + d);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        float t = acc[i][j];
        t = fmaf(a[i].x, bt[j].x, t);
        t = fmaf(a[i].y, bt[j].y, t);
        t = fmaf(a[i].z, bt[j].z, t);
        t = fmaf(a[i].w, bt[j].w, t);
        acc[i][j] = t;
      }
    }
  }
}

// acc[i][4 m + c] += sum_r X[r][row0 + i] * Y[r][4 (tx + 16 m) + c] over the
// kBlockQ rows r: the outer-product accumulation of X^T Y, X a (kBlockQ x
// kLdP) tile whose columns row0 .. row0 + 3 (row0 = 4 ty) are this thread's
// output rows, Y a (kBlockQ x kLd) tile.
template <int HD>
__device__ __forceinline__ void accumulate_xty(const float* X, const float* Y, int ty, int tx,
                                               float acc[kMicro][4 * Dims<HD>::kGroupsPerThread]) {
  constexpr int ld = Dims<HD>::kLd;
  constexpr int kMG = Dims<HD>::kGroupsPerThread;
#pragma unroll 4
  for (int r = 0; r < kBlockQ; ++r) {
    const float4 x4 = *reinterpret_cast<const float4*>(X + r * kLdP + kMicro * ty);
    const float xs[kMicro] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int m = 0; m < kMG; ++m) {
      const int c0 = 4 * (tx + kSide * m);
      if (c0 < HD) {
        const float4 y4 = *reinterpret_cast<const float4*>(Y + r * ld + c0);
#pragma unroll
        for (int i = 0; i < kMicro; ++i) {
          acc[i][4 * m + 0] = fmaf(xs[i], y4.x, acc[i][4 * m + 0]);
          acc[i][4 * m + 1] = fmaf(xs[i], y4.y, acc[i][4 * m + 1]);
          acc[i][4 * m + 2] = fmaf(xs[i], y4.z, acc[i][4 * m + 2]);
          acc[i][4 * m + 3] = fmaf(xs[i], y4.w, acc[i][4 * m + 3]);
        }
      }
    }
  }
}

// Store this thread's rows row0 + 4 ty + i (those below S) of an
// accumulator as rows of one head of a (B, S, heads, hd) tensor.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, Strides st, int b, int head,
                                           int row0, int S, int ty, int tx,
                                           const float acc[kMicro][4 * Dims<HD>::kGroupsPerThread]) {
  T* base = dst + b * st.b + head * st.h;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int pos = row0 + kMicro * ty + i;
    if (pos >= S) continue;
#pragma unroll
    for (int m = 0; m < Dims<HD>::kGroupsPerThread; ++m) {
      const int c0 = 4 * (tx + kSide * m);
      if (c0 < HD) {
#pragma unroll
        for (int c = 0; c < 4; ++c) base[pos * st.s + c0 + c] = from_f<T>(acc[i][4 * m + c]);
      }
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S, int window) {
  return kpos <= qpos && qpos < S && (window <= 0 || qpos - kpos < window);
}

// s_c of a raw dot product, and its derivative d s_c / d s in *dcap
__device__ __forceinline__ float capped_score(float dot, float scale, float softcap, float* dcap) {
  const float s = dot * scale;
  if (softcap > 0.0f) {
    const float t = tanhf(s / softcap);
    *dcap = 1.0f - t * t;
    return softcap * t;
  }
  *dcap = 1.0f;
  return s;
}

// The key tiles a query tile from q0 visits: [first, last].
__device__ __forceinline__ int2 key_tiles(int q0, int S, int window) {
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = min(S, q0 + kBlockQ) - 1;
  return make_int2(k_lo / kBlockK, k_hi / kBlockK);
}

// ---------------------------------------------------------------- kernel 1
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ o, const T* __restrict__ dout, Strides sq,
                           Strides sk, Strides so, Strides sdo, float* __restrict__ lse,
                           float* __restrict__ dsum, int S, int H, int rep, int window,
                           float scale, float softcap) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + Dims<HD>::kTile;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;

  // D = sum_d dO o: warp w takes rows w, w + kWarps, ...
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kBlockQ && q0 + r < S; r += kWarps) {
    const int pos = q0 + r;
    const T* orow = o + b * so.b + pos * so.s + h * so.h;
    const T* drow = dout + b * sdo.b + pos * sdo.s + h * sdo.h;
    float acc = 0.0f;
    for (int d = lane; d < HD; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
    if (lane == 0) dsum[row_base + pos] = acc;
  }

  // lse: each thread keeps an online (max, sum) over its own columns
  load_rows<T, HD>(Qs, q, sq, b, h, q0, S);
  float m[kMicro], l[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  const int2 kts = key_tiles(q0, S, window);
  for (int kt = kts.x; kt <= kts.y; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the last tile's readers are done
    load_rows<T, HD>(Ks, k, sk, b, g, k0, S);
    __syncthreads();
    float s[kMicro][kMicro];
    dot_tile<HD>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        if (!visible(q0 + ty + kSide * i, k0 + tx + kSide * j, S, window)) continue;
        float dcap;
        const float c = capped_score(s[i][j], scale, softcap, &dcap);
        if (c > m[i]) {
          l[i] = l[i] * expf(m[i] - c) + 1.0f;
          m[i] = c;
        } else {
          l[i] += expf(c - m[i]);
        }
      }
    }
  }
  // combine the 16 threads of a row: the half warp of this ty
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float M = m[i];
#pragma unroll
    for (int off = kSide / 2; off; off >>= 1) M = fmaxf(M, __shfl_xor_sync(kFullMask, M, off));
    float L = m[i] == -INFINITY ? 0.0f : l[i] * expf(m[i] - M);
#pragma unroll
    for (int off = kSide / 2; off; off >>= 1) L += __shfl_xor_sync(kFullMask, L, off);
    const int pos = q0 + ty + kSide * i;
    if (tx == 0 && pos < S) lse[row_base + pos] = M + logf(L);
  }
}

// P and dS of one score microtile: p = exp(s_c - lse), ds = p (dP - D)
// (1 - (s_c / c)^2) hd^-0.5, both 0 on a masked entry.
__device__ __forceinline__ void grad_scores(const float s[kMicro][kMicro],
                                            const float dp[kMicro][kMicro], const float* lse_s,
                                            const float* d_s, int q0, int k0, int ty, int tx,
                                            int S, int window, float scale, float softcap,
                                            float p[kMicro][kMicro], float ds[kMicro][kMicro]) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int qi = ty + kSide * i;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      p[i][j] = 0.0f;
      ds[i][j] = 0.0f;
      if (visible(q0 + qi, k0 + tx + kSide * j, S, window)) {
        float dcap;
        const float c = capped_score(s[i][j], scale, softcap, &dcap);
        p[i][j] = expf(c - lse_s[qi]);
        ds[i][j] = p[i][j] * (dp[i][j] - d_s[qi]) * dcap * scale;
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 2
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout, Strides sq,
                          Strides sk, Strides sv, Strides sdo, const float* __restrict__ lse,
                          const float* __restrict__ dsum, T* __restrict__ dk,
                          T* __restrict__ dv, Strides sdk, Strides sdv, int S, int H, int rep,
                          int window, float scale, float softcap) {
  constexpr int kMG = Dims<HD>::kGroupsPerThread;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + Dims<HD>::kTile;
  float* Qs = Vs + Dims<HD>::kTile;
  float* dOs = Qs + Dims<HD>::kTile;
  float* Ps = dOs + Dims<HD>::kTile;
  float* dSs = Ps + kBlockQ * kLdP;
  float* lse_s = dSs + kBlockQ * kLdP;
  float* d_s = lse_s + kBlockQ;
  const int kt = blockIdx.x;  // key tile 0 sees the most query tiles: first
  const int g = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBlockK;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;

  load_rows<T, HD>(Ks, k, sk, b, g, k0, S);
  load_rows<T, HD>(Vs, v, sv, b, g, k0, S);
  float dk_acc[kMicro][4 * kMG], dv_acc[kMicro][4 * kMG];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * kMG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;
  }
  // the query tiles that see this key tile: positions k0 .. k0 + kBlockK -
  // 2 + window (window > 0), below S
  const int q_hi = window > 0 ? min(S - 1, k0 + kBlockK - 2 + window) : S - 1;
  for (int r = 0; r < rep; ++r) {
    const int h = g * rep + r;
    const long long row_base = (static_cast<long long>(b) * H + h) * S;
    for (int qt = k0 / kBlockQ; qt <= q_hi / kBlockQ; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the last tile's readers are done
      load_rows<T, HD>(Qs, q, sq, b, h, q0, S);
      load_rows<T, HD>(dOs, dout, sdo, b, h, q0, S);
      load_stat(lse_s, lse, row_base, q0, S);
      load_stat(d_s, dsum, row_base, q0, S);
      __syncthreads();
      float s[kMicro][kMicro], dp[kMicro][kMicro], p[kMicro][kMicro], ds[kMicro][kMicro];
      dot_tile<HD>(Qs, Ks, ty, tx, s);
      dot_tile<HD>(dOs, Vs, ty, tx, dp);
      grad_scores(s, dp, lse_s, d_s, q0, k0, ty, tx, S, window, scale, softcap, p, ds);
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          Ps[(ty + kSide * i) * kLdP + tx + kSide * j] = p[i][j];
          dSs[(ty + kSide * i) * kLdP + tx + kSide * j] = ds[i][j];
        }
      }
      __syncthreads();
      // dV += P^T dO, dK += dS^T Q: this thread's keys 4 ty + i
      accumulate_xty<HD>(Ps, dOs, ty, tx, dv_acc);
      accumulate_xty<HD>(dSs, Qs, ty, tx, dk_acc);
    }
  }
  store_rows<T, HD>(dk, sdk, b, g, k0, S, ty, tx, dk_acc);
  store_rows<T, HD>(dv, sdv, b, g, k0, S, ty, tx, dv_acc);
}

// ---------------------------------------------------------------- kernel 3
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout, Strides sq,
                        Strides sk, Strides sv, Strides sdo, const float* __restrict__ lse,
                        const float* __restrict__ dsum, T* __restrict__ dq, Strides sdq, int S,
                        int H, int rep, int window, float scale, float softcap) {
  constexpr int kMG = Dims<HD>::kGroupsPerThread;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + Dims<HD>::kTile;
  float* Ks = dOs + Dims<HD>::kTile;
  float* Vs = Ks + Dims<HD>::kTile;
  float* dSt = Vs + Dims<HD>::kTile;  // dS transposed: dSt[key][query]
  float* lse_s = dSt + kBlockK * kLdP;
  float* d_s = lse_s + kBlockQ;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, ty = tid / kSide, tx = tid % kSide;
  const long long row_base = (static_cast<long long>(b) * H + h) * S;

  load_rows<T, HD>(Qs, q, sq, b, h, q0, S);
  load_rows<T, HD>(dOs, dout, sdo, b, h, q0, S);
  load_stat(lse_s, lse, row_base, q0, S);
  load_stat(d_s, dsum, row_base, q0, S);
  float dq_acc[kMicro][4 * kMG];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int c = 0; c < 4 * kMG; ++c) dq_acc[i][c] = 0.0f;
  }
  const int2 kts = key_tiles(q0, S, window);
  for (int kt = kts.x; kt <= kts.y; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the last tile's readers are done
    load_rows<T, HD>(Ks, k, sk, b, g, k0, S);
    load_rows<T, HD>(Vs, v, sv, b, g, k0, S);
    __syncthreads();
    float s[kMicro][kMicro], dp[kMicro][kMicro], p[kMicro][kMicro], ds[kMicro][kMicro];
    dot_tile<HD>(Qs, Ks, ty, tx, s);
    dot_tile<HD>(dOs, Vs, ty, tx, dp);
    grad_scores(s, dp, lse_s, d_s, q0, k0, ty, tx, S, window, scale, softcap, p, ds);
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) dSt[(tx + kSide * j) * kLdP + ty + kSide * i] = ds[i][j];
    }
    __syncthreads();
    // dQ += dS K: this thread's queries 4 ty + i
    accumulate_xty<HD>(dSt, Ks, ty, tx, dq_acc);
  }
  store_rows<T, HD>(dq, sdq, b, h, q0, S, ty, tx, dq_acc);
}

// ---------------------------------------------------------------- launch
struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *dsum;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, S, H, G, window;
  float scale, softcap;
};

template <int HD>
constexpr int stats_smem() {
  return 2 * Dims<HD>::kTile * static_cast<int>(sizeof(float));
}
template <int HD>
constexpr int dkdv_smem() {
  return (4 * Dims<HD>::kTile + 2 * kBlockQ * kLdP + 2 * kBlockQ) * static_cast<int>(sizeof(float));
}
template <int HD>
constexpr int dq_smem() {
  return (4 * Dims<HD>::kTile + kBlockK * kLdP + 2 * kBlockQ) * static_cast<int>(sizeof(float));
}
static_assert(dkdv_smem<128>() <= 232448, "kernel 2's tiles exceed a block's shared memory");

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const auto k1 = flash_bwd_stats_kernel<T, HD>;
  const auto k2 = flash_bwd_dkdv_kernel<T, HD>;
  const auto k3 = flash_bwd_dq_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         stats_smem<HD>());
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<HD>());
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rep = a.H / a.G;
  const int nq = (a.S + kBlockQ - 1) / kBlockQ;
  const int nk = (a.S + kBlockK - 1) / kBlockK;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  k1<<<dim3(nq, a.H, a.B), kThreads, stats_smem<HD>(), stream>>>(
      q, k, o, dout, a.sq, a.sk, a.so, a.sdo, a.lse, a.dsum, a.S, a.H, rep, a.window, a.scale,
      a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<dim3(nk, a.G, a.B), kThreads, dkdv_smem<HD>(), stream>>>(
      q, k, v, dout, a.sq, a.sk, a.sv, a.sdo, a.lse, a.dsum, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sdk, a.sdv, a.S, a.H, rep, a.window, a.scale, a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(nq, a.H, a.B), kThreads, dq_smem<HD>(), stream>>>(
      q, k, v, dout, a.sq, a.sk, a.sv, a.sdo, a.lse, a.dsum, static_cast<T*>(a.dq), a.sdq, a.S,
      a.H, rep, a.window, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
#define REPRO_BWD_CASE(HD) \
  case HD:                 \
    return launch<T, HD>(a, stream);
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(48)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(80)
    REPRO_BWD_CASE(96)
    REPRO_BWD_CASE(112)
    REPRO_BWD_CASE(128)
#undef REPRO_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd
}  // namespace repro_torch

// The three kernels in order on `stream`: q, k, v, o, dout in, dq, dk, dv
// out (all of one type, bf16 when `is_bf16`, else float32), lse and dsum
// float32 scratch of B * H * S each. `strides` holds the (batch, seq,
// head) element strides of q, k, v, o, dout, dq, dk, dv in that order.
// Returns the first CUDA error, 0 when all three launched.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* dsum, int B, int S, int H,
                                         int G, int hd, int is_bf16, int block_q, int block_k,
                                         int threads, const long long* strides, int window,
                                         float scale, float softcap, void* stream) {
  using namespace repro_torch::bwd;
  if (block_q != kBlockQ || block_k != kBlockK || threads != kThreads || B < 1 || S < 1 ||
      G < 1 || H < G || H % G != 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(dsum),
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               B, S, H, G, window, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_hd<bf16>(a, hd, s) : launch_hd<float>(a, hd, s);
}
