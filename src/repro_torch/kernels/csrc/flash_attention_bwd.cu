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
// query head h reading KV head h / rep, o the forward's output, lse its
// row log-sum-exp (both forward kernels write it) and dO the gradient of o:
//
//   s = (q k^T) hd^-0.5; with a softcap c, s_c = c tanh(s / c), else s_c = s
//   a key is visible when kpos <= qpos and, for window > 0,
//   qpos - kpos < window; masked entries contribute exactly zero
//   P = exp(s_c - lse),  D = rowsum(dO o)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D) (1 - (s_c / c)^2)
//   dQ = dS K hd^-0.5,  dK = dS^T Q hd^-0.5
//
// with dK and dV summed over the rep query heads of each KV head.
//
// Bound on the H100. Five causal-halved products of 2 S^2/2 hd H B FLOPs
// each (QK^T, dO V^T, P^T dO, dS^T Q, dS K): at stablelm-3b's training
// shape (4, 4096, 32, 32, 80) 8.6e11 FLOPs, 0.87 ms at the bf16 tensor-core
// peak and 12.8 ms at the float32 FMA peak, far above the bytes (q, k, v,
// o, dO read once, dq, dk, dv written once: 0.03 ms in bf16).
//
// One C entry per dtype launches three kernels in order on one stream:
//
//   1. flash_bwd_dsum_kernel (both dtypes), one warp a row: D = sum_d dO o,
//      and the forward's lse times log2 e (lse2), into float32 scratch of
//      (B H, stat_s) each, stat_s = S rounded up to a whole 128-row tile,
//      the rows past S zero. Bound by bytes (reads o and dO once).
//   2. dK and dV, one block per (key tile, KV head, batch): it holds its K
//      and V tile and loops over the rep query heads of the KV head and the
//      query tiles that see the key tile (at or after it, within the
//      window); dK and dV stay in registers and are written once.
//   3. dQ, one block per (query tile, head, batch): it holds its Q and dO
//      tile and loops over the key tiles its rows see.
//
// bf16: kernels 2 and 3 on the tensor cores (namespace tc), fed by TMA, for
// sm_90a: the forward's machinery (flash_attention.cu) on the backward's
// seven products. A block is three warpgroups: a producer (one thread
// issues every load) and two consumers, setmaxnreg moving the producer's
// registers to them. The block's tile (kBlockRows = 128 keys for dK/dV,
// 128 queries for dQ) is loaded once; the streamed tiles of kTileRows = 64
// rows (Q and dO for dK/dV, K and V for dQ) go through a ring of kStages
// stages with a full and an empty mbarrier each, by cp.async.bulk.tensor
// on 4-D tensor maps (hd, S, heads, B) in boxes of 64 rows x 64 columns
// with the 128-byte swizzle (rows past S and columns past hd read as
// zero), the tile's lse2 and D rows by cp.async.bulk. Each consumer owns 64
// rows of the block's tile:
//   dK/dV: S^T = K Q^T and dP^T = V dO^T with its 64 keys as wgmma's M, so
//     their accumulators are in the register layout of a wgmma A operand;
//     P^T = 2^(c u - lse2) and dS^T = P^T (dP^T - D) (1 - u^2) in registers
//     (u = s hd^-0.5 log2 e / c, or tanh(s hd^-0.5 / softcap)), each
//     rounded once to bf16, as the forward rounds P; then dV += P^T dO and
//     dK += dS^T Q with dO and Q read MN-major through the transpose bit.
//   dQ: S = Q K^T and dP = dO V^T, dS in registers, dQ += dS K (K read
//     MN-major).
// Seven products where the gradient needs five (QK^T and dO V^T twice):
// every output element is summed by one warpgroup in a fixed order and
// written once, no atomics, so two launches give the same bits. The
// contractions over hd take hd / 16 k16 steps and the accumulators of dK,
// dV and dQ are hd wide (wgmma's N = hd): hd 80 does hd 80's work, its
// second 64-column box zero past column 80 and read in part. Whole tiles
// outside the causal band or the window are skipped (the consumer still
// frees its stage); the per-element mask runs only on tiles that cross the
// diagonal, the window's edge or S, and a masked entry gets P = 0 and
// dS = 0 exactly. The softcap's tanh is tanhf, accurate to float32: a warp
// whose arguments all lie below 0.6 takes its polynomial alone. Shared
// memory at hd 128: dK/dV K and V 64 KB + 2 stages x (Q + dO 32 KB + 512 B);
// dQ Q and dO 64 KB + 2 stages x (K + V 32 KB).
//
// float32: kernels 2 and 3 in FFMA on the CUDA cores (namespace ffma), the
// forward's lse in natural-log units read by plain loads. kBlockQ = kBlockK
// = 64 rows a tile, 256 threads as a 16 x 16 grid (ty, tx). Tiles sit in
// shared memory as float rows of hd + 4 (the pad makes the eight rows of a
// quarter warp's float4 loads fall on distinct banks at every hd that is a
// multiple of 16). A score tile (s and dP) is computed as 4 x 4
// microtiles: rows ty + 16 i, columns tx + 16 j, each a dot product over hd
// taken in float4 steps (8 FMAs a 16-byte load). P and dS go through shared
// memory (kernel 3 stores dS transposed), and the accumulating products are
// outer products over the tile's rows: a thread owns 4 consecutive rows
// (4 ty + i) of dK / dV / dQ and the column groups tx, tx + 16, ... of 4
// floats. Every gradient element is summed by one thread in a fixed order.
// Shared memory at hd 128: kernel 2 holds K, V, Q, dO (132 KB), P and dS
// (34 KB); kernel 3 K, V, Q, dO and dS^T.
#include "hopper.cuh"

#include <math.h>

namespace repro_torch {
namespace bwd {

using bf16 = __nv_bfloat16;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Element strides of a (B, S, heads, hd) tensor; the hd stride is 1.
struct Strides {
  long long b, s, h;
};

// What one backward call launches on: the operands, their strides, the
// shape and the function's constants.
struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // the forward's, (B, H, S), natural-log units
  void *dq, *dk, *dv;
  float *lse2, *dsum;  // scratch, (B H, stat_s) each
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, S, H, G, stat_s, window;
  float scale, softcap;
};

// ---------------------------------------------------------------- kernel 1
constexpr int kDsumThreads = 256;  // 8 warps, a row each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Row `row` of the (B H, stat_s) scratch: D = sum_d dO o and lse2 = lse
// log2 e for positions below S, zeros past S.
template <typename T>
__global__ void __launch_bounds__(kDsumThreads)
    flash_bwd_dsum_kernel(const T* __restrict__ o, const T* __restrict__ dout, Strides so,
                          Strides sdo, const float* __restrict__ lse, float* __restrict__ lse2,
                          float* __restrict__ dsum, int S, int H, int hd, int stat_s,
                          long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kDsumThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const long long bh = row / stat_s;
  const int pos = static_cast<int>(row - bh * stat_s);
  float acc = 0.0f;
  if (pos < S) {
    const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
    const T* orow = o + b * so.b + pos * so.s + h * so.h;
    const T* drow = dout + b * sdo.b + pos * sdo.s + h * sdo.h;
    for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
    for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(kFullMask, acc, off);
  }
  if (lane == 0) {
    dsum[row] = acc;
    lse2[row] = pos < S ? lse[bh * S + pos] * kLog2e : 0.0f;
  }
}

template <typename T>
int launch_dsum(const Args& a, int hd, cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(a.B) * a.H * a.stat_s;
  const long long blocks = (n_rows + kDsumThreads / 32 - 1) / (kDsumThreads / 32);
  flash_bwd_dsum_kernel<T><<<static_cast<unsigned>(blocks), kDsumThreads, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.so, a.sdo, a.lse, a.lse2,
      a.dsum, a.S, a.H, hd, a.stat_s, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: FFMA on the CUDA cores.
// ---------------------------------------------------------------------------
namespace ffma {

// Tile constants; kernels/autotune.py (FLASH_BWD_BLOCK_Q, FLASH_BWD_BLOCK_K,
// FLASH_BWD_THREADS) passes them to the C entry, which refuses others.
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kSide = 16;   // the thread grid is kSide x kSide
constexpr int kMicro = 4;   // a thread's microtile: kMicro x kMicro scores
constexpr int kPad = 4;     // floats past each shared-memory row
constexpr int kLdP = kBlockK + kPad;  // a row of P or dS (and of dS^T)
static_assert(kBlockQ == kSide * kMicro && kBlockK == kSide * kMicro, "tile = grid x microtile");
static_assert(kThreads == kSide * kSide, "one thread per (ty, tx)");
static_assert(kBlockQ == kBlockK, "P, dS and dS^T share one row length");

template <int HD>
struct Dims {
  static_assert(HD % 16 == 0 && HD >= 16 && HD <= 128, "hd: a multiple of 16 from 16 to 128");
  static constexpr int kLd = HD + kPad;                              // a tile row
  static constexpr int kGroups = HD / 4;                             // float4 column groups
  static constexpr int kGroupsPerThread = (kGroups + kSide - 1) / kSide;
  static constexpr int kTile = kBlockQ * kLd;                        // floats of one tile
};

// Rows [row0, row0 + kBlockQ) of one head of a (B, S, heads, hd) tensor into
// shared memory as float rows of kLd; rows at or past S read as zeros.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, Strides st,
                                          int b, int head, int row0, int S) {
  const float* base = src + b * st.b + head * st.h;
  for (int idx = threadIdx.x; idx < kBlockQ * HD; idx += kThreads) {
    const int r = idx / HD;
    const int d = idx - r * HD;
    const int pos = row0 + r;
    dst[r * Dims<HD>::kLd + d] = pos < S ? base[pos * st.s + d] : 0.0f;
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
template <int HD>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, Strides st, int b, int head,
                                           int row0, int S, int ty, int tx,
                                           const float acc[kMicro][4 * Dims<HD>::kGroupsPerThread]) {
  float* base = dst + b * st.b + head * st.h;
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int pos = row0 + kMicro * ty + i;
    if (pos >= S) continue;
#pragma unroll
    for (int m = 0; m < Dims<HD>::kGroupsPerThread; ++m) {
      const int c0 = 4 * (tx + kSide * m);
      if (c0 < HD) {
#pragma unroll
        for (int c = 0; c < 4; ++c) base[pos * st.s + c0 + c] = acc[i][4 * m + c];
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
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout, Strides sq,
                          Strides sk, Strides sv, Strides sdo, const float* __restrict__ lse,
                          const float* __restrict__ dsum, float* __restrict__ dk,
                          float* __restrict__ dv, Strides sdk, Strides sdv, int S, int H, int rep,
                          int stat_s, int window, float scale, float softcap) {
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

  load_rows<HD>(Ks, k, sk, b, g, k0, S);
  load_rows<HD>(Vs, v, sv, b, g, k0, S);
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
    const long long bh = static_cast<long long>(b) * H + h;
    for (int qt = k0 / kBlockQ; qt <= q_hi / kBlockQ; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();  // the last tile's readers are done
      load_rows<HD>(Qs, q, sq, b, h, q0, S);
      load_rows<HD>(dOs, dout, sdo, b, h, q0, S);
      load_stat(lse_s, lse, bh * S, q0, S);
      load_stat(d_s, dsum, bh * stat_s, q0, S);
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
  store_rows<HD>(dk, sdk, b, g, k0, S, ty, tx, dk_acc);
  store_rows<HD>(dv, sdv, b, g, k0, S, ty, tx, dv_acc);
}

// ---------------------------------------------------------------- kernel 3
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout, Strides sq,
                        Strides sk, Strides sv, Strides sdo, const float* __restrict__ lse,
                        const float* __restrict__ dsum, float* __restrict__ dq, Strides sdq, int S,
                        int H, int rep, int stat_s, int window, float scale, float softcap) {
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
  const long long bh = static_cast<long long>(b) * H + h;

  load_rows<HD>(Qs, q, sq, b, h, q0, S);
  load_rows<HD>(dOs, dout, sdo, b, h, q0, S);
  load_stat(lse_s, lse, bh * S, q0, S);
  load_stat(d_s, dsum, bh * stat_s, q0, S);
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
    load_rows<HD>(Ks, k, sk, b, g, k0, S);
    load_rows<HD>(Vs, v, sv, b, g, k0, S);
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
  store_rows<HD>(dq, sdq, b, h, q0, S, ty, tx, dq_acc);
}

// ---------------------------------------------------------------- launch
template <int HD>
constexpr int dkdv_smem() {
  return (4 * Dims<HD>::kTile + 2 * kBlockQ * kLdP + 2 * kBlockQ) * static_cast<int>(sizeof(float));
}
template <int HD>
constexpr int dq_smem() {
  return (4 * Dims<HD>::kTile + kBlockK * kLdP + 2 * kBlockQ) * static_cast<int>(sizeof(float));
}
static_assert(dkdv_smem<128>() <= 232448, "kernel 2's tiles exceed a block's shared memory");


template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  const auto k2 = flash_bwd_dkdv_kernel<HD>;
  const auto k3 = flash_bwd_dq_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<HD>());
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<HD>());
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rep = a.H / a.G;
  const int nq = (a.S + kBlockQ - 1) / kBlockQ;
  const int nk = (a.S + kBlockK - 1) / kBlockK;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  k2<<<dim3(nk, a.G, a.B), kThreads, dkdv_smem<HD>(), stream>>>(
      q, k, v, dout, a.sq, a.sk, a.sv, a.sdo, a.lse, a.dsum, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sdk, a.sdv, a.S, a.H, rep, a.stat_s, a.window, a.scale,
      a.softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k3<<<dim3(nq, a.H, a.B), kThreads, dq_smem<HD>(), stream>>>(
      q, k, v, dout, a.sq, a.sk, a.sv, a.sdo, a.lse, a.dsum, static_cast<float*>(a.dq), a.sdq,
      a.S, a.H, rep, a.stat_s, a.window, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// bf16: the tensor cores (wgmma), fed by TMA.
// ---------------------------------------------------------------------------
namespace tc {

using namespace hopper;

// Tile constants; kernels/autotune.py (FLASH_BWD_TC_BLOCK_ROWS,
// FLASH_BWD_TC_TILE_ROWS, FLASH_BWD_TC_STAGES) passes them to the C entry,
// which refuses others.
constexpr int kBlockRows = 128;  // a block's keys (dK/dV) or queries (dQ)
constexpr int kTileRows = 64;    // a streamed tile's queries (dK/dV) or keys (dQ)
constexpr int kStages = 2;       // streamed tiles in flight
constexpr int kWarpgroup = 128;
constexpr int kConsumers = kBlockRows / 64;  // warpgroups of 64 of the block's rows
constexpr int kThreads = kWarpgroup * (kConsumers + 1);  // + the producer's
// registers per thread after the hand-over (24 * 128 + 240 * 256 <= 65536)
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = 128;  // one swizzled row of a box: 64 bf16 columns
constexpr int kBoxRows = 64;    // rows of one TMA box
constexpr int kScores = kTileRows / 2;  // a thread's elements of a 64 x kTileRows score tile
static_assert(kConsumers == 2 && kBlockRows % kBoxRows == 0 && kTileRows == kBoxRows,
              "two consumers of 64 rows; a streamed tile is one box high");

constexpr int chunks_of(int hd) { return (hd + 63) / 64; }  // 64-column boxes of a row

// Dynamic shared memory of the dK/dV kernel: K and V (the block's keys),
// kStages stages of Q and dO (a streamed tile each) and of their lse2 and
// D rows, the mbarriers, and 1 KB to align the base to 1024 bytes.
template <int HD>
struct DkdvSmem {
  static constexpr int kChunks = chunks_of(HD);
  static constexpr int kKV = kBlockRows * kChunks * kRowBytes;  // the K or the V tile
  static constexpr int kQ = kTileRows * kChunks * kRowBytes;    // a Q or a dO tile
  static constexpr int kStats = 2 * kTileRows * 4;              // lse2 and D of a tile
  static constexpr int kBars = 1 + 2 * kStages;  // K/V full; full and empty per stage
  static constexpr int kBytes = 2 * kKV + kStages * (2 * kQ + kStats) + 8 * kBars + 1024;
};
// ... of the dQ kernel: Q and dO (the block's queries) with their lse2 and
// D rows, kStages stages of K and V (a streamed tile each), the mbarriers.
template <int HD>
struct DqSmem {
  static constexpr int kChunks = chunks_of(HD);
  static constexpr int kQ = kBlockRows * kChunks * kRowBytes;  // the Q or the dO tile
  static constexpr int kKV = kTileRows * kChunks * kRowBytes;  // a K or a V tile
  static constexpr int kStats = 2 * kBlockRows * 4;            // lse2 and D of the queries
  static constexpr int kBars = 1 + 2 * kStages;  // Q/dO full; full and empty per stage
  static constexpr int kBytes = 2 * kQ + kStats + kStages * 2 * kKV + 8 * kBars + 1024;
};
static_assert(DkdvSmem<128>::kBytes <= 232448 && DqSmem<128>::kBytes <= 232448,
              "a block's tiles exceed its shared memory");

// `rows` rows of one head from row0 into a tile of kChunks chunks of rows x
// 128 bytes, one box of kBoxRows rows at a time
template <int kChunks>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                          int rows, int row0, int head, int b) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    for (int r = 0; r < rows; r += kBoxRows) {
      tma_load(dst + (c * rows + r) * kRowBytes, map, bar, 64 * c, row0 + r, head, b);
    }
  }
}

// D (64 x kTileRows, float32) = A B^T over the head dim: A 64 rows of a
// tile of a_rows rows, B a streamed tile, both K-major (hd contiguous).
template <int HD>
__device__ __forceinline__ void score_gemm(float (&d)[kScores], uint32_t a, int a_rows,
                                           uint32_t bt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    const uint64_t da = make_desc(a + (kk >> 2) * a_rows * kRowBytes + col, 16, 1024);
    const uint64_t db = make_desc(bt + (kk >> 2) * kTileRows * kRowBytes + col, 16, 1024);
    wgmma_ss_k<kTileRows>(d, da, db, kk > 0);
  }
}

// acc (64 x HD, float32) += A B: A (64 x kTileRows) bf16 in registers (a
// score tile's accumulator layout packed in pairs), B a streamed tile of
// kTileRows rows read MN-major (the transpose bit).
template <int HD>
__device__ __forceinline__ void acc_gemm(float (&acc)[HD / 2], const uint32_t (&a)[kScores / 2],
                                         uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk) {
    const uint64_t db = make_desc(b + kk * 16 * kRowBytes, kTileRows * kRowBytes, 1024);
    const uint32_t(&ak)[4] = *reinterpret_cast<const uint32_t(*)[4]>(&a[4 * kk]);
    wgmma_rs_mn<HD>(acc, ak, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pair);
}

// P and dS of a 64 x kTileRows score tile, from s (the raw dot products)
// and dp, in the accumulator layout: element i of this thread is row
// row + 8 ((i >> 1) & 1), column col0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1).
// kKeyRows: rows are keys and columns queries (dK/dV), lse2 and dsum are
// the tile's and indexed by column; else rows are queries and columns keys
// (dQ), lse2 and dsum point at this thread's first row (the second 8 on).
// u = tanh(s mul) with a softcap, else s; p = 2^(c u - lse2); dS =
// p (dp - D) (1 - u^2 with a softcap); with kMasked an entry outside the
// mask gets p = dS = 0. Both are packed in pairs as bf16 (p only with kP),
// the A operand of the next product.
template <bool kKeyRows, bool kMasked, bool kP>
__device__ __forceinline__ void score_grads(float (&s)[kScores], const float (&dp)[kScores],
                                            uint32_t (&p16)[kScores / 2],
                                            uint32_t (&ds16)[kScores / 2],
                                            const float* __restrict__ lse2,
                                            const float* __restrict__ dsum, int row, int col0,
                                            int S, int window, bool capped, float mul, float c) {
  const int lane = threadIdx.x & 31;
  if (capped) {
    // u = tanh(s mul), accurate to float32: a warp whose arguments all lie
    // below 0.6 takes tanhf's polynomial alone; any other warp calls tanhf
    float most = 0.0f;
#pragma unroll
    for (int i = 0; i < kScores; ++i) {
      s[i] *= mul;
      most = fmaxf(most, fabsf(s[i]));
    }
    if (__all_sync(kFullMask, most < 0.6f)) {
#pragma unroll
      for (int i = 0; i < kScores; ++i) s[i] = tanh_small(s[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kScores; ++i) s[i] = tanhf(s[i]);
    }
  }
#pragma unroll
  for (int j = 0; j < kScores / 2; ++j) {
    float p[2], ds[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * j + e;
      const int r = row + 8 * ((i >> 1) & 1);
      const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const int at = kKeyRows ? col : 8 * ((i >> 1) & 1);
      const float u = s[i];
      p[e] = exp2_ftz(fmaf(u, c, -lse2[at]));
      const float dcap = capped ? fmaf(-u, u, 1.0f) : 1.0f;
      ds[e] = p[e] * (dp[i] - dsum[at]) * dcap;
      if constexpr (kMasked) {
        const int key = kKeyRows ? r : col0 + col;
        const int query = kKeyRows ? col0 + col : r;
        const bool in = key <= query && query < S && (window <= 0 || query - key < window);
        p[e] = in ? p[e] : 0.0f;
        ds[e] = in ? ds[e] : 0.0f;
      }
    }
    if constexpr (kP) p16[j] = pack_bf16(p[0], p[1]);
    ds16[j] = pack_bf16(ds[0], ds[1]);
  }
}

// rows row and row + 8 (those below S) of a 64 x HD accumulator, times mul,
// as bf16 pairs into one head (head_base) of a (B, S, heads, hd) tensor
template <int HD>
__device__ __forceinline__ void store_acc(const float (&acc)[HD / 2], float mul, bf16* head_base,
                                          long long row_stride, int row, int S) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n8 = 0; n8 < HD / 8; ++n8) {
    const int col = 8 * n8 + 2 * (lane & 3);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = row + 8 * r;
      if (pos < S) {
        *reinterpret_cast<uint32_t*>(head_base + pos * row_stride + col) =
            pack_bf16(acc[4 * n8 + 2 * r] * mul, acc[4 * n8 + 2 * r + 1] * mul);
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 2
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse2, const float* __restrict__ dsum,
                                bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
                                Strides sdv, int S, int H, int rep, int stat_s, int window,
                                bool capped, float mul, float c, float scale) {
  using L = DkdvSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_tile = align_1024(smem_raw);
  uint8_t* v_tile = k_tile + L::kKV;
  uint8_t* qdo = v_tile + L::kKV;  // stage st: Q at 2 st kQ, dO at (2 st + 1) kQ
  // stage st: lse2 at 2 st kTileRows floats, D at (2 st + 1) kTileRows
  float* stats = reinterpret_cast<float*>(qdo + 2 * kStages * L::kQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * kStages * kTileRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kBlockRows;  // key tile 0 sees the most query tiles: first
  const int g = blockIdx.y, b = blockIdx.z;
  // the query tiles some key of the block sees: from the one holding k0 to
  // the one holding the last position within the window, below S; for each
  // of the rep query heads, in that order
  const int q_last = window > 0 ? min(S - 1, k0 + kBlockRows - 2 + window) : S - 1;
  const int qt0 = k0 / kTileRows;
  const int n_qt = q_last / kTileRows - qt0 + 1;
  const int n_tiles = rep * n_qt;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: one thread loads K and V, then keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
      load_tile<L::kChunks>(k_tile, &tm_k, kv_full, kBlockRows, k0, g, b);
      load_tile<L::kChunks>(v_tile, &tm_v, kv_full, kBlockRows, k0, g, b);
      for (int u = 0; u < n_tiles; ++u) {
        const int st = u % kStages;
        const int h = g * rep + u / n_qt;
        const int q0 = (qt0 + u % n_qt) * kTileRows;
        const long long at = (static_cast<long long>(b) * H + h) * stat_s + q0;
        // a fresh barrier counts its phase before the first as complete
        mbar_wait(&empty[st], ((u / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kQ + 2 * kTileRows * 4);
        load_tile<L::kChunks>(qdo + 2 * st * L::kQ, &tm_q, &full[st], kTileRows, q0, h, b);
        load_tile<L::kChunks>(qdo + (2 * st + 1) * L::kQ, &tm_do, &full[st], kTileRows, q0, h, b);
        bulk_load(stats + 2 * st * kTileRows, lse2 + at, kTileRows * 4, &full[st]);
        bulk_load(stats + (2 * st + 1) * kTileRows, dsum + at, kTileRows * 4, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int kw0 = k0 + 64 * w;  // this warpgroup's first key
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int key = kw0 + 16 * warp + lane / 4;  // this thread's keys: key, key + 8
    const uint32_t k_rows = smem_u32(k_tile) + 64 * w * kRowBytes;
    const uint32_t v_rows = smem_u32(v_tile) + 64 * w * kRowBytes;
    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
    mbar_wait(kv_full, 0);
    for (int u = 0; u < n_tiles; ++u) {
      const int st = u % kStages;
      const int q0 = (qt0 + u % n_qt) * kTileRows;
      mbar_wait(&full[st], (u / kStages) & 1);
      // a tile none of this warpgroup's keys sees is skipped
      if (kw0 < S && kw0 <= q0 + kTileRows - 1 &&
          (window <= 0 || q0 - (kw0 + 63) < window)) {
        const uint32_t q_rows = smem_u32(qdo + 2 * st * L::kQ);
        const uint32_t do_rows = q_rows + L::kQ;
        const float* tile_lse2 = stats + 2 * st * kTileRows;
        const float* tile_dsum = tile_lse2 + kTileRows;
        float s[kScores], dp[kScores];
        score_gemm<HD>(s, k_rows, kBlockRows, q_rows);   // S^T = K Q^T
        score_gemm<HD>(dp, v_rows, kBlockRows, do_rows);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        uint32_t p16[kScores / 2], ds16[kScores / 2];
        const bool whole = kw0 + 63 <= q0 && q0 + kTileRows <= S &&
                           (window <= 0 || q0 + kTileRows - 1 - kw0 < window);
        if (whole) {
          score_grads<true, false, true>(s, dp, p16, ds16, tile_lse2, tile_dsum, key, q0, S,
                                         window, capped, mul, c);
        } else {
          score_grads<true, true, true>(s, dp, p16, ds16, tile_lse2, tile_dsum, key, q0, S,
                                        window, capped, mul, c);
        }
        acc_gemm<HD>(dv_acc, p16, do_rows);  // dV += P^T dO
        acc_gemm<HD>(dk_acc, ds16, q_rows);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(p16);
        fence_regs(ds16);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    store_acc<HD>(dk_acc, scale, dk + b * sdk.b + g * sdk.h, sdk.s, key, S);
    store_acc<HD>(dv_acc, 1.0f, dv + b * sdv.b + g * sdv.h, sdv.s, key, S);
  }
}

// ---------------------------------------------------------------- kernel 3
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse2, const float* __restrict__ dsum,
                              bf16* __restrict__ dq, Strides sdq, int S, int H, int rep,
                              int stat_s, int window, bool capped, float mul, float c,
                              float scale) {
  using L = DqSmem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = align_1024(smem_raw);
  uint8_t* do_tile = q_tile + L::kQ;
  uint8_t* kv = do_tile + L::kQ;  // stage st: K at 2 st kKV, V at (2 st + 1) kKV
  float* stats = reinterpret_cast<float*>(kv + 2 * kStages * L::kKV);  // lse2, then D
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stats + 2 * kBlockRows);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockRows;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  // the key tiles some row of the block sees
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = min(S, q0 + kBlockRows) - 1;
  const int kt0 = k_lo / kTileRows;
  const int n_tiles = k_hi / kTileRows - kt0 + 1;
  const int wg = threadIdx.x / kWarpgroup;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      const long long at = (static_cast<long long>(b) * H + h) * stat_s + q0;
      mbar_expect_tx(q_full, 2 * L::kQ + 2 * kBlockRows * 4);
      load_tile<L::kChunks>(q_tile, &tm_q, q_full, kBlockRows, q0, h, b);
      load_tile<L::kChunks>(do_tile, &tm_do, q_full, kBlockRows, q0, h, b);
      bulk_load(stats, lse2 + at, kBlockRows * 4, q_full);
      bulk_load(stats + kBlockRows, dsum + at, kBlockRows * 4, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        const int k0 = (kt0 + t) * kTileRows;
        mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * L::kKV);
        load_tile<L::kChunks>(kv + 2 * st * L::kKV, &tm_k, &full[st], kTileRows, k0, g, b);
        load_tile<L::kChunks>(kv + (2 * st + 1) * L::kKV, &tm_v, &full[st], kTileRows, k0, g, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = wg - 1;
    const int qw0 = q0 + 64 * w;  // this warpgroup's first query
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int row = qw0 + 16 * warp + lane / 4;  // this thread's queries: row, row + 8
    const uint32_t q_rows = smem_u32(q_tile) + 64 * w * kRowBytes;
    const uint32_t do_rows = smem_u32(do_tile) + 64 * w * kRowBytes;
    const float* row_lse2 = stats + (row - q0);
    const float* row_dsum = row_lse2 + kBlockRows;
    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.0f;
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int k0 = (kt0 + t) * kTileRows;
      mbar_wait(&full[st], (t / kStages) & 1);
      // a tile none of this warpgroup's queries sees is skipped
      if (qw0 < S && k0 <= qw0 + 63 && (window <= 0 || qw0 - (k0 + kTileRows - 1) < window)) {
        const uint32_t k_rows = smem_u32(kv + 2 * st * L::kKV);
        const uint32_t v_rows = k_rows + L::kKV;
        float s[kScores], dp[kScores];
        score_gemm<HD>(s, q_rows, kBlockRows, k_rows);    // S = Q K^T
        score_gemm<HD>(dp, do_rows, kBlockRows, v_rows);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        uint32_t ds16[kScores / 2];
        const bool whole = k0 + kTileRows - 1 <= qw0 && k0 + kTileRows <= S && qw0 + 63 < S &&
                           (window <= 0 || qw0 + 63 - k0 < window);
        if (whole) {
          score_grads<false, false, false>(s, dp, ds16, ds16, row_lse2, row_dsum, row, k0, S,
                                           window, capped, mul, c);
        } else {
          score_grads<false, true, false>(s, dp, ds16, ds16, row_lse2, row_dsum, row, k0, S,
                                          window, capped, mul, c);
        }
        acc_gemm<HD>(dq_acc, ds16, k_rows);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(ds16);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    store_acc<HD>(dq_acc, scale, dq + b * sdq.b + h * sdq.h, sdq.s, row, S);
  }
}

template <int HD>
int launch(const Args& a, const long long* st, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int kCols = kRowBytes / 2;
  int err = make_map(&tm_q, kType, 2, kCols, a.q, HD, a.S, a.H, a.B, st, kBoxRows);
  if (err == 0) err = make_map(&tm_k, kType, 2, kCols, a.k, HD, a.S, a.G, a.B, st + 3, kBoxRows);
  if (err == 0) err = make_map(&tm_v, kType, 2, kCols, a.v, HD, a.S, a.G, a.B, st + 6, kBoxRows);
  if (err == 0) {
    err = make_map(&tm_do, kType, 2, kCols, a.dout, HD, a.S, a.H, a.B, st + 12, kBoxRows);
  }
  if (err != 0) return kEncoderErrorBase + err;
  const auto k2 = flash_bwd_dkdv_wgmma_kernel<HD>;
  const auto k3 = flash_bwd_dq_wgmma_kernel<HD>;
  cudaError_t attr = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          DkdvSmem<HD>::kBytes);
  if (attr == cudaSuccess) {
    attr = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                DqSmem<HD>::kBytes);
  }
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // a score in base 2 is c u, u = s or tanh(s mul) (score_grads)
  const bool capped = a.softcap > 0.0f;
  const float mul = capped ? a.scale / a.softcap : 1.0f;
  const float c = capped ? a.softcap * kLog2e : a.scale * kLog2e;
  const int rep = a.H / a.G;
  const int tiles = (a.S + kBlockRows - 1) / kBlockRows;
  k2<<<dim3(tiles, a.G, a.B), kThreads, DkdvSmem<HD>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse2, a.dsum, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sdk, a.sdv, a.S, a.H, rep, a.stat_s, a.window, capped, mul, c,
      a.scale);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  k3<<<dim3(tiles, a.H, a.B), kThreads, DqSmem<HD>::kBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse2, a.dsum, static_cast<bf16*>(a.dq), a.sdq, a.S, a.H, rep,
      a.stat_s, a.window, capped, mul, c, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace bwd
}  // namespace repro_torch

// The plain C interfaces, loaded with ctypes by kernels/flash_attention.py.
// Each launches the three kernels in order on `stream`: q, k, v, o, dout
// in, of one type (bf16 for repro_flash_attention_bwd_bf16, float32 for
// repro_flash_attention_bwd), dq, dk, dv out in the same; lse the forward's
// float32 (B, H, S); lse2 and dsum float32 scratch of B * H * stat_s each,
// stat_s >= S a multiple of the bf16 kernels' 128-row block. `strides`
// holds the (batch, seq, head) element strides of q, k, v, o, dout, dq, dk,
// dv in that order. Returns the first CUDA error (0 when all three
// launched), or kEncoderErrorBase + the tensor-map encoder's.

namespace {
bool bwd_shape_ok(int B, int S, int H, int G, int hd, int stat_s) {
  using repro_torch::bwd::tc::kBlockRows;
  return B >= 1 && S >= 1 && G >= 1 && H >= G && H % G == 0 && B <= 65535 && H <= 65535 &&
         hd >= 16 && hd <= 128 && hd % 16 == 0 && stat_s >= S && stat_s % kBlockRows == 0;
}

repro_torch::bwd::Args bwd_args(const void* q, const void* k, const void* v, const void* o,
                                const void* lse, const void* dout, void* dq, void* dk, void* dv,
                                void* lse2, void* dsum, int B, int S, int H, int G, int stat_s,
                                const long long* strides, int window, float scale,
                                float softcap) {
  using repro_torch::bwd::Strides;
  Strides st[8];
  for (int i = 0; i < 8; ++i) {
    st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  return {q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
          static_cast<float*>(lse2), static_cast<float*>(dsum),
          st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
          B, S, H, G, stat_s, window, scale, softcap};
}
}  // namespace

// float32: the D pass, then the FFMA kernels
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* lse, const void* dout,
                                         void* dq, void* dk, void* dv, void* lse2, void* dsum,
                                         int B, int S, int H, int G, int hd, int block_q,
                                         int block_k, int threads, int stat_s,
                                         const long long* strides, int window, float scale,
                                         float softcap, void* stream) {
  using namespace repro_torch::bwd;
  if (block_q != ffma::kBlockQ || block_k != ffma::kBlockK || threads != ffma::kThreads ||
      !bwd_shape_ok(B, S, H, G, hd, stat_s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = bwd_args(q, k, v, o, lse, dout, dq, dk, dv, lse2, dsum, B, S, H, G, stat_s,
                          strides, window, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_dsum<float>(a, hd, s);
  if (err != 0) return err;
  switch (hd) {
#define REPRO_BWD_CASE(HD) \
  case HD:                 \
    return ffma::launch<HD>(a, s);
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

// bf16: the D pass, then the tensor-core kernels
extern "C" int repro_flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                              const void* o, const void* lse, const void* dout,
                                              void* dq, void* dk, void* dv, void* lse2,
                                              void* dsum, int B, int S, int H, int G, int hd,
                                              int block_rows, int tile_rows, int stages,
                                              int stat_s, const long long* strides, int window,
                                              float scale, float softcap, void* stream) {
  using namespace repro_torch::bwd;
  if (block_rows != tc::kBlockRows || tile_rows != tc::kTileRows || stages != tc::kStages ||
      !bwd_shape_ok(B, S, H, G, hd, stat_s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a = bwd_args(q, k, v, o, lse, dout, dq, dk, dv, lse2, dsum, B, S, H, G, stat_s,
                          strides, window, scale, softcap);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = launch_dsum<bf16>(a, hd, s);
  if (err != 0) return err;
  switch (hd) {
#define REPRO_BWD_CASE(HD) \
  case HD:                 \
    return tc::launch<HD>(a, strides, s);
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
