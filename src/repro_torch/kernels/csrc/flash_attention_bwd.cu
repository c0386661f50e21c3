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
// peak and 12.8 ms at the float32 FMA peak (the kernels run seven
// products, QK^T and dO V^T twice: 17.9 ms in FFMA), far above the bytes
// (q, k, v, o, dO read once, dq, dk, dv written once: 0.03 ms in bf16).
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
//   3. dQ, one block per (query tile, head, batch) in bf16, per packed
//      tile of the rep query heads of a KV head in float32: it holds its Q
//      and dO rows and loops over the key tiles its rows see.
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
// float32: kernels 2 and 3 in FFMA on the CUDA cores (namespace ffma), on
// the float32 forward's design (flash_attention.cu, namespace f32): register
// microtiles fed by a TMA ring, warps that own their rows, no block barrier
// in the tile loop. A block is 8 warps (256 threads) over kBlockRows = 128
// rows of its own tile, loaded once; the streamed tiles of kTileRows = 64
// rows go through a ring of ring_of(hd) stages by cp.async.bulk.tensor on
// 4-D tensor maps (hd, S, heads, B) in boxes of 32 float32 columns x 64 rows
// with the 128-byte swizzle (rows past S and columns past hd read as zero),
// each operand with a full and an empty mbarrier a stage. Thread 0 issues
// every load (a ninth, producer warp would cap a thread's registers below
// what the two accumulators need) and asks for tile t + 1 in turn t: with
// two stages as the turn starts, with one as soon as every warp is done
// with tile t's operand, each operand's last use in a turn placed one
// product before its first use in the next. A warp owns 16 rows; a thread
// holds an 8 x 4 score microtile (block rows row0 + 2 i, streamed rows
// cl + 16 t; 16 shared-memory wavefronts a warp per 128 FMAs, every load
// conflict-free in the swizzled boxes; the chunk loop left rolled) and the
// same 8 rows of its accumulators in hd / 16 columns (float4 groups, then a
// float2 and a float one: at hd 80 every lane holds a float4 and a float,
// 5 columns). Each warp passes its P^T, dS^T or dS
// through its own 16 x 64 tile in shared memory, synced by __syncwarp, into
// the accumulating product (the forward's P V).
//   dK/dV, one block per (128 keys, KV head, batch): keys take the
//     forward's query role. Per streamed tile of 64 queries (for each of the
//     rep query heads of the KV head, the query tiles that see the block):
//     S^T = K Q^T, u (the softcap's tanh on the forward's terms) kept in the
//     lane's own slots of the warp tile; dP^T = V dO^T; P^T = 2^(c u - lse2)
//     and dS^T = P^T (dP^T - D) (1 - u^2) once per pair; dK += dS^T Q
//     through the warp tile (Q's last use: its stage is freed); dV += P^T
//     dO (dO's). lse2 and D of the tile come with Q and dO by
//     cp.async.bulk from the D pass's scratch.
//   dQ, one block per 128 query rows packed as the forward packs them
//     ((position, head) of the rep query heads of a KV head, f32_layout),
//     so each K/V tile is read once for all of them; Q and dO loaded by
//     each warp for its rows (plain loads into the swizzled layout), lse2
//     and D in registers. Per K/V tile: dP = dO V^T (V freed), S = Q K^T,
//     dS, dQ += dS K (K freed).
// A warp skips the products of a tile none of its rows sees (it still
// waits for the tile and frees it); the per-element mask runs only on tiles
// that cross the diagonal, the window's edge or S. Both grids put the row
// block in their slowest dimension, so the blocks with the most tiles start
// first on every head. Seven products, every output element summed by one
// thread in a fixed order and written once.
// Budget, at hd 80 (three boxes a row, the last read in part) with two
// stages: dK/dV K and V 96 KB + 2 x (Q and dO 48 KB + 512 B) + 8 warp tiles
// 32 KB = 231496 bytes with the barriers and the alignment, dQ 230464; at
// hd 112 and 128 (four boxes) two stages would need 256 KB, so one stage:
// dK/dV 128 KB + 64.5 KB + 32 KB = 230952 bytes, dQ 230432. Registers: dK
// and dV take 2 x 8 x hd / 16 = hd a thread (128 at hd 128); dP^T is
// computed while u waits in shared memory, so a score microtile (32), its
// operands (48) and the accumulators are the most live at once; P^T (32)
// is held through dK's product. ptxas gives dK/dV 168 (hd 16 and 32) to 230
// (hd 80) and 255 (hd 112, 128) registers and dQ 214 to 255, none spilling
// (chip_smoke.py's build line holds the counts and refuses a spill or any
// local memory); unrolling the score products' chunk loop made dK/dV spill
// at hd 128 (tools/flash_ablation.py --bwd's variants).
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
// float32: FFMA on register microtiles, fed by a TMA ring.
// ---------------------------------------------------------------------------
namespace ffma {

using hopper::align_1024;
using hopper::bulk_load;
using hopper::exp2_ftz;
using hopper::Layout;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::Rows;
using hopper::swizzled;
using hopper::tanh_capped;
using hopper::tma_load;

// Tile constants; kernels/autotune.py (FLASH_BWD_BLOCK_ROWS,
// FLASH_BWD_TILE_ROWS, FLASH_BWD_STAGES, FLASH_BWD_MICRO_ROWS,
// FLASH_BWD_MICRO_COLS) passes them to the C entry, which refuses others.
constexpr int kBlockRows = 128;  // a block's keys (dK/dV) or packed query rows (dQ)
constexpr int kTileRows = 64;    // a streamed tile's queries (dK/dV) or keys (dQ)
constexpr int kMaxRing = 2;      // streamed tiles in flight, where they fit (ring_of)
constexpr int kMicroRows = 8;    // block rows of a thread's score microtile and accumulators
constexpr int kMicroCols = 4;    // streamed rows of its score microtile
constexpr int kHalf = 16;        // threads that share a block row: a half warp
constexpr int kWarpRows = 2 * kMicroRows;           // block rows of a warp
constexpr int kWarps = kBlockRows / kWarpRows;      // 8, two on each SM sub-partition
constexpr int kThreads = 32 * kWarps;
constexpr int kRowBytes = hopper::kSwizzleRow;     // one swizzled row of a box
constexpr int kBoxCols = hopper::kF32BoxCols;       // float32 columns of a box
constexpr int kBlockBox = kBlockRows * kRowBytes;   // one box of a block's tile
constexpr int kTileBox = kTileRows * kRowBytes;     // one box of a streamed tile
constexpr int kWRow = kTileRows * 4;                // a row of a warp's tile, in bytes
constexpr int kWarpTile = kWarpRows * kWRow;        // a warp's P^T / dS^T (dS) tile
constexpr int kSmemMax = 232448;                    // what a block may opt in to
static_assert(kHalf * kMicroCols == kTileRows, "a half warp holds a streamed tile's rows");
static_assert(kMicroRows == 8, "row positions pack into two words of bytes");
static_assert(kWarpTile == kMicroRows * 32 * 16, "a warp's tile holds a float4 a lane a row");

// Dynamic shared memory. dK/dV: K and V (the block's keys), `ring` stages
// of Q and dO (a streamed tile each) and of their lse2 and D rows, a tile
// per warp, the mbarriers (K/V full; Q full and empty, dO full and empty
// per stage). dQ: Q and dO (the block's rows), `ring` stages of K and V,
// a tile per warp, the mbarriers (K full and empty, V full and empty per
// stage). Both add 1 KB to align the base to the 1024 bytes the swizzle
// pattern repeats over. Tiles are boxes of kBoxCols columns (128-byte
// rows), the last one zero past hd.
__host__ __device__ constexpr int boxes_of(int hd) { return (hd + kBoxCols - 1) / kBoxCols; }
__host__ __device__ constexpr int dkdv_bytes(int hd, int ring) {
  return 2 * boxes_of(hd) * kBlockBox + ring * (2 * boxes_of(hd) * kTileBox + 2 * kTileRows * 4) +
         kWarps * kWarpTile + 8 * (1 + 4 * ring) + 1024;
}
__host__ __device__ constexpr int dq_bytes(int hd, int ring) {
  return 2 * boxes_of(hd) * kBlockBox + ring * 2 * boxes_of(hd) * kTileBox + kWarps * kWarpTile +
         8 * 4 * ring + 1024;
}
// two stages where both kernels' tiles fit (hd <= 96), else one
__host__ __device__ constexpr int ring_of(int hd) {
  return dkdv_bytes(hd, kMaxRing) <= kSmemMax && dq_bytes(hd, kMaxRing) <= kSmemMax ? kMaxRing : 1;
}
static_assert(ring_of(96) == 2 && ring_of(112) == 1, "two stages fit up to hd 96");
static_assert(dkdv_bytes(128, ring_of(128)) <= kSmemMax && dq_bytes(128, ring_of(128)) <= kSmemMax,
              "hd 128 must fit the 227 KB a block may opt in to");

// The accumulator columns of a thread: hd / 16 of them, in groups of which
// each of a half warp's 16 lanes takes vec(g) neighbours: float4 groups
// while four columns a lane are left, then a float2 group, then a float one
// (hd 80: columns 4 cl .. 4 cl + 3 and 64 + cl), so a half warp's loads of
// one streamed row are 16 neighbouring vectors, each inside one 16-byte
// chunk, and no group overruns the 16 lanes. Group g fills slots slot(g) ..
// slot(g) + vec(g) - 1 of the thread's hd / 16.
template <int HD>
struct Cols {
  static constexpr int kPer = HD / kHalf;
  static constexpr int kQuads = kPer / 4, kPairs = kPer % 4 / 2;
  static constexpr int kGroups = kQuads + kPairs + kPer % 2;
  __host__ __device__ static constexpr int vec(int g) {
    return g < kQuads ? 4 : (g < kQuads + kPairs ? 2 : 1);
  }
  __host__ __device__ static constexpr int slot(int g) {
    return g <= kQuads ? 4 * g : 4 * kQuads + 2 * kPairs;
  }
  // lane cl's first column of group g
  __host__ __device__ static constexpr int col(int g, int cl) {
    return kHalf * slot(g) + vec(g) * cl;
  }
};

// X (8 rows x 4 columns) += A B^T over `kChunks` 4-column chunks of one box:
// A a block tile, row i of the thread at a_rows + 2 i rows (swizzle
// (rg + 2 i) % 8); B a streamed tile, column t of the thread at row
// cl + 16 t (b_rows + 16 t rows, swizzle kx = cl % 8).
// The chunk loop is not unrolled: unrolled by 2, 4 or 8, ptxas hoists the
// next chunks' loads until the dK/dV kernel at hd 128 spills, and it ran
// slower (tools/flash_ablation.py --bwd's variants).
template <int kChunks>
__device__ __forceinline__ void dot_box(float (&x)[kMicroRows][kMicroCols], const uint8_t* a_rows,
                                        const uint8_t* b_rows, int rg, int kx) {
#pragma unroll 1
  for (int ch = 0; ch < kChunks; ++ch) {
    float4 af[kMicroRows], bf[kMicroCols];
#pragma unroll
    for (int i = 0; i < kMicroRows; ++i) {
      af[i] = *reinterpret_cast<const float4*>(a_rows + 2 * i * kRowBytes +
                                               ((ch ^ ((rg + 2 * i) & 7)) << 4));
    }
#pragma unroll
    for (int t = 0; t < kMicroCols; ++t) {
      bf[t] = *reinterpret_cast<const float4*>(b_rows + kHalf * t * kRowBytes + ((ch ^ kx) << 4));
    }
#pragma unroll
    for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
      for (int t = 0; t < kMicroCols; ++t) {
        x[i][t] = fmaf(af[i].x, bf[t].x, x[i][t]);
        x[i][t] = fmaf(af[i].y, bf[t].y, x[i][t]);
        x[i][t] = fmaf(af[i].z, bf[t].z, x[i][t]);
        x[i][t] = fmaf(af[i].w, bf[t].w, x[i][t]);
      }
    }
  }
}

// X = A B^T over the head dim: full boxes in a loop, a last half box after
template <int HD>
__device__ __forceinline__ void dot_tile(float (&x)[kMicroRows][kMicroCols], const uint8_t* a_rows,
                                         const uint8_t* b_rows, int rg, int kx) {
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int t = 0; t < kMicroCols; ++t) x[i][t] = 0.0f;
  }
#pragma unroll 1
  for (int box = 0; box < HD / kBoxCols; ++box) {
    dot_box<kBoxCols / 4>(x, a_rows + box * kBlockBox, b_rows + box * kTileBox, rg, kx);
  }
  if constexpr (HD % kBoxCols != 0) {
    constexpr int kLast = HD / kBoxCols;
    dot_box<(HD % kBoxCols) / 4>(x, a_rows + kLast * kBlockBox, b_rows + kLast * kTileBox, rg, kx);
  }
}

// acc (8 rows x hd / 16 columns) += W B: W this warp's tile (local row r at
// r * kWRow bytes, the 16-byte chunk of columns 4u..4u+3 at chunk u ^ (r %
// 2); the thread's rows are r = rg + 2 i, w_rows points at row rg), B a
// streamed tile of kTileRows rows.
template <int HD>
__device__ __forceinline__ void acc_tile(float (&acc)[kMicroRows][HD / kHalf], const uint8_t* w_rows,
                                         const uint8_t* b_tile, int rg, int cl) {
  using C = Cols<HD>;
#pragma unroll 1
  for (int u2 = 0; u2 < kTileRows / 8; ++u2) {
#pragma unroll
    for (int uu = 0; uu < 2; ++uu) {
      const int u = 2 * u2 + uu;  // streamed rows 4u..4u+3; j % 8 below is 4 uu + e
      float4 wf[kMicroRows];
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) {
        wf[i] = *reinterpret_cast<const float4*>(w_rows + 2 * i * kWRow + ((u ^ rg) << 4));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * u + e;
        float bf[C::kGroups][4];
#pragma unroll
        for (int g = 0; g < C::kGroups; ++g) {
          const int col = C::col(g, cl);
          const uint8_t* at = b_tile + (col / kBoxCols) * kTileBox + j * kRowBytes +
                              ((((col % kBoxCols) >> 2) ^ (4 * uu + e)) << 4) + 4 * (col & 3);
          if (C::vec(g) == 4) {
            const float4 x = *reinterpret_cast<const float4*>(at);
            bf[g][0] = x.x;
            bf[g][1] = x.y;
            bf[g][2] = x.z;
            bf[g][3] = x.w;
          } else if (C::vec(g) == 2) {
            const float2 x = *reinterpret_cast<const float2*>(at);
            bf[g][0] = x.x;
            bf[g][1] = x.y;
          } else {
            bf[g][0] = *reinterpret_cast<const float*>(at);
          }
        }
#pragma unroll
        for (int i = 0; i < kMicroRows; ++i) {
          const float w = e == 0 ? wf[i].x : e == 1 ? wf[i].y : e == 2 ? wf[i].z : wf[i].w;
#pragma unroll
          for (int g = 0; g < C::kGroups; ++g) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              if (x < C::vec(g)) {
                acc[i][C::slot(g) + x] = fmaf(w, bf[g][x], acc[i][C::slot(g) + x]);
              }
            }
          }
        }
      }
    }
  }
}

// This thread's 8 x 4 entries into its warp's tile: row rg + 2 i, column
// cl + 16 t in chunk (cl / 4 + 4 t) ^ rg
__device__ __forceinline__ void put_tile(uint8_t* w_rows, const float (&x)[kMicroRows][kMicroCols],
                                         int rg, int cl) {
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int t = 0; t < kMicroCols; ++t) {
      *reinterpret_cast<float*>(w_rows + 2 * i * kWRow + ((((cl >> 2) ^ rg) + 4 * t) << 4) +
                                4 * (cl & 3)) = x[i][t];
    }
  }
}

// u of raw dot products, in place, in the forward's order: s hd^-0.5, then
// with the softcap tanh(s hd^-0.5 / softcap) (hopper::tanh_capped, the
// forward's). A score in base 2 is c u.
__device__ __forceinline__ void cap_scores(float (&s)[kMicroRows][kMicroCols], float scale,
                                           bool capped, float inv_cap) {
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int t = 0; t < kMicroCols; ++t) s[i][t] *= scale;
  }
  if (capped) tanh_capped(s, inv_cap);
}

__device__ __forceinline__ bool visible(int query, int key, int S, int window) {
  return key <= query && query < S && (window <= 0 || query - key < window);
}

// p = 2^(c u - lse2) and dS' = p (dP - D) (1 - u^2 with the softcap) of one
// microtile, in place of u and dp (dS = dS' hd^-0.5, applied at the store).
// dK/dV: rows are keys (key0 + 2 i), columns queries (query0 + 16 t), whose
// lse2 and D are the streamed tile's (lse2[16 t], dsum[16 t]). With kMasked
// a pair that is not visible gets p = dS' = 0.
template <bool kMasked>
__device__ __forceinline__ void key_grads(float (&u)[kMicroRows][kMicroCols],
                                          float (&dp)[kMicroRows][kMicroCols],
                                          const float* lse2, const float* dsum, int key0,
                                          int query0, int S, int window, bool capped, float c) {
#pragma unroll
  for (int t = 0; t < kMicroCols; ++t) {
    const float l2 = lse2[kHalf * t], d = dsum[kHalf * t];
#pragma unroll
    for (int i = 0; i < kMicroRows; ++i) {
      const float p = exp2_ftz(fmaf(u[i][t], c, -l2));
      float ds = p * (dp[i][t] - d);
      if (capped) ds *= fmaf(-u[i][t], u[i][t], 1.0f);
      const bool in = !kMasked || visible(query0 + kHalf * t, key0 + 2 * i, S, window);
      u[i][t] = in ? p : 0.0f;
      dp[i][t] = in ? ds : 0.0f;
    }
  }
}

// dS' of one microtile in place of dp (u is spent). dQ: rows are queries
// (position q0 + byte i % 4 of pos_lo (i < 4) or pos_hi, lse2 and D in
// l2[i], dd[i]), columns keys (key0 + 16 t).
template <bool kMasked>
__device__ __forceinline__ void query_grads(float (&u)[kMicroRows][kMicroCols],
                                            float (&dp)[kMicroRows][kMicroCols],
                                            const float (&l2)[kMicroRows],
                                            const float (&dd)[kMicroRows], int q0, uint32_t pos_lo,
                                            uint32_t pos_hi, int key0, int S, int window,
                                            bool capped, float c) {
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    const int pos = q0 + static_cast<int>(((i < 4 ? pos_lo : pos_hi) >> (8 * (i % 4))) & 0xffu);
#pragma unroll
    for (int t = 0; t < kMicroCols; ++t) {
      const float p = exp2_ftz(fmaf(u[i][t], c, -l2[i]));
      float ds = p * (dp[i][t] - dd[i]);
      if (capped) ds *= fmaf(-u[i][t], u[i][t], 1.0f);
      const bool in = !kMasked || visible(pos, key0 + kHalf * t, S, window);
      dp[i][t] = in ? ds : 0.0f;
    }
  }
}

// ---------------------------------------------------------------- kernel 2
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ lse2,
                          const float* __restrict__ dsum, float* __restrict__ dk,
                          float* __restrict__ dv, Strides sdk, Strides sdv, int S, int H, int rep,
                          int stat_s, int window, float scale, float inv_cap, float c) {
  constexpr int kBoxes = boxes_of(HD);
  constexpr int kRing = ring_of(HD);
  constexpr int kBlockTile = kBoxes * kBlockBox;
  constexpr int kTile = kBoxes * kTileBox;
  using C = Cols<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_tile = align_1024(smem_raw);
  uint8_t* v_tile = k_tile + kBlockTile;
  uint8_t* ring = v_tile + kBlockTile;  // stage st: Q at 2 st kTile, dO at (2 st + 1) kTile
  uint8_t* warp_tiles = ring + 2 * kRing * kTile;
  // stage st: lse2 at 2 st kTileRows floats, D at (2 st + 1) kTileRows
  float* stats = reinterpret_cast<float*>(warp_tiles + kWarps * kWarpTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + 2 * kRing * kTileRows);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + kRing;
  uint64_t* do_full = q_empty + kRing;
  uint64_t* do_empty = do_full + kRing;

  // the grid is (KV head, batch, key block), the key block slowest, so the
  // blocks that see the most query tiles (key block 0) start first on every
  // head and batch, and the short ones fill the tail
  const int g = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  // the query tiles some key of the block sees: from the one holding k0 to
  // the one holding the last position within the window, below S; for each
  // of the rep query heads, in that order
  const int q_last = window > 0 ? min(S - 1, k0 + kBlockRows - 2 + window) : S - 1;
  const int qt0 = k0 / kTileRows;
  const int n_qt = q_last / kTileRows - qt0 + 1;
  const int n_tiles = rep * n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kRing; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&do_full[st], 1);
      mbar_init(&q_empty[st], kWarps);  // one arrival per warp
      mbar_init(&do_empty[st], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 loads K and V once, then keeps the ring full: Q (or dO) of
  // tile u, with its lse2 (or D) rows, goes into stage u % kRing once every
  // warp is done with tile u - kRing there (a fresh barrier counts its
  // phase before the first as complete). Tile t + 1 is asked for in turn t:
  // with two stages as the turn starts, with one as soon as every warp is
  // done with tile t's Q (or dO).
  auto load = [&](int u, int which) {  // which: 0 Q and lse2, 1 dO and D
    if (threadIdx.x != 0 || u >= n_tiles) return;
    const int st = u % kRing;
    uint64_t* full = which ? &do_full[st] : &q_full[st];
    const int h = g * rep + u / n_qt;
    const int q0 = (qt0 + u % n_qt) * kTileRows;
    mbar_wait(which ? &do_empty[st] : &q_empty[st], ((u / kRing) & 1) ^ 1);
    mbar_expect_tx(full, kTile + kTileRows * 4);
    uint8_t* tile = ring + (2 * st + which) * kTile;
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(tile + x * kTileBox, which ? &tm_do : &tm_q, full, kBoxCols * x, q0, h, b);
    }
    const float* src = (which ? dsum : lse2) + (static_cast<long long>(b) * H + h) * stat_s + q0;
    bulk_load(stats + (2 * st + which) * kTileRows, src, kTileRows * 4, full);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * kBlockTile);
    for (int x = 0; x < kBoxes; ++x) {
      for (int r = 0; r < kBlockRows; r += kTileRows) {
        tma_load(k_tile + x * kBlockBox + r * kRowBytes, &tm_k, kv_full, kBoxCols * x, k0 + r, g, b);
        tma_load(v_tile + x * kBlockBox + r * kRowBytes, &tm_v, kv_full, kBoxCols * x, k0 + r, g, b);
      }
    }
  }
  load(0, 0);
  load(0, 1);
  __syncwarp();

  const int rg = lane / kHalf, cl = lane % kHalf;
  const int row0 = kWarpRows * warp + rg;    // this thread's keys: k0 + row0 + 2 i
  const int kw0 = k0 + kWarpRows * warp;     // this warp's first key
  const uint8_t* k_rows = k_tile + row0 * kRowBytes;
  const uint8_t* v_rows = v_tile + row0 * kRowBytes;
  uint8_t* w_tile = warp_tiles + warp * kWarpTile;
  uint8_t* w_rows = w_tile + rg * kWRow;
  float4* u_own = reinterpret_cast<float4*>(w_tile) + lane;  // u of row i at u_own[32 i]
  const int kx = cl & 7;
  const bool capped = inv_cap > 0.0f;

  float dk_acc[kMicroRows][C::kPer], dv_acc[kMicroRows][C::kPer];
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int x = 0; x < C::kPer; ++x) dk_acc[i][x] = dv_acc[i][x] = 0.0f;
  }
  mbar_wait(kv_full, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kRing;
    const uint32_t parity = (t / kRing) & 1;
    const int q0 = (qt0 + t % n_qt) * kTileRows;
    if constexpr (kRing > 1) {
      load(t + 1, 0);
      load(t + 1, 1);
      __syncwarp();
    }
    const uint8_t* q_tile = ring + 2 * st * kTile;
    const uint8_t* do_tile = q_tile + kTile;
    const float* tile_lse2 = stats + 2 * st * kTileRows;
    const float* tile_dsum = tile_lse2 + kTileRows;
    // a tile none of this warp's keys sees is skipped (its stages still
    // waited for and freed); per-element masks only on tiles that cross
    // the diagonal, the window's edge or S
    const bool sees = kw0 < S && kw0 <= min(q0 + kTileRows, S) - 1 &&
                      (window <= 0 || q0 - (kw0 + kWarpRows - 1) < window);
    const bool whole = k0 + kBlockRows - 1 <= q0 && q0 + kTileRows <= S &&
                       (window <= 0 || q0 + kTileRows - 1 - k0 < window);
    float p[kMicroRows][kMicroCols];
    mbar_wait(&q_full[st], parity);
    if (sees) {  // S^T = K Q^T, kept as u in this lane's slots of the warp's tile
      float s[kMicroRows][kMicroCols];
      dot_tile<HD>(s, k_rows, q_tile + cl * kRowBytes, rg, kx);
      cap_scores(s, scale, capped, inv_cap);
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) u_own[32 * i] = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    mbar_wait(&do_full[st], parity);
    if (sees) {
      float dp[kMicroRows][kMicroCols];
      dot_tile<HD>(dp, v_rows, do_tile + cl * kRowBytes, rg, kx);  // dP^T = V dO^T
#pragma unroll
      for (int i = 0; i < kMicroRows; ++i) {
        const float4 x = u_own[32 * i];
        p[i][0] = x.x;
        p[i][1] = x.y;
        p[i][2] = x.z;
        p[i][3] = x.w;
      }
      __syncwarp();  // every lane has its u back before dS^T overwrites the tile
      if (whole) {
        key_grads<false>(p, dp, tile_lse2 + cl, tile_dsum + cl, k0 + row0, q0 + cl, S, window,
                         capped, c);
      } else {
        key_grads<true>(p, dp, tile_lse2 + cl, tile_dsum + cl, k0 + row0, q0 + cl, S, window,
                        capped, c);
      }
      put_tile(w_rows, dp, rg, cl);
      __syncwarp();
      acc_tile<HD>(dk_acc, w_rows, q_tile, rg, cl);  // dK += dS^T Q
    }
    __syncwarp();  // also: every lane is done reading dS^T before P^T overwrites it
    if (lane == 0) mbar_arrive(&q_empty[st]);
    if constexpr (kRing == 1) {
      load(t + 1, 0);
      __syncwarp();
    }
    if (sees) {
      put_tile(w_rows, p, rg, cl);
      __syncwarp();
      acc_tile<HD>(dv_acc, w_rows, do_tile, rg, cl);  // dV += P^T dO
    }
    __syncwarp();  // also: every lane is done reading P^T before the next tile's u
    if (lane == 0) mbar_arrive(&do_empty[st]);
    if constexpr (kRing == 1) {
      load(t + 1, 1);
      __syncwarp();
    }
  }

  // dK hd^-0.5 and dV of this thread's keys below S
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    const int key = k0 + row0 + 2 * i;
    if (key >= S) continue;
    float* dkr = dk + b * sdk.b + key * sdk.s + g * sdk.h;
    float* dvr = dv + b * sdv.b + key * sdv.s + g * sdv.h;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (x < C::vec(g)) {
          dkr[C::col(g, cl) + x] = dk_acc[i][C::slot(g) + x] * scale;
          dvr[C::col(g, cl) + x] = dv_acc[i][C::slot(g) + x];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- kernel 3
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ dout,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, Strides sq, Strides sdo,
                        const float* __restrict__ lse2, const float* __restrict__ dsum,
                        float* __restrict__ dq, Strides sdq, int S, int H, int rep, int groups,
                        int hb, int bq, int stat_s, int window, float scale, float inv_cap,
                        float c) {
  constexpr int kBoxes = boxes_of(HD);
  constexpr int kRing = ring_of(HD);
  constexpr int kBlockTile = kBoxes * kBlockBox;
  constexpr int kTile = kBoxes * kTileBox;
  using C = Cols<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_tile = align_1024(smem_raw);
  uint8_t* do_tile = q_tile + kBlockTile;
  uint8_t* ring = do_tile + kBlockTile;  // stage st: K at 2 st kTile, V at (2 st + 1) kTile
  uint8_t* warp_tiles = ring + 2 * kRing * kTile;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(warp_tiles + kWarps * kWarpTile);
  uint64_t* v_full = k_full + kRing;
  uint64_t* k_empty = v_full + kRing;
  uint64_t* v_empty = k_empty + kRing;

  // the grid is (KV head x head group, batch, row block), the row block
  // slowest and the last (the longest rows) first
  const int g = blockIdx.x / groups;                    // the KV head
  const int h0 = g * rep + (blockIdx.x % groups) * hb;  // the block's first query head
  const int b = blockIdx.y;
  const Rows rows{static_cast<int>(gridDim.z - 1 - blockIdx.z) * bq, S, hb, bq,
                  min(hb, g * rep + rep - h0)};
  const int q0 = rows.q0;
  // the keys any row of the block can see: [k_begin, k_end), in tiles
  const int k_end = min(q0 + bq, S);
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_first / kTileRows) * kTileRows;
  const int n_tiles = (k_end - k_begin + kTileRows - 1) / kTileRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kRing; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], kWarps);  // one arrival per warp
      mbar_init(&v_empty[st], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 keeps the ring full, as in the dK/dV kernel: K (or V) of
  // tile u into stage u % kRing, tile t + 1 asked for in turn t.
  auto load = [&](int u, int which) {  // which: 0 K, 1 V
    if (threadIdx.x != 0 || u >= n_tiles) return;
    const int st = u % kRing;
    uint64_t* full = which ? &v_full[st] : &k_full[st];
    mbar_wait(which ? &v_empty[st] : &k_empty[st], ((u / kRing) & 1) ^ 1);
    mbar_expect_tx(full, kTile);
    uint8_t* tile = ring + (2 * st + which) * kTile;
    for (int x = 0; x < kBoxes; ++x) {
      tma_load(tile + x * kTileBox, which ? &tm_v : &tm_k, full, kBoxCols * x,
               k_begin + u * kTileRows, g, b);
    }
  };
  load(0, 1);
  load(0, 0);

  const int rg = lane / kHalf, cl = lane % kHalf;
  const int row0 = kWarpRows * warp + rg;  // this thread's rows: row0 + 2 i

  // this warp's 16 rows of Q and dO into the swizzled layout (rows that are
  // not live read as 0)
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = kWarpRows * warp + r;
    const bool live = rows.live(row);
    const long long pos = live ? rows.pos(row) : 0;
    const long long head = h0 + (live ? rows.head(row) : 0);
    const float* qsrc = q + b * sq.b + pos * sq.s + head * sq.h;
    const float* dsrc = dout + b * sdo.b + pos * sdo.s + head * sdo.h;
    for (int d = lane; d < HD; d += 32) {
      const int at = (d / kBoxCols) * kBlockBox + swizzled(row, d);
      *reinterpret_cast<float*>(q_tile + at) = live ? qsrc[d] : 0.0f;
      *reinterpret_cast<float*>(do_tile + at) = live ? dsrc[d] : 0.0f;
    }
  }
  __syncwarp();

  // the offsets of the thread's rows from q0, a byte each; their lse2 and D
  uint32_t pos_lo = 0, pos_hi = 0;
  float l2[kMicroRows], dd[kMicroRows];
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    const int row = row0 + 2 * i;
    const uint32_t rel = static_cast<uint32_t>(row / hb);
    if (i < 4) {
      pos_lo |= rel << (8 * i);
    } else {
      pos_hi |= rel << (8 * (i - 4));
    }
    const long long at =
        (static_cast<long long>(b) * H + h0 + rows.head(row)) * stat_s + rows.pos(row);
    l2[i] = rows.live(row) ? lse2[at] : 0.0f;
    dd[i] = rows.live(row) ? dsum[at] : 0.0f;
  }
  // the positions this warp's rows can hold, for skipping tiles it cannot see
  const int w_first = kWarpRows * warp / hb;
  const int w_last = min((kWarpRows * warp + kWarpRows - 1) / hb, bq - 1);
  const int p_min = q0 + w_first, p_max = min(q0 + w_last, S - 1);

  float acc[kMicroRows][C::kPer];
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
#pragma unroll
    for (int x = 0; x < C::kPer; ++x) acc[i][x] = 0.0f;
  }
  const uint8_t* q_rows = q_tile + row0 * kRowBytes;
  const uint8_t* do_rows = do_tile + row0 * kRowBytes;
  uint8_t* w_rows = warp_tiles + warp * kWarpTile + rg * kWRow;
  const int kx = cl & 7;
  const bool capped = inv_cap > 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kRing;
    const uint32_t parity = (t / kRing) & 1;
    const int k0 = k_begin + t * kTileRows;
    if constexpr (kRing > 1) {
      load(t + 1, 1);
      load(t + 1, 0);
      __syncwarp();
    }
    const uint8_t* k_tile = ring + 2 * st * kTile;
    const uint8_t* v_tile = k_tile + kTile;
    const bool sees = w_first <= w_last && p_min <= p_max && k0 <= p_max &&
                      (window <= 0 || p_min - (k0 + kTileRows - 1) < window);
    const bool whole = k0 + kTileRows - 1 <= q0 && k0 + kTileRows <= S &&
                       (window <= 0 || k_end - 1 - k0 < window);
    float dp[kMicroRows][kMicroCols];
    mbar_wait(&v_full[st], parity);
    if (sees) dot_tile<HD>(dp, do_rows, v_tile + cl * kRowBytes, rg, kx);  // dP = dO V^T
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[st]);
    if constexpr (kRing == 1) {
      load(t + 1, 1);
      __syncwarp();
    }
    mbar_wait(&k_full[st], parity);
    if (sees) {
      float s[kMicroRows][kMicroCols];
      dot_tile<HD>(s, q_rows, k_tile + cl * kRowBytes, rg, kx);  // S = Q K^T
      cap_scores(s, scale, capped, inv_cap);
      if (whole) {
        query_grads<false>(s, dp, l2, dd, q0, pos_lo, pos_hi, k0 + cl, S, window, capped, c);
      } else {
        query_grads<true>(s, dp, l2, dd, q0, pos_lo, pos_hi, k0 + cl, S, window, capped, c);
      }
      put_tile(w_rows, dp, rg, cl);
      __syncwarp();
      acc_tile<HD>(acc, w_rows, k_tile, rg, cl);  // dQ += dS K
    }
    __syncwarp();  // also: every lane is done reading dS before the next tile's
    if (lane == 0) mbar_arrive(&k_empty[st]);
    if constexpr (kRing == 1) {
      load(t + 1, 0);
      __syncwarp();
    }
  }

  // dQ hd^-0.5 of this thread's live rows
#pragma unroll
  for (int i = 0; i < kMicroRows; ++i) {
    const int row = row0 + 2 * i;
    if (!rows.live(row)) continue;
    float* dst = dq + b * sdq.b + static_cast<long long>(rows.pos(row)) * sdq.s +
                 static_cast<long long>(h0 + rows.head(row)) * sdq.h;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if (x < C::vec(g)) dst[C::col(g, cl) + x] = acc[i][C::slot(g) + x] * scale;
      }
    }
  }
}

// ---------------------------------------------------------------- launch
// The dQ kernel's GQA packing, the forward's (hopper::layout), of
// kBlockRows rows a block (kernels/flash_attention.py:f32_layout with
// FLASH_BWD_BLOCK_ROWS is the same function)
inline Layout layout(int rep) { return hopper::layout(rep, kBlockRows); }

template <int HD>
int launch(const Args& a, const long long* st, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  int err = hopper::make_map(&tm_q, kType, 4, kBoxCols, a.q, HD, a.S, a.H, a.B, st, kTileRows);
  if (err == 0) {
    err = hopper::make_map(&tm_k, kType, 4, kBoxCols, a.k, HD, a.S, a.G, a.B, st + 3, kTileRows);
  }
  if (err == 0) {
    err = hopper::make_map(&tm_v, kType, 4, kBoxCols, a.v, HD, a.S, a.G, a.B, st + 6, kTileRows);
  }
  if (err == 0) {
    err = hopper::make_map(&tm_do, kType, 4, kBoxCols, a.dout, HD, a.S, a.H, a.B, st + 12,
                           kTileRows);
  }
  if (err != 0) return hopper::kEncoderErrorBase + err;
  const auto k2 = flash_bwd_dkdv_kernel<HD>;
  const auto k3 = flash_bwd_dq_kernel<HD>;
  constexpr int kDkdvSmem = dkdv_bytes(HD, ring_of(HD));
  constexpr int kDqSmem = dq_bytes(HD, ring_of(HD));
  cudaError_t attr =
      cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (attr == cudaSuccess) {
    attr = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  }
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // a score in base 2 is c u (cap_scores)
  const bool capped = a.softcap > 0.0f;
  const float inv_cap = capped ? 1.0f / a.softcap : 0.0f;
  const float c = capped ? a.softcap * kLog2e : kLog2e;
  const int rep = a.H / a.G;
  k2<<<dim3(a.G, a.B, (a.S + kBlockRows - 1) / kBlockRows), kThreads, kDkdvSmem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, a.lse2, a.dsum, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sdk, a.sdv, a.S, a.H, rep, a.stat_s, a.window, a.scale,
      inv_cap, c);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess) return static_cast<int>(e2);
  const Layout lay = layout(rep);
  k3<<<dim3(a.G * lay.groups, a.B, (a.S + lay.bq - 1) / lay.bq), kThreads, kDqSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.dout), tm_k, tm_v, a.sq, a.sdo,
      a.lse2, a.dsum, static_cast<float*>(a.dq), a.sdq, a.S, a.H, rep, lay.groups, lay.hb, lay.bq,
      a.stat_s, a.window, a.scale, inv_cap, c);
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
                                         int B, int S, int H, int G, int hd, int block_rows,
                                         int tile_rows, int stages, int micro_rows,
                                         int micro_cols, int stat_s, const long long* strides,
                                         int window, float scale, float softcap, void* stream) {
  using namespace repro_torch::bwd;
  if (block_rows != ffma::kBlockRows || tile_rows != ffma::kTileRows ||
      stages != ffma::kMaxRing || micro_rows != ffma::kMicroRows ||
      micro_cols != ffma::kMicroCols || !bwd_shape_ok(B, S, H, G, hd, stat_s) ||
      (S + ffma::layout(H / G).bq - 1) / ffma::layout(H / G).bq > 65535) {
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
    return ffma::launch<HD>(a, strides, s);
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

// float32: what a block of the FFMA kernels holds at head dim hd: the
// dynamic shared memory of the dK/dV kernel (which 0) and of the dQ kernel
// (1) in bytes, or the streamed tiles in flight (2); -1 for another hd or
// which
extern "C" int repro_flash_attention_bwd_f32_layout(int hd, int which) {
  using namespace repro_torch::bwd::ffma;
  if (hd < 16 || hd > 128 || hd % 16 != 0) return -1;
  switch (which) {
    case 0:
      return dkdv_bytes(hd, ring_of(hd));
    case 1:
      return dq_bytes(hd, ring_of(hd));
    case 2:
      return ring_of(hd);
    default:
      return -1;
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
