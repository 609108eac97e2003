// The training attention's tensor-core instance (K2, bf16 q/k/v with bf16
// rounding at the Pallas points), written for Hopper: wgmma.mma_async
// m64nNk16 bf16 -> f32 products, K/V (forward, dq) and Q/G (dk-dv) tiles
// streamed by TMA (cp.async.bulk.tensor) into a ring of stages with
// mbarriers. Included by attention_train.cu, whose header states the
// function; the CUDA-core instance there is the f32 path and the control.
//
// A block is one warpgroup (4 warps, 128 threads) that owns 64 query rows
// (forward, dq) or 64 key rows (dk-dv): warp w holds rows 16 w .. + 15 of
// every m64 accumulator, lane 4 g + t rows g and g + 8 at columns 8 j + 2 t,
// + 1 of each n8 block j. Its thread 0 starts the TMA loads S stages ahead;
// a stage is refilled once its 4 warps have arrived on the stage's "empty"
// barrier. A 128-thread block at up to 255 registers lets two blocks share
// an SM (the D = 128 products keep two 64 x 128 f32 accumulators live),
// which a producer warp would cost registers for.
//
// A score takes 4 + 3 + 4 products of T x T x D (forward, dq, dk-dv), 4
// exps and 3 dropout hashes: the forward's second pass and the two
// backward launches each see it once, because delta needs no pass of its
// own:
// - forward: pass 1 S = Q K^T for the row max and sum; pass 2 S again,
//   pd, and PV twice: out += rnd(pd) V and o' += (pd - rnd(pd)) V rounded
//   to bf16 (the hi + lo split of pd leaves 2^-18 of pd), so that o' =
//   sum_j pd_ij v_j with the unrounded pd, in f32;
// - dq: delta_i = rnd(g_i) . o'_i, which is the JAX kernels' sum_j dp_ij
//   p_ij (dp_ij = keep rnd(g_i) . v_j / (1 - rate), pd_ij = keep p_ij / (1
//   - rate)), with no pass of its own; then S, dP = G V^T, ds and dq += ds
//   K in one pass. It also rounds g to bf16 for dk-dv (no cast kernel) and
//   writes each query's terms (row max, 1 / row sum, delta, dropout row
//   hash) for dk-dv's TMA;
// - dk-dv: S^T = K Q^T, dP^T = V G^T, dv += rnd(pd)^T G, dk += ds^T Q.
//
// In the forward's second pass and in dq, the previous tile's product
// with a register operand (PV, dS K) runs on the tensor cores while this
// tile's scores are worked, and every product has completed before the
// loop comes round: a product left in flight across the loop made ptxas
// serialize all of them (C7515), up to 1.7x slower on an H100. dk-dv keeps
// two 64 x D accumulators and two operands and has no registers to spare
// (255 at D = 128).
//
// Shared-memory tiles are 64 rows of one head as TMA writes them: D = 64
// and 128 in 64-column sub-tiles of 128-byte rows under the 128-byte
// swizzle, D = 16 in 32-byte rows under the 32-byte swizzle. The same tile
// is a K-major operand (a product over D) or, with wgmma's transposed B,
// an MN-major one (a product over its rows: PV, dS K, P^T G, dS^T Q).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <chrono>

#include "dropout_hash.cuh"
#include "hopper.cuh"
#include "smem_limit.cuh"

namespace {

struct Dropout {
  bool on;            // rate > 0
  uint32_t threshold; // keep iff bits >= threshold
  float inv_keep;     // 1 / (1 - rate), as the JAX kernels multiply
};

__device__ __forceinline__ int key_count(const int* lengths, int b, int T, bool* uniform) {
  const int n = lengths[b];
  *uniform = n <= 0;
  return n <= 0 ? T : (n > T ? T : n);
}

namespace wg {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 64;  // rows a block owns, and rows a streamed tile holds
// Before the tiles: slack to align them to 1024 bytes (the 128-byte
// swizzle's period); after them: barriers and dq's per-row delta.
constexpr int ALIGN = 1024, TAIL = 512;
constexpr int TERMS_BYTES = ROWS * 16;  // dk-dv: a float4 of terms a query

// The tiles of head dim D and the stages of the ring.
template <int D>
struct Tile {
  static constexpr int BOX = D < 64 ? D : 64;         // columns a TMA box
  static constexpr int SUB = D / BOX;                  // sub-tiles a tile
  static constexpr int ROW_BYTES = BOX * 2;            // 32 or 128
  static constexpr int SUB_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = SUB * SUB_BYTES;        // 64 x D bf16
  static constexpr uint64_t LAYOUT = D < 64 ? 3 : 1;   // descriptor: 32B / 128B swizzle
  static constexpr int STAGES = D == 128 ? 2 : D == 64 ? 3 : 4;
};

template <int D>
constexpr size_t fwd_smem() {
  return ALIGN + Tile<D>::BYTES * (1 + 2 * Tile<D>::STAGES) + TAIL;
}
template <int D>
constexpr size_t dq_smem() {
  return ALIGN + Tile<D>::BYTES * (2 + 2 * Tile<D>::STAGES) + TAIL;
}
template <int D>
constexpr size_t dkdv_smem() {
  return ALIGN + 2 * Tile<D>::BYTES +
         Tile<D>::STAGES * (2 * Tile<D>::BYTES + TERMS_BYTES) + TAIL;
}

// ------------------------------------------------------------------
// Tiles as TMA boxes and wgmma operands (the PTX helpers: hopper.cuh)
// ------------------------------------------------------------------
using namespace hopper;

// The 64 rows from ``row`` of head columns [col, col + D) of batch row b
// (rows past T arrive as zeros).
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int b) {
#pragma unroll
  for (int c = 0; c < Tile<D>::SUB; ++c)
    tma_load(dst + c * Tile<D>::SUB_BYTES, map, bar, col + c * Tile<D>::BOX, row, b);
}

// A tile as a K-major operand (rows = M or N, D = K), at k-step kk: 8-row
// groups ROW_BYTES * 8 apart, the k-step's 32 bytes into the swizzled row.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using L = Tile<D>;
  const uint32_t a = tile + (kk * 16 / L::BOX) * L::SUB_BYTES + (kk * 16 % L::BOX) * 2;
  return desc(a, 16, 8 * L::ROW_BYTES, L::LAYOUT);
}

// A tile as an MN-major B operand (rows = K, D = N), at k-step kk (rows 16
// kk ..): 8-row groups ROW_BYTES * 8 apart, 64-column sub-tiles SUB_BYTES
// apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using L = Tile<D>;
  return desc(tile + kk * 16 * L::ROW_BYTES, L::SUB_BYTES, 8 * L::ROW_BYTES, L::LAYOUT);
}

// ------------------------------------------------------------------
// Per-score helpers
// ------------------------------------------------------------------
// Logits in log2 units: p = 2^(s c - m2) with c = scale log2(e) (0 for a
// row of length <= 0, whose logits are all equal) and m2 = m log2(e), m the
// row max of s scale in natural units (the stats' unit). One FFMA and the
// SFU's ex2.approx (~2 ulp) a score; every pass and launch computes m2 and
// the exponent the same way, so the sums and the recomputed
// probabilities agree.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two values as bf16 (hi) and their remainders as bf16 (lo).
__device__ __forceinline__ void split(float a, float b, uint32_t* hi, uint32_t* lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  *hi = *reinterpret_cast<const uint32_t*>(&h);
  *lo = pack(a - hf.x, b - hf.y);
}

// A 64 x D f32 accumulator's rows 16 w + g, + 8 (from r0) to (T, E) device
// memory at head h; rows at or past T skipped. f32 as float2, bf16 as
// bfloat162.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack(a, b);
}

template <int D, typename Out>
__device__ __forceinline__ void store_acc(Out* dst, const float (&acc)[D / 2], int r0, int T,
                                          int E, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 16 * warp + (lane >> 2) + 8 * r;
    if (row >= T) continue;
    Out* p = dst + (size_t)row * E + h * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store_pair(p + 8 * j, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// The S (or S^T) tile of this block's 64 rows against 64 streamed rows:
// both K-major over D.
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64>(s, kmajor<D>(a_tile, kk), kmajor<D>(b_tile, kk), kk);
}

// The ring's bookkeeping: load i sits in stage i % S; its "full" barrier
// completes the (i / S)-th time when its bytes have landed, its "empty"
// barrier when the 4 warps have released it.
template <int S>
struct Ring {
  uint32_t bars;  // full[S] then empty[S]
  __device__ uint32_t full(int i) const { return bars + 8 * (i % S); }
  __device__ uint32_t empty(int i) const { return bars + 8 * (S + i % S); }
  __device__ static uint32_t parity(int i) { return (i / S) & 1; }
  __device__ void init() const {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S + s), WARPS);
    }
  }
  // Called by every thread after load i's last use: the warp releases its
  // stage; thread 0 refills it with load i + S, once all warps have.
  template <class Load>
  __device__ void release(int i, int n, Load load) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(i));
    if (threadIdx.x == 0 && i + S < n) {
      mbar_wait(empty(i), parity(i));
      load(i + S);
    }
    __syncwarp();  // warp 0 reconverges before its next wgmma
  }
};

// ------------------------------------------------------------------
// Forward. Grid (ceil(T/64), H, B), 128 threads: 64 query rows from q0.
// ------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const int* __restrict__ lengths,
                      const int* __restrict__ seeds, float* __restrict__ out,
                      float* __restrict__ oprime, float* __restrict__ row_max,
                      float* __restrict__ row_sum, int T, int E, int tq, float scale,
                      Dropout drop) {
  using L = Tile<D>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (saddr(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t kv = sq + L::BYTES;  // stage s: K at kv + 2 s BYTES, V after it
  const Ring<S> ring{kv + 2 * S * L::BYTES};
  const uint32_t qbar = ring.bars + 16 * S;
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const int ntiles = (nkeys + ROWS - 1) / ROWS, nloads = 2 * ntiles;

  // loads 0 .. ntiles - 1: K for the row stats; then K and V
  auto load = [&](int i) {
    const uint32_t st = kv + 2 * (i % S) * L::BYTES, bar = ring.full(i);
    const int j = i < ntiles ? i : i - ntiles;
    mbar_expect_tx(bar, (i < ntiles ? 1 : 2) * L::BYTES);
    tma_tile<D>(st, &kmap, bar, h * D, j * ROWS, b);
    if (i >= ntiles) tma_tile<D>(st + L::BYTES, &vmap, bar, h * D, j * ROWS, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(qbar, 1);
    mbar_init_fence();
    mbar_expect_tx(qbar, L::BYTES);
    tma_tile<D>(sq, &qmap, qbar, h * D, q0, b);
    for (int i = 0; i < S && i < nloads; ++i) load(i);
  }
  __syncthreads();

  const float c = uniform ? 0.f : scale * LOG2E;

  // Pass 1: row max and sum (rows g, g + 8 of the warp; columns split
  // over the quad's 4 lanes until the end). Columns are masked only in the
  // tile that holds the length.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(ring.full(i), ring.parity(i));
    float s[32];
    scores<D>(s, sq, kv + 2 * (i % S) * L::BYTES);
    wg_commit();
    wg_wait_all();
    hold(s);
    ring.release(i, nloads, load);
    const int k0 = i * ROWS;
    const bool full = k0 + ROWS <= nkeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (full || k0 + acc_col(e, t) < nkeys) mx[acc_row(e)] = fmaxf(mx[acc_row(e)], s[e]);
    float m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // m stays -inf while every column was masked
      const float mn = fmaxf(m[r], uniform ? 0.f : mx[r] * scale);
      l[r] = m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mn) * LOG2E);
      m[r] = mn;
      m2[r] = mn * LOG2E;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float x = ex2(fmaf(s[e], c, -m2[acc_row(e)]));
      l[acc_row(e)] += full || k0 + acc_col(e, t) < nkeys ? x : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mn) * LOG2E)) +
             (mo == -INFINITY ? 0.f : lo * ex2((mo - mn) * LOG2E));
      m[r] = mn;
    }

  // Pass 2: pd, and PV with its bf16 part (out) and its remainder (o').
  const uint32_t seed = (uint32_t)seeds[b];
  float m2[2], inv_l[2];
  uint32_t rowterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
    m2[r] = m[r] * LOG2E;
    inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
    rowterm[r] = dropout_row(seed, (uint32_t)(h * (T / tq) + row / tq), (uint32_t)row);
  }
  float o[D / 2], olo[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) o[n] = olo[n] = 0.f;
  // The previous tile's PV runs on the tensor cores while this tile's
  // probabilities are worked: each step starts S(i), then PV(i - 1) from
  // the bf16 parts hi/lo packed in the step before, waits for S(i) alone,
  // works the scores in place, then waits for PV(i - 1) (nothing stays in
  // flight across the loop, which would make ptxas serialize the
  // products) and packs tile i's parts.
  uint32_t hi[4][4], lo[4][4];
  auto pv = [&](int i) {
    const uint32_t vt = kv + 2 * (i % S) * L::BYTES + L::BYTES;
    hold(o);
    hold(olo);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_t<D>(o, hi[kk], mnmajor<D>(vt, kk));
      wgmma_rs_t<D>(olo, lo[kk], mnmajor<D>(vt, kk));
    }
    wg_commit();
  };
  for (int i = ntiles; i < nloads; ++i) {
    mbar_wait(ring.full(i), ring.parity(i));
    float s[32];
    scores<D>(s, sq, kv + 2 * (i % S) * L::BYTES);
    wg_commit();
    if (i > ntiles) {
      pv(i - 1);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    hold(s);
    const int k0 = (i - ntiles) * ROWS;
    const bool full = k0 + ROWS <= nkeys;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = k0 + acc_col(e, t), r = acc_row(e);
      float x = ex2(fmaf(s[e], c, -m2[r])) * inv_l[r];
      if (drop.on)
        x = dropout_mix(rowterm[r] + dropout_col(col)) >= drop.threshold ? x * drop.inv_keep
                                                                          : 0.f;
      s[e] = full || col < nkeys ? x : 0.f;  // a select: no branch in the tile
    }
    if (i > ntiles) {
      wg_wait<0>();
      hold(o);
      hold(olo);
      hold(hi);
      hold(lo);
      ring.release(i - 1, nloads, load);
    }
    // element pair e of the accumulator is register (e / 2) % 4 of k-step
    // e / 8 of the A operand
#pragma unroll
    for (int e = 0; e < 32; e += 2)
      split(s[e], s[e + 1], &hi[e >> 3][(e >> 1) & 3], &lo[e >> 3][(e >> 1) & 3]);
  }
  pv(nloads - 1);
  wg_wait<0>();
  hold(o);
  hold(olo);
  const size_t base = (size_t)b * T * E;
  store_acc<D>(out + base, o, q0, T, E, h);
#pragma unroll
  for (int n = 0; n < D / 2; ++n) olo[n] += o[n];
  store_acc<D>(oprime + base, olo, q0, T, E, h);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * r;
      if (row < T) {
        row_max[((size_t)b * H + h) * T + row] = m[r];
        row_sum[((size_t)b * H + h) * T + row] = l[r];
      }
    }
  }
}

// Byte offset of (row r, 8-column chunk c) in a tile as TMA's swizzle lays
// it out (D = 16: 32-byte rows, the chunk bit XORed with row bit 2; else
// 128-byte rows of 64-column sub-tiles, the chunk XORed with row % 8).
template <int D>
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  using L = Tile<D>;
  if (D < 64) return r * L::ROW_BYTES + ((c ^ ((r >> 2) & 1)) << 4);
  return (c >> 3) * L::SUB_BYTES + r * L::ROW_BYTES + (((c & 7) ^ (r & 7)) << 4);
}

// ------------------------------------------------------------------
// Backward 1: dq, and each query's terms for dk-dv (row max in log2
// units, 1 / row sum, delta, dropout row hash). Grid and rows as the
// forward. g arrives in f32: this launch rounds it once (the Pallas kernel
// rounds it per head: the same values) into the block's G tile and into gr
// for dk-dv.
// ------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const float* __restrict__ g,
                         const int* __restrict__ lengths, const int* __restrict__ seeds,
                         const float* __restrict__ row_max, const float* __restrict__ row_sum,
                         const float* __restrict__ oprime, float4* __restrict__ terms,
                         bf16* __restrict__ gr, bf16* __restrict__ dq, int T, int E, int tq,
                         float scale, Dropout drop) {
  using L = Tile<D>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem[];
  const uint32_t sq = (saddr(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t sg = sq + L::BYTES, kv = sg + L::BYTES;
  const Ring<S> ring{kv + 2 * S * L::BYTES};
  const uint32_t qbar = ring.bars + 16 * S;
  float* delta_s = reinterpret_cast<float*>(smem + (qbar + 8 - saddr(smem)));
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const int ntiles = (nkeys + ROWS - 1) / ROWS;
  const size_t base = (size_t)b * T * E, stat = ((size_t)b * H + h) * T;

  auto load = [&](int i) {
    const uint32_t st = kv + 2 * (i % S) * L::BYTES, bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::BYTES);
    tma_tile<D>(st, &kmap, bar, h * D, i * ROWS, b);
    tma_tile<D>(st + L::BYTES, &vmap, bar, h * D, i * ROWS, b);
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(qbar, 1);
    mbar_init_fence();
    mbar_expect_tx(qbar, L::BYTES);
    tma_tile<D>(sq, &qmap, qbar, h * D, q0, b);
    for (int i = 0; i < S && i < ntiles; ++i) load(i);
  }

  // The G tile: rnd(g) of rows q0 .., 8 columns a thread a step, and the
  // row's delta = rnd(g) . o' summed over the CH lanes that share it.
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH, c = idx % CH, row = q0 + r;
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0, o0 = g0, o1 = g0;
    const size_t at = base + (size_t)row * E + h * D + 8 * c;
    if (row < T) {
      g0 = *reinterpret_cast<const float4*>(g + at);
      g1 = *reinterpret_cast<const float4*>(g + at + 4);
      o0 = *reinterpret_cast<const float4*>(oprime + at);
      o1 = *reinterpret_cast<const float4*>(oprime + at + 4);
    }
    uint4 u;
    u.x = pack(g0.x, g0.y);
    u.y = pack(g0.z, g0.w);
    u.z = pack(g1.x, g1.y);
    u.w = pack(g1.z, g1.w);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(v[0]), bb = __bfloat1622float2(v[1]),
                 cc = __bfloat1622float2(v[2]), dd = __bfloat1622float2(v[3]);
    float part = a.x * o0.x + a.y * o0.y + bb.x * o0.z + bb.y * o0.w + cc.x * o1.x +
                 cc.y * o1.y + dd.x * o1.z + dd.y * o1.w;
#pragma unroll
    for (int o = 1; o < CH; o <<= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    *reinterpret_cast<uint4*>(smem + (sg - saddr(smem)) + swizzled<D>(r, c)) = u;
    if (row < T) *reinterpret_cast<uint4*>(gr + at) = u;
    if (c == 0) delta_s[r] = part;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t seed = (uint32_t)seeds[b];
  const float c = uniform ? 0.f : scale * LOG2E;
  float m2[2], inv_l[2], dl[2];
  uint32_t rowterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = 16 * warp + (lane >> 2) + 8 * r, row = q0 + lr;
    const bool valid = row < T;
    m2[r] = valid ? row_max[stat + row] * LOG2E : 0.f;
    inv_l[r] = valid ? 1.f / fmaxf(row_sum[stat + row], 1e-30f) : 0.f;
    dl[r] = delta_s[lr];
    rowterm[r] = dropout_row(seed, (uint32_t)(h * (T / tq) + row / tq), (uint32_t)row);
    if (valid && t == 0)
      terms[stat + row] = make_float4(m2[r], inv_l[r], dl[r], __uint_as_float(rowterm[r]));
  }

  float acc[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  // As the forward's second pass: the previous tile's dS K runs while this
  // tile's ds is worked; nothing stays in flight across the loop.
  uint32_t a[4][4];
  auto dsk = [&](int i) {
    const uint32_t kt = kv + 2 * (i % S) * L::BYTES;
    hold(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t<D>(acc, a[kk], mnmajor<D>(kt, kk));
    wg_commit();
  };
  mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const uint32_t kt = kv + 2 * (i % S) * L::BYTES, vt = kt + L::BYTES;
    mbar_wait(ring.full(i), ring.parity(i));
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(s, kmajor<D>(sq, kk), kmajor<D>(kt, kk), kk);
      wgmma_ss<64>(dp, kmajor<D>(sg, kk), kmajor<D>(vt, kk), kk);
    }
    wg_commit();
    if (i > 0) {
      dsk(i - 1);
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    hold(s);
    hold(dp);
    const bool full = (i + 1) * ROWS <= nkeys;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = i * ROWS + acc_col(e, t), r = acc_row(e);
      const float p = ex2(fmaf(s[e], c, -m2[r])) * inv_l[r];
      float d = dp[e];
      if (drop.on)
        d = dropout_mix(rowterm[r] + dropout_col(col)) >= drop.threshold ? d * drop.inv_keep
                                                                          : 0.f;
      s[e] = full || col < nkeys ? p * (d - dl[r]) * scale : 0.f;
    }
    if (i > 0) {
      wg_wait<0>();
      hold(acc);
      hold(a);
      ring.release(i - 1, ntiles, load);
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2) a[e >> 3][(e >> 1) & 3] = pack(s[e], s[e + 1]);  // rnd(ds)
  }
  dsk(ntiles - 1);
  wg_wait<0>();
  hold(acc);
  store_acc<D>(dq + base, acc, q0, T, E, h);
}

// ------------------------------------------------------------------
// Backward 2: dk and dv. Grid (ceil(T/64), H, B), 128 threads: 64 key
// rows from k0; query tiles of 64 (Q, G and their terms) stream in.
// ------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
attn_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const __grid_constant__ CUtensorMap tmap,
                           const int* __restrict__ lengths, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int T, int E, float scale, Dropout drop) {
  using L = Tile<D>;
  constexpr int S = L::STAGES;
  extern __shared__ unsigned char smem[];
  const uint32_t sk = (saddr(smem) + ALIGN - 1) & ~(uint32_t)(ALIGN - 1);
  const uint32_t sv = sk + L::BYTES, qg = sv + L::BYTES;  // stage s: Q, G at qg + 2 s BYTES
  const uint32_t tm = qg + 2 * S * L::BYTES;  // stage s: terms at tm + s TERMS_BYTES
  const Ring<S> ring{tm + S * TERMS_BYTES};
  const uint32_t kvbar = ring.bars + 16 * S;
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const size_t base = (size_t)b * T * E;

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) dka[n] = dva[n] = 0.f;
  // Keys at or past the count have zero probability for every query:
  // their gradients are zero.
  if (k0 >= nkeys) {
    store_acc<D>(dk + base, dka, k0, T, E, h);
    store_acc<D>(dv + base, dva, k0, T, E, h);
    return;
  }
  const int nq = (T + ROWS - 1) / ROWS;
  auto load = [&](int i) {
    const uint32_t st = qg + 2 * (i % S) * L::BYTES, bar = ring.full(i);
    mbar_expect_tx(bar, 2 * L::BYTES + TERMS_BYTES);
    tma_tile<D>(st, &qmap, bar, h * D, i * ROWS, b);
    tma_tile<D>(st + L::BYTES, &gmap, bar, h * D, i * ROWS, b);
    tma_load2(tm + (i % S) * TERMS_BYTES, &tmap, bar, 4 * i * ROWS, b * H + h);
  };
  if (threadIdx.x == 0) {
    ring.init();
    mbar_init(kvbar, 1);
    mbar_init_fence();
    mbar_expect_tx(kvbar, 2 * L::BYTES);
    tma_tile<D>(sk, &kmap, kvbar, h * D, k0, b);
    tma_tile<D>(sv, &vmap, kvbar, h * D, k0, b);
    for (int i = 0; i < S && i < nq; ++i) load(i);
  }
  __syncthreads();

  const float cs = uniform ? 0.f : scale * LOG2E;
  bool key_live[2];
  uint32_t keyterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + 16 * warp + (lane >> 2) + 8 * r;
    key_live[r] = key < nkeys;
    keyterm[r] = dropout_col((uint32_t)key);
  }
  mbar_wait(kvbar, 0);
  for (int i = 0; i < nq; ++i) {
    const uint32_t qt = qg + 2 * (i % S) * L::BYTES, gt = qt + L::BYTES;
    const float4* terms =
        reinterpret_cast<const float4*>(smem + (tm + (i % S) * TERMS_BYTES - saddr(smem)));
    mbar_wait(ring.full(i), ring.parity(i));
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(s, kmajor<D>(sk, kk), kmajor<D>(qt, kk), kk);
      wgmma_ss<64>(dp, kmajor<D>(sv, kk), kmajor<D>(gt, kk), kk);
    }
    wg_commit();
    wg_wait_all();
    hold(s);
    hold(dp);
    // accumulator rows are keys (g, g + 8), columns queries; a query's
    // terms: row max in log2 units, 1 / row sum (0 past T), delta, dropout
    // row hash
    uint32_t apd[4][4], ads[4][4];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      float pd[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = acc_row(e + c);
        const float4 q = terms[acc_col(e + c, t)];
        const float p = ex2(fmaf(s[e + c], cs, -q.x)) * q.y;
        float pdv = p, d = dp[e + c];
        if (drop.on) {
          const bool keep = dropout_mix(__float_as_uint(q.w) + keyterm[r]) >= drop.threshold;
          pdv = keep ? p * drop.inv_keep : 0.f;
          d = keep ? d * drop.inv_keep : 0.f;
        }
        pd[c] = key_live[r] ? pdv : 0.f;
        ds[c] = key_live[r] ? p * (d - q.z) * scale : 0.f;
      }
      apd[e >> 3][(e >> 1) & 3] = pack(pd[0], pd[1]);  // rnd(pd)^T
      ads[e >> 3][(e >> 1) & 3] = pack(ds[0], ds[1]);  // rnd(ds)^T
    }
    hold(dva);
    hold(dka);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_t<D>(dva, apd[kk], mnmajor<D>(gt, kk));
      wgmma_rs_t<D>(dka, ads[kk], mnmajor<D>(qt, kk));
    }
    wg_commit();
    wg_wait_all();
    hold(dva);
    hold(dka);
    hold(apd);
    hold(ads);
    ring.release(i, nq, load);
  }
  store_acc<D>(dk + base, dka, k0, T, E, h);
  store_acc<D>(dv + base, dva, k0, T, E, h);
}

// ------------------------------------------------------------------
// Host: tensor maps and launches
// ------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the CUDA runtime has loaded
// (the library links no libcuda stub).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// What a launcher returns when cuTensorMapEncodeTiled refuses a map (no CUDA
// error code of the runtime's own).
constexpr int MAP_REFUSED = -1;

// Maps encoded since the library loaded and the host nanoseconds spent
// encoding them (attention_train_tc_map_stats).
std::atomic<long long> maps_encoded{0}, map_encode_ns{0};

// The tensor map of a (B, T, E) bf16 tensor in boxes of 64 rows x min(D,
// 64) columns (d > 0), or of the (B H, T, 4) f32 terms in boxes of 64
// queries (d == 0), encoded into *out on every launch. False if libcuda
// refuses it.
inline bool tensor_map(CUtensorMap* out, const void* ptr, int d, int B, int T, int E) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const auto start = std::chrono::steady_clock::now();
  CUresult res;
  if (d > 0) {
    const cuuint64_t dims[3] = {(cuuint64_t)E, (cuuint64_t)T, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)E * 2, (cuuint64_t)T * E * 2};
    const cuuint32_t box[3] = {(cuuint32_t)(d < 64 ? d : 64), (cuuint32_t)ROWS, 1};
    const cuuint32_t one[3] = {1, 1, 1};
    res = encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                 box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 d < 64 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[2] = {(cuuint64_t)T * 4, (cuuint64_t)B};
    const cuuint64_t strides[1] = {(cuuint64_t)T * 16};
    const cuuint32_t box[2] = {4 * ROWS, 1};
    const cuuint32_t one[2] = {1, 1};
    res = encode(out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr), dims, strides,
                 box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  map_encode_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                       std::chrono::steady_clock::now() - start).count();
  maps_encoded += 1;
  return res == CUDA_SUCCESS;
}

template <int D>
int forward(const bf16* q, const bf16* k, const bf16* v, const int* lengths, const int* seeds,
            float* out, float* oprime, float* row_max, float* row_sum, int B, int T, int E,
            int H, int tq, float scale, Dropout drop, cudaStream_t stream) {
  static smem_limit::Record record;
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, D, B, T, E) || !tensor_map(&km, k, D, B, T, E) ||
      !tensor_map(&vm, v, D, B, T, E))
    return MAP_REFUSED;
  cudaError_t err = smem_limit::allow(attn_fwd_wgmma_kernel<D>, fwd_smem<D>(), record);
  if (err != cudaSuccess) return err;
  attn_fwd_wgmma_kernel<D><<<dim3((T + ROWS - 1) / ROWS, H, B), THREADS, fwd_smem<D>(),
                             stream>>>(qm, km, vm, lengths, seeds, out, oprime, row_max,
                                       row_sum, T, E, tq, scale, drop);
  return cudaGetLastError();
}

template <int D>
int backward(const bf16* q, const bf16* k, const bf16* v, const float* g, const int* lengths,
             const int* seeds, const float* row_max, const float* row_sum, const float* oprime,
             float* terms, bf16* gr, bf16* dq, bf16* dk, bf16* dv, int B, int T, int E, int H,
             int tq, float scale, Dropout drop, cudaStream_t stream) {
  static smem_limit::Record dq_record, dkdv_record;
  CUtensorMap qm, km, vm, gm, tm;
  if (!tensor_map(&qm, q, D, B, T, E) || !tensor_map(&km, k, D, B, T, E) ||
      !tensor_map(&vm, v, D, B, T, E) || !tensor_map(&gm, gr, D, B, T, E) ||
      !tensor_map(&tm, terms, 0, B * H, T, 0))
    return MAP_REFUSED;
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  cudaError_t err = smem_limit::allow(attn_bwd_dq_wgmma_kernel<D>, dq_smem<D>(), dq_record);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma_kernel<D><<<grid, THREADS, dq_smem<D>(), stream>>>(
      qm, km, vm, g, lengths, seeds, row_max, row_sum, oprime,
      reinterpret_cast<float4*>(terms), gr, dq, T, E, tq, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = smem_limit::allow(attn_bwd_dkdv_wgmma_kernel<D>, dkdv_smem<D>(), dkdv_record);
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_wgmma_kernel<D><<<grid, THREADS, dkdv_smem<D>(), stream>>>(
      qm, km, vm, gm, tm, lengths, dk, dv, T, E, scale, drop);
  return cudaGetLastError();
}

// The largest dynamic shared memory of the three launches at head dim D
// (0 for a head dim the instance does not take).
inline size_t smem_bytes(int D) {
  switch (D) {
    case 16: return dkdv_smem<16>();
    case 64: return dkdv_smem<64>();
    case 128: return dkdv_smem<128>();
    default: return 0;
  }
}

static_assert(dkdv_smem<128>() >= dq_smem<128>() && dq_smem<128>() >= fwd_smem<128>(),
              "dk-dv takes the most shared memory");
static_assert(2 * (dkdv_smem<128>() + 1024) <= 228 * 1024, "two blocks an SM at D = 128");

}  // namespace wg
}  // namespace
