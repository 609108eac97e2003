// Shifted-row GEMM cores on bf16 tensor cores for the k=3 SAME
// convolutions of the training conv feed-forward (K3 and the C-blocked K4,
// both in conv_ff_blocked_tc.cu).
//
// A k=3 SAME conv over the rows of one batch row is a GEMM with K = 3 K_in:
// output row t takes operand rows t - 1, t and t + 1 (taps d = 0, 1, 2),
// zero outside [0, T):
//
//   conv_tile:  acc[r][n] = sum_d sum_k A[lo + r + d - 1][k] W[d][k][n]
//               (k over all of K, or one split's chunks of CK channels)
//   wgrad_tile: acc[m][n] = sum over rows t of A[t + d - 1][m] G[t][n]
//               (one tap d of a weight gradient, K = the rows)
//
// A block of 8 warps owns a BM x BN = 128 x 128 f32 tile (warps 2 x 4 of
// 64 x 32, 64 accumulators a lane). Operands are bf16 in device memory;
// chunks of them stream through a STAGES-deep cp.async ring in dynamic
// shared memory, rows padded by 16 bytes so that the 8 rows one ldmatrix
// phase reads fall on distinct bank groups; products are mma.sync m16n8k16
// bf16 -> f32. The shift costs nothing: a chunk of the conv operand is
// loaded once with a halo of one row on each side, and tap d reads it d
// rows down (ldmatrix takes a row address per lane). Tiles never span two
// batch rows, so a halo row outside [0, T) is zero for every output row
// that reads it, and t +- 1 never reaches the neighbouring utterance.

#pragma once

#include "mma_bf16.cuh"

namespace {
namespace cftc {

using tc::bf16;

constexpr int THREADS = 256;
constexpr int BM = 128, BN = 128;  // output tile
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int PAD = 8;             // bf16 of padding per shared-memory row
constexpr int LDN = BN + PAD;
// conv_tile: chunks of CK input channels, BM + 2 operand rows (the halo)
constexpr int CK = 32, LDC = CK + PAD;
constexpr int CONV_X = (BM + 2) * LDC, CONV_W = 3 * CK * LDN;
// wgrad_tile: chunks of WK rows, WK + 2 rows of A (the halo)
constexpr int WK = 64, LDM = BM + PAD;
constexpr int WG_A = (WK + 2) * LDM, WG_G = WK * LDN;

__host__ __device__ constexpr size_t conv_smem() {
  return (size_t)STAGES * (CONV_X + CONV_W) * sizeof(bf16);
}
__host__ __device__ constexpr size_t wgrad_smem() {
  return (size_t)STAGES * (WG_A + WG_G) * sizeof(bf16);
}
static_assert(2 * conv_smem() + 2048 <= 228 * 1024, "two conv blocks on an SM");
static_assert(2 * wgrad_smem() + 2048 <= 228 * 1024, "two wgrad blocks on an SM");

// The conv GEMMs' row tiles of one batch row, and the splits of K for a
// conv GEMM of N columns over K input channels: the count (at most K /
// 128) that least loads the busiest SM, ceil(blocks x splits / SMs) /
// splits, the smallest on a tie; 1 where one wave of tiles already fills
// the card. Each split writes a float32 partial; the caller adds them in
// split order (no atomics).
constexpr int SMS = 132;  // an H100's streaming multiprocessors

inline int conv_tiles(int T) { return (T + BM - 1) / BM; }

inline int conv_splits(int B, int T, int K, int N) {
  const long long blocks = (long long)(N / BN) * conv_tiles(T) * B;
  int best = 1;
  double best_load = (double)((blocks + SMS - 1) / SMS);
  for (int s = 2; s <= K / 128; ++s) {
    const double load = (double)((blocks * s + SMS - 1) / SMS) / s;
    if (load < best_load) {
      best = s;
      best_load = load;
    }
  }
  return best;
}

typedef float Acc[4][4][4];  // [m16 tile][n8 tile][fragment] of the warp's 64 x 32

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// The warp's 16 products of one k16 step: a[mt] the A fragments of its
// four m16 tiles, b[nn] the B fragments of two n8 tiles each; with RN each
// k16 term is added by a rounded float32 add (tc::mma_rn).
template <bool RN = false>
__device__ __forceinline__ void mma_step(Acc& acc, const uint32_t (&a)[4][4],
                                         const uint32_t (&b)[2][4]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const uint32_t b0 = b[nt >> 1][2 * (nt & 1)], b1 = b[nt >> 1][2 * (nt & 1) + 1];
      if (RN)
        tc::mma_rn(acc[mt][nt], a[mt], b0, b1);
      else
        tc::mma(acc[mt][nt], a[mt], b0, b1);
    }
}

// The cp.async ring over n chunks: load(stage, i) issues chunk i's copies,
// compute(stage address, i) consumes it. Returns with every copy landed and
// the ring free (the caller's epilogue may reuse the shared memory).
template <int STAGE_ELEMS, class Load, class Compute>
__device__ __forceinline__ void ring(bf16* smem, int n, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(smem + s * STAGE_ELEMS, s);
    tc::cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    tc::cp_wait<STAGES - 2>();  // chunk i has landed
    __syncthreads();            // ... for every thread; chunk i - 1 is consumed
    const int next = i + STAGES - 1;
    if (next < n) load(smem + (next % STAGES) * STAGE_ELEMS, next);
    tc::cp_commit();
    compute(tc::saddr(smem + (i % STAGES) * STAGE_ELEMS), i);
  }
  tc::cp_wait<0>();
  __syncthreads();
}

// acc = sum_d sum_k A[lo - 1 + r + d][k] W[d][k][n0 + c] over this warp's
// rows r and columns c of the tile, k over the chunks [c0, c1) of CK
// channels. A: the (T, K) rows of one batch row, read as zero outside
// [0, T); W: (3, K, N). K % CK == 0, N % BN == 0. RN: see mma_step.
template <bool RN = false>
__device__ __forceinline__ void conv_tile(Acc& acc, const bf16* __restrict__ A,
                                          const bf16* __restrict__ W, int lo, int T, int K,
                                          int N, int n0, bf16* smem, int c0, int c1) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  zero(acc);
  auto load = [&](bf16* xs, int i) {
    const int k0 = (c0 + i) * CK;
    for (int j = tid; j < (BM + 2) * (CK / 8); j += THREADS) {
      const int r = j / (CK / 8), c = j % (CK / 8), t = lo - 1 + r;
      const bool valid = t >= 0 && t < T;
      tc::cp16(tc::saddr(xs + r * LDC + c * 8), A + (size_t)(valid ? t : 0) * K + k0 + c * 8,
               valid);
    }
    bf16* ws = xs + CONV_X;  // rows d * CK + k
    for (int j = tid; j < 3 * CK * (BN / 8); j += THREADS) {
      const int r = j / (BN / 8), c = j % (BN / 8);
      tc::cp16(tc::saddr(ws + r * LDN + c * 8),
               W + ((size_t)(r / CK) * K + k0 + r % CK) * N + n0 + c * 8, true);
    }
  };
  auto compute = [&](uint32_t xt, int) {
    const uint32_t wt = xt + 2 * CONV_X;
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        uint32_t a[4][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          tc::ldsm(a[mt], tc::a_addr<LDC>(xt, wm * 64 + 16 * mt + d, 16 * ks, lane));
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          tc::ldsm_t(b[nn], tc::a_addr<LDN>(wt + 2 * d * CK * LDN, 16 * ks,
                                            wn * 32 + 16 * nn, lane));
        mma_step<RN>(acc, a, b);
      }
  };
  ring<CONV_X + CONV_W>(smem, c1 - c0, load, compute);
}

// acc = sum over the rows (b, t) of chunks [c0, c1) of A[b][t + d - 1][m0 + m]
// G[b][t][n0 + n] over this warp's m and n; chunk c covers rows t =
// (c % nck) * WK .. + WK - 1 of batch row c / nck, nck = ceil(T / WK); A
// (B, T, M) and G (B, T, N) read as zero outside [0, T).
__device__ __forceinline__ void wgrad_tile(Acc& acc, const bf16* __restrict__ A,
                                           const bf16* __restrict__ G, int T, int M, int N,
                                           int m0, int n0, int d, int c0, int c1, bf16* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int nck = (T + WK - 1) / WK;
  zero(acc);
  auto load = [&](bf16* as, int i) {
    const int c = c0 + i, t0 = (c % nck) * WK;
    const size_t base = (size_t)(c / nck) * T;
    for (int j = tid; j < (WK + 2) * (BM / 8); j += THREADS) {
      const int r = j / (BM / 8), cc = j % (BM / 8), t = t0 - 1 + r;
      const bool valid = t >= 0 && t < T;
      tc::cp16(tc::saddr(as + r * LDM + cc * 8),
               A + (base + (valid ? t : 0)) * M + m0 + cc * 8, valid);
    }
    bf16* gs = as + WG_A;
    for (int j = tid; j < WK * (BN / 8); j += THREADS) {
      const int r = j / (BN / 8), cc = j % (BN / 8), t = t0 + r;
      const bool valid = t < T;
      tc::cp16(tc::saddr(gs + r * LDN + cc * 8),
               G + (base + (valid ? t : 0)) * N + n0 + cc * 8, valid);
    }
  };
  auto compute = [&](uint32_t at, int) {
    const uint32_t gt = at + 2 * WG_A;
#pragma unroll
    for (int ks = 0; ks < WK / 16; ++ks) {
      uint32_t a[4][4], b[2][4];
      // A^T: k (rows, shifted by the tap) runs along the tile's rows
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldsm_t(a[mt], tc::b_addr<LDM>(at, 16 * ks + d, wm * 64 + 16 * mt, lane));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        tc::ldsm_t(b[nn], tc::a_addr<LDN>(gt, 16 * ks, wn * 32 + 16 * nn, lane));
      mma_step(acc, a, b);
    }
  };
  ring<WG_A + WG_G>(smem, c1 - c0, load, compute);
}

// f(r, c, nt, v0, v1) for this lane's accumulator pairs: tile row r,
// columns c and c + 1 of n8 tile nt (in the warp's order: m16 tile, row
// half, n8 tile).
template <class F>
__device__ __forceinline__ void for_pairs(const Acc& acc, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 64 + (lane >> 2), c0 = (warp & 3) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        f(r0 + 16 * mt + 8 * h, c0 + 8 * nt, nt, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

}  // namespace cftc
}  // namespace
