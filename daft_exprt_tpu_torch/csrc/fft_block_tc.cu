// Fused FFT block forward (inference), tensor-core instance, for Hopper,
// sm_90a.
//
// Replaces the Pallas TPU kernel daft_exprt_tpu/ops/fft_block.py:_kernel
// (K1) on the bf16 serving and evaluation path; float32 dots (and
// chip_smoke's control, the rounding off) keep the CUDA-core instance,
// fft_block.cu, whose header states the function. Widths E = 128, 256 or
// 512, head dims D = E / H in {16, 64, 128}, conv channels C % 128 == 0,
// any T >= 1, valid lengths per row clamped to [0, T].
//
// What bounds it on this card: operations. At the frame decoder's shape
// (B=8, T=512, E=128, C=1024) the block does ~8 GFLOP, 6.4 of them in the
// two convs, against ~5 MB of compulsory traffic (x and out in float32,
// the bf16 weights): ~8 us at the bf16 tensor-core peak against ~1.5 us
// of HBM time.
//
// Design. Every product runs on mma.sync m16n8k16 bf16 -> f32 with its
// operands bf16 at the Pallas kernel's rounding points, so each product is
// the Pallas kernel's. The tensor cores' own accumulation is not rounded to
// nearest: chained over a long K their sums drift further from the exact
// ones than float32 sums do, which then flips more bf16 roundings
// downstream. So each k16 step's 16 products are summed from zero and
// added by a rounded float32 add (tc::mma_rn), and only the order of the
// float32 sums differs from the Pallas kernel's (chip_smoke's k1_variants
// times the chained sums against this):
//
//   1. qkv_tc_kernel     q | k | v = rnd(rnd(x) Wqkv + bqkv)    (B T, 3E) bf16
//   2. attn_tc_kernel    ctx = rnd(P v), P = rnd(softmax_{key < len}(q k^T / sqrt D))
//   3. outproj_tc_kernel a = mask(LN1(ctx Wo + bo + x))  (B T, E) f32 and rnd(a) bf16
//      (+ ln1_rows_kernel at E = 256, 512)
//   4. conv_tc_kernel<HIDDEN>  h = rnd(relu(conv1(rnd a) + b1))    (B, T, C) bf16
//   5. conv_tc_kernel<A2>      conv2(h) + b2 as split-K partials    float32
//   6. ln2_rows_kernel   out = mask(FiLM(LN2(sum of the partials + a)))
//
// The projections are GEMMs over the B T rows (tiles may span batch rows):
// 128 x 128 tiles of 8 warps, K in chunks of 32 through the 3-stage
// cp.async ring of conv_ff_tc.cuh; x is rounded to bf16 as it is staged.
// At E = 128 one tile holds whole rows, so LN1 runs in the out-projection's
// epilogue on a float32 tile in shared memory; at E = 256 and 512 a row
// kernel (a warp a row) reads the pre-LN rows back. Attention is K2's
// tensor-core forward at rate 0 (attention_tc.cuh): 4 warps own 64 query
// rows of one head and stream 64-key tiles twice (row max and sum, then
// the normalised P rounded before PV); query tiles at or past the length
// are skipped. The convs are the shifted-row GEMM cores of conv_ff_tc.cuh
// (tiles inside one batch row, halo rows zero outside [0, T)); tiles whose
// rows reach no output row below the length are skipped. conv2 (N = E)
// splits K over C where its tiles alone would leave SMs idle
// (cftc::conv_splits: the phoneme encoder's 8 tiles at T=64), and the
// row kernel adds the float32 partials in split order: no atomics, so two
// runs give bit-identical output. Rows that a skipped tile leaves unwritten
// reach only rows at or past the length, which the row kernels overwrite
// with zeros (a select, never a product). Each kernel's dynamic
// shared-memory limit is raised once, not at every call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "conv_ff_tc.cuh"
#include "conv_ff_tile.cuh"

namespace {

using cftc::BM;
using cftc::BN;
using conv_ff::warp_sum;
using tc::bf16;

constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ int row_length(const int* lengths, int b, int T) {
  const int n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : n);
}

// -------------------------------------------------------------------
// Row work: a warp owns a row of E = 128 EV floats, lane l the columns
// 128 j + 4 l .. + 3 (v[4 j ..]).
// -------------------------------------------------------------------
template <int EV>
__device__ __forceinline__ void layer_norm(float (&v)[4 * EV], const float* __restrict__ s,
                                           const float* __restrict__ o, int lane) {
  constexpr int E = 128 * EV;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * EV; ++i) sum += v[i];
  const float mean = warp_sum(sum) / E;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
  const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const int n = 128 * j + 4 * lane;
    const float4 s4 = *reinterpret_cast<const float4*>(s + n);
    const float4 o4 = *reinterpret_cast<const float4*>(o + n);
    v[4 * j] = (v[4 * j] - mean) * inv * s4.x + o4.x;
    v[4 * j + 1] = (v[4 * j + 1] - mean) * inv * s4.y + o4.y;
    v[4 * j + 2] = (v[4 * j + 2] - mean) * inv * s4.z + o4.z;
    v[4 * j + 3] = (v[4 * j + 3] - mean) * inv * s4.w + o4.w;
  }
}

// The LN1 output of one row, zero where !valid: float32 (the residual of
// LN2) and rounded to bf16 (conv1's operand).
template <int EV>
__device__ __forceinline__ void store_attn(const float (&v)[4 * EV], bool valid,
                                           float* __restrict__ af, bf16* __restrict__ ab,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const int n = 128 * j + 4 * lane;
    const float4 y = valid ? make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(af + n) = y;
    *reinterpret_cast<uint2*>(ab + n) = make_uint2(tc::pack(y.x, y.y), tc::pack(y.z, y.w));
  }
}

// -------------------------------------------------------------------
// The projections: acc = sum_k A[m0 + r][k] W[k][n0 + c] over this warp's
// rows r and columns c of the tile; A (M, K) with rows at or past M read
// as zero, bf16 (copied by cp.async) or float32 (rounded to bf16 as it is
// staged: rnd(x)); W (K, N) bf16. K % 32 == 0, N % 128 == 0.
// -------------------------------------------------------------------
constexpr int PROJ_A = BM * cftc::LDC, PROJ_W = cftc::CK * cftc::LDN;
constexpr size_t PROJ_SMEM = (size_t)cftc::STAGES * (PROJ_A + PROJ_W) * sizeof(bf16);
// At E = 128 the out-projection's epilogue stages its 128 x 128 float32
// tile in the ring's shared memory, rows padded by 4 floats.
constexpr int LN_LD = BN + 4;
constexpr size_t LN_TILE_SMEM = (size_t)BM * LN_LD * sizeof(float);
constexpr size_t OUTPROJ128_SMEM = LN_TILE_SMEM > PROJ_SMEM ? LN_TILE_SMEM : PROJ_SMEM;

__device__ __forceinline__ void stage_a(bf16* dst, const bf16* src, bool valid) {
  tc::cp16(tc::saddr(dst), src, valid);
}

__device__ __forceinline__ void stage_a(bf16* dst, const float* src, bool valid) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (valid) {
    lo = *reinterpret_cast<const float4*>(src);
    hi = *reinterpret_cast<const float4*>(src + 4);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(tc::pack(lo.x, lo.y), tc::pack(lo.z, lo.w),
                                              tc::pack(hi.x, hi.y), tc::pack(hi.z, hi.w));
}

template <bool RN, typename In>
__device__ __forceinline__ void proj_tile(cftc::Acc& acc, const In* __restrict__ A,
                                          const bf16* __restrict__ W, int M, int K, int N,
                                          int m0, int n0, bf16* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  cftc::zero(acc);
  auto load = [&](bf16* as, int i) {
    const int k0 = i * cftc::CK;
    for (int j = tid; j < BM * (cftc::CK / 8); j += cftc::THREADS) {
      const int r = j / (cftc::CK / 8), c = j % (cftc::CK / 8);
      const bool valid = m0 + r < M;
      stage_a(as + r * cftc::LDC + c * 8, A + (size_t)(valid ? m0 + r : 0) * K + k0 + c * 8,
              valid);
    }
    bf16* ws = as + PROJ_A;
    for (int j = tid; j < cftc::CK * (BN / 8); j += cftc::THREADS) {
      const int r = j / (BN / 8), c = j % (BN / 8);
      tc::cp16(tc::saddr(ws + r * cftc::LDN + c * 8), W + (size_t)(k0 + r) * N + n0 + c * 8,
               true);
    }
  };
  auto compute = [&](uint32_t at, int) {
    const uint32_t wt = at + 2 * PROJ_A;
#pragma unroll
    for (int ks = 0; ks < cftc::CK / 16; ++ks) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        tc::ldsm(a[mt], tc::a_addr<cftc::LDC>(at, wm * 64 + 16 * mt, 16 * ks, lane));
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        tc::ldsm_t(b[nn], tc::a_addr<cftc::LDN>(wt, 16 * ks, wn * 32 + 16 * nn, lane));
      cftc::mma_step<RN>(acc, a, b);
    }
  };
  cftc::ring<PROJ_A + PROJ_W>(smem, K / cftc::CK, load, compute);
}

// -------------------------------------------------------------------
// 1. q | k | v = rnd(rnd(x) Wqkv + bqkv) over the M = B T rows. Grid
//    (3E / 128, ceil(M / 128)), cftc::THREADS threads, PROJ_SMEM bytes.
// -------------------------------------------------------------------
template <int E, bool RN>
__global__ void __launch_bounds__(cftc::THREADS, 2)
qkv_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
              const float* __restrict__ bias, bf16* __restrict__ qkv, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  cftc::Acc acc;
  proj_tile<RN>(acc, x, w, M, E, 3 * E, m0, n0, reinterpret_cast<bf16*>(smem));
  cftc::for_pairs(acc, [&](int r, int c, int, float v0, float v1) {
    if (m0 + r >= M) return;
    const float2 b = *reinterpret_cast<const float2*>(bias + n0 + c);
    *reinterpret_cast<uint32_t*>(qkv + (size_t)(m0 + r) * 3 * E + n0 + c) =
        tc::pack(v0 + b.x, v1 + b.y);
  });
}

// -------------------------------------------------------------------
// 2. Attention of one head over the keys below the row's length, from the
//    packed q | k | v rows (stride 3E): K2's tensor-core forward at rate 0,
//    without the row statistics its backward reads. Grid (ceil(T / 64), H,
//    B), tc::THREADS threads, tc::key_smem<D>() bytes; warp w owns query
//    rows q0 + 16 w .. + 15. Pass 1: row max and sum over key tiles of 64;
//    pass 2: P = exp(s - m) / max(l, 1e-30) rounded, PV. ctx = rnd(PV)
//    (B T, E) bf16; query tiles at or past the length are not computed.
// -------------------------------------------------------------------
template <int D, bool RN>
__global__ void __launch_bounds__(tc::THREADS)
attn_tc_kernel(const bf16* __restrict__ qkv, const int* __restrict__ lengths,
               bf16* __restrict__ ctx, int T, int E, float scale) {
  using namespace tc;
  constexpr int TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // two stages
  bf16* Vs = Ks + 2 * TE;                      // two stages
  bf16* Qs = Vs;  // until pass 2 streams V, which pass 1 does not read
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int len = row_length(lengths, b, T);
  if (q0 >= len) return;  // rows the LN1 mask zeroes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = q0 + 16 * warp;  // the warp's first row; this lane's: + g, + g + 8
  const int ntiles = (len + TILE - 1) / TILE;
  const int S = 3 * E;
  const bf16 *qb = qkv + (size_t)b * T * S, *kb = qb + E, *vb = qb + 2 * E;

  load_tile<D>(Qs, qb, q0, T, S, h);
  load_tile<D>(Ks, kb, 0, T, S, h);
  cp_commit();

  uint32_t qf[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, S, h);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (j == 0) load_a<D>(qf, saddr(Qs), 16 * warp, lane);
    const uint32_t kt = saddr(Ks + (j & 1) * TE);
    float s[TILE / 16][2][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      scores16<D, RN>(s[c], qf, kt, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * TILE + 16 * c + 8 * n + 2 * t + (e & 1);
          const float x = col < len ? s[c][n][e] * scale : -INFINITY;
          s[c][n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // m stays -inf while every column was masked
      l[r] = mx[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[c][n][e] - m[e >> 1]);
          l[e >> 1] += s[c][n][e] == -INFINITY ? 0.f : x;
        }
    __syncthreads();
  }
  // The four lanes of a quad hold disjoint columns of the same two rows.
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mn = fmaxf(m[r], mo);
      l[r] = (m[r] == -INFINITY ? 0.f : l[r] * expf(m[r] - mn)) +
             (mo == -INFINITY ? 0.f : lo * expf(mo - mn));
      m[r] = mn;
    }

  load_tile<D>(Ks, kb, 0, T, S, h);
  load_tile<D>(Vs, vb, 0, T, S, h);
  cp_commit();
  const float inv_l[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, S, h);
      load_tile<D>(Vs + ((j + 1) & 1) * TE, vb, (j + 1) * TILE, T, S, h);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = saddr(Ks + (j & 1) * TE), vt = saddr(Vs + (j & 1) * TE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      const int k0 = j * TILE + 16 * c;
      float s[2][4];
      scores16<D, RN>(s, qf, kt, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1), r = e >> 1;
          const float p = expf(s[n][e] * scale - m[r]) * inv_l[r];
          s[n][e] = col < len ? p : 0.f;  // a select: no branch in the tile
        }
      uint32_t a[4];
      acc_to_a(a, s[0], s[1]);  // rnd(P)
      accumulate16<D, RN>(acc, a, vt, 16 * c, lane);
    }
    __syncthreads();
  }
  store_rows<D>(ctx + (size_t)b * T * E, acc, r0, T, E, h, lane);  // rnd(ctx)
}

// -------------------------------------------------------------------
// 3. pre = ctx Wo + bo + x over the M = B T rows, then attn = mask(LN1(pre))
//    in float32 and rnd(attn) in bf16, zero at and past each row's length
//    (rows of ctx there may be unwritten: they reach only their own row).
//    Grid (E / 128, ceil(M / 128)). At E = 128 the epilogue stages pre in
//    shared memory and finishes LN1 (a warp 16 rows; OUTPROJ128_SMEM
//    bytes); at E = 256, 512 it writes pre (M, E) for ln1_rows_kernel
//    (PROJ_SMEM bytes).
// -------------------------------------------------------------------
template <int E, bool RN>
__global__ void __launch_bounds__(cftc::THREADS, 2)
outproj_tc_kernel(const bf16* __restrict__ ctx, const bf16* __restrict__ wo,
                  const float* __restrict__ bo, const float* __restrict__ x,
                  const int* __restrict__ lengths, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, float* __restrict__ pre,
                  float* __restrict__ attn, bf16* __restrict__ attn_b, int T, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  cftc::Acc acc;
  proj_tile<RN>(acc, ctx, wo, M, E, E, m0, n0, reinterpret_cast<bf16*>(smem));
  float* vt = reinterpret_cast<float*>(smem);  // the ring is free now
  cftc::for_pairs(acc, [&](int r, int c, int, float v0, float v1) {
    if (m0 + r >= M) return;
    const size_t o = (size_t)(m0 + r) * E + n0 + c;
    const float2 b = *reinterpret_cast<const float2*>(bo + n0 + c);
    const float2 xr = *reinterpret_cast<const float2*>(x + o);
    const float2 v = make_float2(v0 + b.x + xr.x, v1 + b.y + xr.y);
    if (E > BN)
      *reinterpret_cast<float2*>(pre + o) = v;
    else
      *reinterpret_cast<float2*>(vt + r * LN_LD + c) = v;
  });
  if (E > BN) return;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = 0; i < BM / 8; ++i) {
    const int r = warp * (BM / 8) + i, row = m0 + r;
    if (row >= M) break;  // the same for the whole warp
    float v[4];
    const float4 p = *reinterpret_cast<const float4*>(vt + r * LN_LD + 4 * lane);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    layer_norm<1>(v, ln_s, ln_b, lane);
    const int b = row / T;
    store_attn<1>(v, row - b * T < row_length(lengths, b, T), attn + (size_t)row * E,
                  attn_b + (size_t)row * E, lane);
  }
}

// attn = mask(LN1(pre)) a warp a row (E = 256, 512). Grid ceil(M / 8), 256
// threads.
template <int EV>
__global__ void __launch_bounds__(256)
ln1_rows_kernel(const float* __restrict__ pre, const int* __restrict__ lengths,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                float* __restrict__ attn, bf16* __restrict__ attn_b, int T, int M) {
  constexpr int E = 128 * EV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const int b = row / T;
  const bool valid = row - b * T < row_length(lengths, b, T);
  float v[4 * EV];
#pragma unroll
  for (int i = 0; i < 4 * EV; ++i) v[i] = 0.f;
  if (valid) {
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(pre + (size_t)row * E + 128 * j + 4 * lane);
      v[4 * j] = p.x; v[4 * j + 1] = p.y; v[4 * j + 2] = p.z; v[4 * j + 3] = p.w;
    }
    layer_norm<EV>(v, ln_s, ln_b, lane);
  }
  store_attn<EV>(v, valid, attn + (size_t)row * E, attn_b + (size_t)row * E, lane);
}

// -------------------------------------------------------------------
// 4, 5. The k=3 convs as shifted-row GEMMs inside one batch row. Grid
//    (N / 128, ceil(T / 128), B x splits), cftc::conv_smem() bytes.
//    HIDDEN (K = E, N = C, one split): h = rnd(relu(conv1(rnd a) + b1)),
//    tiles past the length skipped (a hidden row past it reaches only
//    output rows at or past it). A2 (K = C, N = E): split s sums its run
//    of K's chunks into part + s B T E, split 0 adding b2; tiles at or
//    past the length skipped.
// -------------------------------------------------------------------
enum ConvEpi { HIDDEN, A2 };

template <int EPI, bool RN>
__global__ void __launch_bounds__(cftc::THREADS, 2)
conv_tc_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W,
               const float* __restrict__ bias, const int* __restrict__ lengths, int T, int K,
               int N, int splits, bf16* __restrict__ out_h, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, lo = blockIdx.y * BM;
  const int b = blockIdx.z / splits, split = blockIdx.z % splits;
  const int len = row_length(lengths, b, T);
  if (EPI == HIDDEN ? (len == 0 || lo > len) : lo >= len) return;
  const int chunks = K / cftc::CK;
  const size_t row0 = (size_t)b * T;
  cftc::Acc acc;
  cftc::conv_tile<RN>(acc, A + row0 * K, W, lo, T, K, N, n0, reinterpret_cast<bf16*>(smem),
                  split * chunks / splits, (split + 1) * chunks / splits);
  float* out_f = part + (size_t)split * (gridDim.z / splits) * T * N;
  cftc::for_pairs(acc, [&](int r, int c, int, float v0, float v1) {
    if (lo + r >= T) return;
    const size_t o = (row0 + lo + r) * N + n0 + c;
    const float2 bb = EPI == HIDDEN || split == 0
                          ? *reinterpret_cast<const float2*>(bias + n0 + c)
                          : make_float2(0.f, 0.f);
    if (EPI == HIDDEN)
      *reinterpret_cast<uint32_t*>(out_h + o) =
          tc::pack(fmaxf(v0 + bb.x, 0.f), fmaxf(v1 + bb.y, 0.f));
    else
      *reinterpret_cast<float2*>(out_f + o) = make_float2(v0 + bb.x, v1 + bb.y);
  });
}

// -------------------------------------------------------------------
// 6. out = mask(FiLM(LN2(sum of the splits' partials + attn))), a warp a
//    row, the partials added in split order; FiLM rows film_stride floats
//    apart (null: the identity). Grid ceil(M / 8), 256 threads.
// -------------------------------------------------------------------
template <int EV>
__global__ void __launch_bounds__(256)
ln2_rows_kernel(const float* __restrict__ part, int splits, const float* __restrict__ attn,
                const int* __restrict__ lengths, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const float* __restrict__ film,
                int film_stride, float* __restrict__ out, int T, int M) {
  constexpr int E = 128 * EV;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= M) return;
  const int b = row / T;
  float* dst = out + (size_t)row * E;
  if (row - b * T >= row_length(lengths, b, T)) {
#pragma unroll
    for (int j = 0; j < EV; ++j)
      *reinterpret_cast<float4*>(dst + 128 * j + 4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float v[4 * EV];
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const size_t o = (size_t)row * E + 128 * j + 4 * lane;
    float4 s = *reinterpret_cast<const float4*>(part + o);
    for (int k = 1; k < splits; ++k) {
      const float4 p = *reinterpret_cast<const float4*>(part + (size_t)k * M * E + o);
      s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
    }
    const float4 a = *reinterpret_cast<const float4*>(attn + o);
    v[4 * j] = s.x + a.x; v[4 * j + 1] = s.y + a.y;
    v[4 * j + 2] = s.z + a.z; v[4 * j + 3] = s.w + a.w;
  }
  layer_norm<EV>(v, ln_s, ln_b, lane);
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const int n = 128 * j + 4 * lane;
    float4 y = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    if (film != nullptr) {
      const float* fb = film + (size_t)b * film_stride;
      const float4 g = *reinterpret_cast<const float4*>(fb + n);
      const float4 be = *reinterpret_cast<const float4*>(fb + E + n);
      y = make_float4(g.x * y.x + be.x, g.y * y.y + be.y, g.z * y.z + be.z, g.w * y.w + be.w);
    }
    *reinterpret_cast<float4*>(dst + n) = y;
  }
}

// -------------------------------------------------------------------
// Host side
// -------------------------------------------------------------------
// A kernel's dynamic shared-memory limit, raised only when a launch needs
// more than an earlier one (allowed: the caller's static record of it).
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Consecutive pieces of one workspace, each 256-byte aligned; from a null
// base it only counts the bytes.
struct Carve {
  char* p;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    T* r = p ? reinterpret_cast<T*>(p + used) : nullptr;
    used += (n * sizeof(T) + 255) / 256 * 256;
    return r;
  }
};

struct Work {
  bf16 *qkv, *ctx, *attn_b, *h;
  float *attn, *pre, *part;
};

Work carve(Carve& cv, int B, int T, int E, int C) {
  const size_t m = (size_t)B * T;
  Work w{};
  w.qkv = cv.take<bf16>(m * 3 * E);
  w.ctx = cv.take<bf16>(m * E);
  w.attn_b = cv.take<bf16>(m * E);
  w.h = cv.take<bf16>(m * C);
  w.attn = cv.take<float>(m * E);
  w.pre = E > BN ? cv.take<float>(m * E) : nullptr;
  w.part = cv.take<float>((size_t)cftc::conv_splits(B, T, C, E) * m * E);
  return w;
}

struct Args {
  const float* x;
  const int* lengths;
  const bf16 *wqkv, *wo, *w1, *w2;
  const float *bqkv, *bo, *ln1_s, *ln1_b, *b1, *b2, *ln2_s, *ln2_b, *film;
  int film_stride, B, T, C, H;
};

template <int D, bool RN>
cudaError_t attention(const bf16* qkv, const int* lengths, bf16* ctx, int B, int T, int E,
                      cudaStream_t st) {
  static size_t allowed = 0;
  const size_t bytes = tc::key_smem<D>();
  cudaError_t err = allow_smem(attn_tc_kernel<D, RN>, bytes, allowed);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  attn_tc_kernel<D, RN><<<dim3((T + tc::ROWS - 1) / tc::ROWS, E / D, B), tc::THREADS, bytes, st>>>(
      qkv, lengths, ctx, T, E, scale);
  return cudaGetLastError();
}

template <int EV, bool RN>
cudaError_t forward(const Args& a, void* ws, float* out, cudaStream_t st) {
  constexpr int E = 128 * EV;
  constexpr size_t outproj_smem = E > BN ? PROJ_SMEM : OUTPROJ128_SMEM;
  static size_t qkv_allowed = 0, outproj_allowed = 0, hidden_allowed = 0, a2_allowed = 0;
  const int B = a.B, T = a.T, C = a.C, M = B * T;
  const int mtiles = (M + BM - 1) / BM, ctiles = cftc::conv_tiles(T);
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, B, T, E, C);
  cudaError_t err;

  if ((err = allow_smem(qkv_tc_kernel<E, RN>, PROJ_SMEM, qkv_allowed)) != cudaSuccess)
    return err;
  qkv_tc_kernel<E, RN><<<dim3(3 * E / BN, mtiles), cftc::THREADS, PROJ_SMEM, st>>>(
      a.x, a.wqkv, a.bqkv, w.qkv, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  switch (E / a.H) {
    case 16: err = attention<16, RN>(w.qkv, a.lengths, w.ctx, B, T, E, st); break;
    case 64: err = attention<64, RN>(w.qkv, a.lengths, w.ctx, B, T, E, st); break;
    case 128: err = attention<128, RN>(w.qkv, a.lengths, w.ctx, B, T, E, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;

  if ((err = allow_smem(outproj_tc_kernel<E, RN>, outproj_smem, outproj_allowed)) !=
      cudaSuccess)
    return err;
  outproj_tc_kernel<E, RN><<<dim3(E / BN, mtiles), cftc::THREADS, outproj_smem, st>>>(
      w.ctx, a.wo, a.bo, a.x, a.lengths, a.ln1_s, a.ln1_b, w.pre, w.attn, w.attn_b, T, M);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (E > BN) {
    ln1_rows_kernel<EV><<<(M + 7) / 8, 256, 0, st>>>(w.pre, a.lengths, a.ln1_s, a.ln1_b,
                                                      w.attn, w.attn_b, T, M);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  const size_t conv_smem = cftc::conv_smem();
  if ((err = allow_smem(conv_tc_kernel<HIDDEN, RN>, conv_smem, hidden_allowed)) !=
      cudaSuccess)
    return err;
  conv_tc_kernel<HIDDEN, RN><<<dim3(C / BN, ctiles, B), cftc::THREADS, conv_smem, st>>>(
      w.attn_b, a.w1, a.b1, a.lengths, T, E, C, 1, w.h, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const int splits = cftc::conv_splits(B, T, C, E);
  if ((err = allow_smem(conv_tc_kernel<A2, RN>, conv_smem, a2_allowed)) != cudaSuccess)
    return err;
  conv_tc_kernel<A2, RN><<<dim3(E / BN, ctiles, B * splits), cftc::THREADS, conv_smem, st>>>(
      w.h, a.w2, a.b2, a.lengths, T, C, E, splits, nullptr, w.part);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  ln2_rows_kernel<EV><<<(M + 7) / 8, 256, 0, st>>>(w.part, splits, w.attn, a.lengths, a.ln2_s,
                                                    a.ln2_b, a.film, a.film_stride, out, T, M);
  return cudaGetLastError();
}

bool takes(int B, int T, int E, int C, int H) {
  const int D = H > 0 && E % H == 0 ? E / H : 0;
  return B > 0 && T > 0 && (E == 128 || E == 256 || E == 512) &&
         (D == 16 || D == 64 || D == 128) && C > 0 && C % 128 == 0;
}

size_t smem_bytes(int E, int H) {
  size_t m = cftc::conv_smem();
  const size_t outproj = E > BN ? PROJ_SMEM : OUTPROJ128_SMEM;
  size_t attn = 0;
  switch (E / H) {
    case 16: attn = tc::key_smem<16>(); break;
    case 64: attn = tc::key_smem<64>(); break;
    case 128: attn = tc::key_smem<128>(); break;
  }
  if (outproj > m) m = outproj;  // >= PROJ_SMEM
  return attn > m ? attn : m;
}

}  // namespace

// Bytes of device scratch one call needs (-1 outside the instance).
extern "C" long long fft_block_tc_workspace_bytes(int B, int T, int E, int C, int H) {
  if (!takes(B, T, E, C, H)) return -1;
  Carve cv{nullptr};
  carve(cv, B, T, E, C);
  return (long long)cv.used;
}

// The largest dynamic shared memory of the instance's launches at width E
// and H heads: what the wrapper's plan mirrors (0 outside the instance).
extern "C" long long fft_block_tc_smem_bytes(int E, int H, int C) {
  return takes(1, 1, E, C, H) ? (long long)smem_bytes(E, H) : 0;
}

// x, out (B, T, E) f32; wqkv (E, 3E), wo (E, E), w1 (3, E, C), w2 (3, C,
// E) bf16 "in x out"; the vectors f32; film (B rows film_stride floats
// apart, [gammas | betas]) or null; lengths (B,) int32; ws:
// fft_block_tc_workspace_bytes bytes. Every pointer 16-byte aligned.
// Returns the first CUDA error (0 on success). rounded_sums 0 chains every
// product's float32 sum inside mma.sync (chip_smoke's timing of that
// design choice; no path of the port takes it).
extern "C" int fft_block_tc_forward_variant(
    const float* x, const int* lengths, const void* wqkv, const float* bqkv, const void* wo,
    const float* bo, const float* ln1_s, const float* ln1_b, const void* w1, const float* b1,
    const void* w2, const float* b2, const float* ln2_s, const float* ln2_b,
    const float* film, int film_stride, void* ws, float* out, int B, int T, int E, int C,
    int H, int rounded_sums, void* stream_handle) {
  if (!takes(B, T, E, C, H)) return cudaErrorInvalidValue;
  const Args a{x,     lengths, static_cast<const bf16*>(wqkv), static_cast<const bf16*>(wo),
               static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), bqkv, bo,
               ln1_s, ln1_b, b1,   b2,  ln2_s, ln2_b, film, film_stride, B, T, C, H};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  const bool rn = rounded_sums != 0;
  switch (E) {
    case 128: return rn ? forward<1, true>(a, ws, out, st) : forward<1, false>(a, ws, out, st);
    case 256: return rn ? forward<2, true>(a, ws, out, st) : forward<2, false>(a, ws, out, st);
    default: return rn ? forward<4, true>(a, ws, out, st) : forward<4, false>(a, ws, out, st);
  }
}

// The instance: every product's k16 term added by a rounded float32 add.
extern "C" int fft_block_tc_forward(const float* x, const int* lengths, const void* wqkv,
                                    const float* bqkv, const void* wo, const float* bo,
                                    const float* ln1_s, const float* ln1_b, const void* w1,
                                    const float* b1, const void* w2, const float* b2,
                                    const float* ln2_s, const float* ln2_b, const float* film,
                                    int film_stride, void* ws, float* out, int B, int T, int E,
                                    int C, int H, void* stream_handle) {
  return fft_block_tc_forward_variant(x, lengths, wqkv, bqkv, wo, bo, ln1_s, ln1_b, w1, b1,
                                      w2, b2, ln2_s, ln2_b, film, film_stride, ws, out, B, T,
                                      E, C, H, 1, stream_handle);
}
