// C-blocked training conv feed-forward (K4), tensor-core instance, forward
// and backward, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels daft_exprt_tpu/ops/conv_ff_train.py
// _fwd_kernel_blocked, _bwd_rowlocal_kernel, _bwd_blockgrads_kernel and
// _bwd_dx_kernel (K4) on the bf16 training path; f32 dots, and bf16 with
// the rounding off (chip_smoke's control), keep the CUDA-core instance
// (conv_ff_blocked.cu), whose header states the function. Widths E = 128,
// 256, 384 or 512 and C % 128 == 0, any T >= 1. The hidden channels are
// not taken in blocks here: conv2 sums over all C in the GEMM's own order,
// which only reorders float32 sums of exact bf16 products.
//
// What bounds it on this card: operations. At the wide ablation's shape
// (B=16, T=768, E=512, C=512) the forward does 12 B T E C = 38.7 GFLOP
// against ~55 MB of compulsory traffic (39 us at the bf16 tensor-core peak
// against 16 us of HBM time), the backward three times the FLOPs.
//
// Design. Every product runs on the tensor cores: the operands are bf16
// in device memory at the Pallas rounding points -- x (the wrapper's
// x.to(bfloat16), which is rnd(x)), the weights and their tap-reversed
// transposes, h, rnd(da2) and rnd(da1) -- and mma.sync m16n8k16 sums their
// exact products in float32. Each k=3 conv is a shifted-row GEMM
// (conv_ff_tc.cuh) with an epilogue:
//
//   forward   h   = rnd(relu(conv1(rnd x) + b1))        (B, T, C) bf16
//             a2  = conv2(h) + b2                       (B, T, E) f32
//             out = gamma * LN(drop(a2) + x) + beta     row kernel
//   backward  h, a2 recomputed as above
//             dr, rnd(da2), per-tile partials of dfilm, dLN, db2 (row kernel)
//             da1 = h > 0 ? conv2^T(rnd da2) : 0, per-tile db1 partials,
//                   rnd(da1) (B, T, C) bf16
//             dx  = dr + conv1^T(rnd da1)
//             dW1[d] = shift_d(rnd x)^T rnd(da1), dW2[d] = shift_d(h)^T
//                   rnd(da2), summed over the rows in chunks
//
// The LayerNorm rows stay out of the GEMMs: a row of E = 512 columns spans
// four warps of a GEMM tile, so a row kernel (a warp a row) reads a2 back,
// 25 MB at the wide shape (~15 us of HBM time against the GEMMs' ~0.2 ms).
// No float atomics: every cross-block sum is a partial per tile or per row
// chunk, added in a fixed order (sum_rows), so two backward runs give
// bit-identical gradients.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_ff_tc.cuh"
#include "conv_ff_wgrad.cuh"
#include "dropout_hash.cuh"

namespace {

using conv_ff::warp_sum;
using tc::bf16;

constexpr float LN_EPS = 1e-5f;
constexpr int ROW_TILE = 32;  // rows of a backward row-kernel block: 8 warps x 4
constexpr int SMS = 132;      // an H100's streaming multiprocessors

int conv_tiles(int T) { return (T + cftc::BM - 1) / cftc::BM; }
int row_tiles(int T) { return (T + ROW_TILE - 1) / ROW_TILE; }

// Row chunks of one weight-gradient product: one wave of blocks at two a
// SM (fewer partials to write and sum), at most one chunk of cftc::WK rows
// each.
int wgrad_splits(int B, int T, int M, int N) {
  const int chunks = B * ((T + cftc::WK - 1) / cftc::WK);
  const int tiles = 3 * (M / cftc::BM) * (N / cftc::BN);
  const int s = 2 * SMS / tiles > 1 ? 2 * SMS / tiles : 1;
  return s < chunks ? s : chunks;
}

size_t rows_bwd_smem(int E) { return sizeof(float) * 8 * 5 * E; }

size_t smem_bytes(int E) {
  size_t m = cftc::conv_smem();
  if (cftc::wgrad_smem() > m) m = cftc::wgrad_smem();
  return rows_bwd_smem(E) > m ? rows_bwd_smem(E) : m;
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// -------------------------------------------------------------------
// The conv GEMMs. Grid (N / BN, ceil(T / BM), B), cftc::THREADS threads,
// cftc::conv_smem() bytes; the tile's rows lo .. lo + BM - 1 of batch row
// b, rows at or past T not written.
// -------------------------------------------------------------------
enum Epilogue { HIDDEN, A2, DH, DX };

struct EpiArgs {
  const float* bias;  // HIDDEN: b1; A2: b2
  const bf16* h;      // DH: the hidden (its ReLU mask)
  const float* dr;    // DX: the LayerNorm-input gradient
  bf16* out_h;        // HIDDEN: h; DH: rnd(da1)
  float* out_f;       // A2: a2; DX: dx
  float* part;        // DH: db1 partials (B * conv tiles, N)
};

template <int EPI>
__global__ void __launch_bounds__(cftc::THREADS, 2)
tc_conv_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ W, int T, int K,
                    int N, EpiArgs ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * cftc::BN, tile = blockIdx.y, lo = tile * cftc::BM;
  const size_t row0 = (size_t)blockIdx.z * T;
  cftc::Acc acc;
  cftc::conv_tile(acc, A + row0 * K, W, lo, T, K, N, n0, reinterpret_cast<bf16*>(smem));
  float colsum[4][2] = {};  // DH: this lane's columns over its rows
  cftc::for_pairs(acc, [&](int r, int c, int nt, float v0, float v1) {
    if (lo + r >= T) return;
    const size_t o = (row0 + lo + r) * N + n0 + c;
    if (EPI == HIDDEN) {
      const float2 bias = *reinterpret_cast<const float2*>(ep.bias + n0 + c);
      *reinterpret_cast<uint32_t*>(ep.out_h + o) =
          tc::pack(fmaxf(v0 + bias.x, 0.f), fmaxf(v1 + bias.y, 0.f));
    } else if (EPI == A2) {
      const float2 bias = *reinterpret_cast<const float2*>(ep.bias + n0 + c);
      *reinterpret_cast<float2*>(ep.out_f + o) = make_float2(v0 + bias.x, v1 + bias.y);
    } else if (EPI == DH) {
      // h = rnd(relu(a1)) > 0 iff a1 > 0
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ep.h + o));
      const float d0 = hv.x > 0.f ? v0 : 0.f, d1 = hv.y > 0.f ? v1 : 0.f;
      colsum[nt][0] += d0;
      colsum[nt][1] += d1;
      *reinterpret_cast<uint32_t*>(ep.out_h + o) = tc::pack(d0, d1);
    } else {
      const float2 d = *reinterpret_cast<const float2*>(ep.dr + o);
      *reinterpret_cast<float2*>(ep.out_f + o) = make_float2(d.x + v0, d.y + v1);
    }
  });
  if (EPI != DH) return;
  // db1 partial of the tile (unrounded da1): the 8 row groups of a warp by
  // butterfly, then the two warp rows, in a fixed order.
  float* red = reinterpret_cast<float*>(smem);  // [2][BN]; the ring is free
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = colsum[nt][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[(warp >> 2) * cftc::BN + (warp & 3) * 32 + 8 * nt + 2 * lane + j] = v;
    }
  __syncthreads();
  if (threadIdx.x < cftc::BN)
    ep.part[((size_t)blockIdx.z * gridDim.y + tile) * N + n0 + threadIdx.x] =
        red[threadIdx.x] + red[cftc::BN + threadIdx.x];
}

// -------------------------------------------------------------------
// Weight gradients: part[s][d][m][n] = sum over the row chunks of split s
// of A[b, t + d - 1, m] G[b, t, n]. Grid (N / BN, M / BM, 3 * splits),
// cftc::wgrad_smem() bytes.
// -------------------------------------------------------------------
__global__ void __launch_bounds__(cftc::THREADS, 2)
tc_weight_grad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ G,
                      float* __restrict__ part, int B, int T, int M, int N, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * cftc::BN, m0 = blockIdx.y * cftc::BM;
  const int d = blockIdx.z % 3, s = blockIdx.z / 3;
  const long long chunks = (long long)B * ((T + cftc::WK - 1) / cftc::WK);
  const int c0 = (int)(s * chunks / splits), c1 = (int)((s + 1) * chunks / splits);
  cftc::Acc acc;
  cftc::wgrad_tile(acc, A, G, T, M, N, m0, n0, d, c0, c1, reinterpret_cast<bf16*>(smem));
  float* dst = part + ((size_t)s * 3 + d) * M * N;
  cftc::for_pairs(acc, [&](int r, int c, int, float v0, float v1) {
    *reinterpret_cast<float2*>(dst + (size_t)(m0 + r) * N + n0 + c) = make_float2(v0, v1);
  });
}

// -------------------------------------------------------------------
// Forward rows: out = gamma * (LN(drop(a2) + x) * s + b) + beta, a warp a
// row (lane l the columns 128 j + 4 l .. + 3). Grid ceil(B T / 8), 256
// threads.
// -------------------------------------------------------------------
template <int EV>
__global__ void __launch_bounds__(256)
tc_rows_fwd_kernel(const float* __restrict__ a2, const float* __restrict__ x,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const float* __restrict__ film, const int* __restrict__ seeds,
                   float* __restrict__ out, int B, int T, Dropout drop) {
  constexpr int E = 128 * EV;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= (size_t)B * T) return;
  const int b = (int)(row / T), t = (int)(row % T);
  const uint32_t seed = (uint32_t)seeds[b];
  const float* fb = film + (size_t)b * 2 * E;
  float v[4 * EV], s = 0.f;
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const int n = 128 * j + 4 * lane;
    float av[4], xr[4];
    load4(av, a2 + row * E + n);
    load4(xr, x + row * E + n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = av[i];
      if (drop.on)
        a = dropout_bits(seed, 0u, (uint32_t)t, (uint32_t)(n + i)) >= drop.threshold
                ? a / drop.keep
                : 0.f;
      v[4 * j + i] = a + xr[i];
      s += v[4 * j + i];
    }
  }
  const float mean = warp_sum(s) / E;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
  const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
#pragma unroll
  for (int j = 0; j < EV; ++j) {
    const int n = 128 * j + 4 * lane;
    float sv[4], ov[4], gam[4], bet[4], o[4];
    load4(sv, ln_s + n);
    load4(ov, ln_b + n);
    load4(gam, fb + n);
    load4(bet, fb + E + n);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = gam[i] * ((v[4 * j + i] - mean) * inv * sv[i] + ov[i]) + bet[i];
    store4(out + row * E + n, o);
  }
}

// -------------------------------------------------------------------
// Backward rows: dr and rnd(da2) per row, and per tile of ROW_TILE rows of
// one batch row the partial sums (g * y, g | dy * n, dy, da2) over its
// rows. Grid (ceil(T / ROW_TILE), B), 256 threads, rows_bwd_smem(E)
// bytes: 8 warps x 5 sums of E, each (warp, column) one thread's, added in
// row order, then the warps in order.
// -------------------------------------------------------------------
template <int EV>
__global__ void __launch_bounds__(256, 2)
tc_rows_bwd_kernel(const float* __restrict__ a2, const float* __restrict__ x,
                   const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                   const float* __restrict__ film, const int* __restrict__ seeds,
                   const float* __restrict__ g, float* __restrict__ dr_out,
                   bf16* __restrict__ da2c, float* __restrict__ pfilm,
                   float* __restrict__ pvec, int T, Dropout drop) {
  constexpr int E = 128 * EV, RW = ROW_TILE / 8;
  const int b = blockIdx.y, tile = blockIdx.x, lo = tile * ROW_TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float red[];
  for (int i = tid; i < 8 * 5 * E; i += 256) red[i] = 0.f;
  __syncthreads();
  const uint32_t seed = (uint32_t)seeds[b];
  const float* fb = film + (size_t)b * 2 * E;
  for (int rr = 0; rr < RW; ++rr) {
    const int t = lo + warp * RW + rr;
    if (t >= T) break;  // the same for the whole warp
    const size_t row = (size_t)b * T + t;
    // Only n (in v), dn and the dropout mask stay live across the row's
    // reductions; the sums that need no dr are taken on the way.
    float v[4 * EV], dn[4 * EV], s = 0.f;
    uint32_t kept = 0;  // bit k: column k of this lane kept
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float av[4], xr[4];
      load4(av, a2 + row * E + n);
      load4(xr, x + row * E + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a = av[i];
        if (drop.on) {
          const bool keep =
              dropout_bits(seed, 0u, (uint32_t)t, (uint32_t)(n + i)) >= drop.threshold;
          kept |= (uint32_t)keep << (4 * j + i);
          a = keep ? a / drop.keep : 0.f;
        }
        v[4 * j + i] = a + xr[i];
        s += v[4 * j + i];
      }
    }
    const float mean = warp_sum(s) / E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
    float s_dn = 0.f, s_dnn = 0.f;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float sv[4], ov[4], gam[4], gr[4];
      load4(sv, ln_s + n);
      load4(ov, ln_b + n);
      load4(gam, fb + n);
      load4(gr, g + row * E + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        v[k] = (v[k] - mean) * inv;  // n
        const float y = v[k] * sv[i] + ov[i], dy = gr[i] * gam[i];
        dn[k] = dy * sv[i];
        s_dn += dn[k];
        s_dnn += dn[k] * v[k];
        float* rw = red + (size_t)warp * 5 * E + n + i;
        rw[0] += gr[i] * y;
        rw[E] += gr[i];
        rw[2 * E] += dy * v[k];
        rw[3 * E] += dy;
      }
    }
    const float m_dn = warp_sum(s_dn) / E, m_dnn = warp_sum(s_dnn) / E;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float dr[4], da2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        dr[i] = (dn[k] - m_dn - v[k] * m_dnn) * inv;
        da2[i] = drop.on ? ((kept >> k) & 1u ? dr[i] / drop.keep : 0.f) : dr[i];
        red[(size_t)warp * 5 * E + 4 * E + n + i] += da2[i];
      }
      store4(dr_out + row * E + n, dr);
      uint2 packed;
      packed.x = tc::pack(da2[0], da2[1]);
      packed.y = tc::pack(da2[2], da2[3]);
      *reinterpret_cast<uint2*>(da2c + row * E + n) = packed;
    }
  }
  __syncthreads();
  const int tiles = gridDim.x;
  for (int i = tid; i < 5 * E; i += 256) {
    const int k = i / E, c = i % E;
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += red[(w * 5 + k) * E + c];
    if (k < 2)  // dfilm: (B, tiles, 2E) [g*y | g]
      pfilm[((size_t)b * tiles + tile) * 2 * E + k * E + c] = s;
    else        // (B * tiles, 3E) [dLN scale | dLN bias | db2]
      pvec[((size_t)b * tiles + tile) * 3 * E + (k - 2) * E + c] = s;
  }
}

// -------------------------------------------------------------------
// Host side
// -------------------------------------------------------------------
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
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
  bf16 *h, *da2c, *da1c;
  float *a2, *dr, *pfilm, *pvec, *pdb1, *pw;
};

// The forward takes h and a2; the backward all of it.
Work carve(Carve& cv, int B, int T, int E, int C, bool backward) {
  const size_t bt = (size_t)B * T;
  Work w{};
  w.h = cv.take<bf16>(bt * C);
  w.a2 = cv.take<float>(bt * E);
  if (!backward) return w;
  w.dr = cv.take<float>(bt * E);
  w.da2c = cv.take<bf16>(bt * E);
  w.da1c = cv.take<bf16>(bt * C);
  w.pfilm = cv.take<float>((size_t)B * row_tiles(T) * 2 * E);
  w.pvec = cv.take<float>((size_t)B * row_tiles(T) * 3 * E);
  w.pdb1 = cv.take<float>((size_t)B * conv_tiles(T) * C);
  w.pw = cv.take<float>((size_t)wgrad_splits(B, T, E, C) * 3 * E * C);
  return w;
}

template <int EPI>
cudaError_t conv(const bf16* A, const bf16* W, int B, int T, int K, int N, EpiArgs ep,
                 cudaStream_t st) {
  cudaError_t err = allow_smem(tc_conv_gemm_kernel<EPI>, cftc::conv_smem());
  if (err != cudaSuccess) return err;
  tc_conv_gemm_kernel<EPI><<<dim3(N / cftc::BN, conv_tiles(T), B), cftc::THREADS,
                             cftc::conv_smem(), st>>>(A, W, T, K, N, ep);
  return cudaGetLastError();
}

// dW (3, M, N) = the fixed-order sum of the splits' partials.
cudaError_t weight_grad(const bf16* A, const bf16* G, float* pw, float* dw, int B, int T,
                        int M, int N, cudaStream_t st) {
  const int splits = wgrad_splits(B, T, M, N);
  cudaError_t err = allow_smem(tc_weight_grad_kernel, cftc::wgrad_smem());
  if (err != cudaSuccess) return err;
  tc_weight_grad_kernel<<<dim3(N / cftc::BN, M / cftc::BM, 3 * splits), cftc::THREADS,
                          cftc::wgrad_smem(), st>>>(A, G, pw, B, T, M, N, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_rows(pw, dw, 1, splits, 3 * M * N, st);
}

struct Args {
  const bf16 *xb, *w1, *w2;  // rnd(x) (B, T, E); W1 (3, E, C), W2 (3, C, E)
  const float *x, *b1, *b2, *ln_s, *ln_b, *film;
  const int* seeds;
  int B, T, C;
  Dropout drop;
};

template <int EV>
cudaError_t forward(const Args& a, void* ws, float* out, cudaStream_t st) {
  constexpr int E = 128 * EV;
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, a.B, a.T, E, a.C, false);
  cudaError_t err;
  if ((err = conv<HIDDEN>(a.xb, a.w1, a.B, a.T, E, a.C,
                          EpiArgs{a.b1, nullptr, nullptr, w.h, nullptr, nullptr}, st)) !=
      cudaSuccess)
    return err;
  if ((err = conv<A2>(w.h, a.w2, a.B, a.T, a.C, E,
                      EpiArgs{a.b2, nullptr, nullptr, nullptr, w.a2, nullptr}, st)) !=
      cudaSuccess)
    return err;
  const size_t rows = (size_t)a.B * a.T;
  tc_rows_fwd_kernel<EV><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      w.a2, a.x, a.ln_s, a.ln_b, a.film, a.seeds, out, a.B, a.T, a.drop);
  return cudaGetLastError();
}

template <int EV>
cudaError_t backward(const Args& a, const float* g, const bf16* w1r, const bf16* w2r,
                     void* ws, float* dx, float* dw1, float* db1, float* dw2, float* dvec,
                     float* dfilm, cudaStream_t st) {
  constexpr int E = 128 * EV;
  const int B = a.B, T = a.T, C = a.C;
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, B, T, E, C, true);
  cudaError_t err;
  if ((err = conv<HIDDEN>(a.xb, a.w1, B, T, E, C,
                          EpiArgs{a.b1, nullptr, nullptr, w.h, nullptr, nullptr}, st)) !=
      cudaSuccess)
    return err;
  if ((err = conv<A2>(w.h, a.w2, B, T, C, E,
                      EpiArgs{a.b2, nullptr, nullptr, nullptr, w.a2, nullptr}, st)) !=
      cudaSuccess)
    return err;
  if ((err = allow_smem(tc_rows_bwd_kernel<EV>, rows_bwd_smem(E))) != cudaSuccess) return err;
  tc_rows_bwd_kernel<EV><<<dim3(row_tiles(T), B), 256, rows_bwd_smem(E), st>>>(
      w.a2, a.x, a.ln_s, a.ln_b, a.film, a.seeds, g, w.dr, w.da2c, w.pfilm, w.pvec, T,
      a.drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // w2r (3, E, C): w2r[d] = W2[2 - d]^T; w1r (3, C, E): w1r[d] = W1[2 - d]^T
  if ((err = conv<DH>(w.da2c, w2r, B, T, E, C,
                      EpiArgs{nullptr, w.h, nullptr, w.da1c, nullptr, w.pdb1}, st)) !=
      cudaSuccess)
    return err;
  if ((err = conv<DX>(w.da1c, w1r, B, T, C, E,
                      EpiArgs{nullptr, nullptr, w.dr, nullptr, dx, nullptr}, st)) !=
      cudaSuccess)
    return err;
  if ((err = weight_grad(a.xb, w.da1c, w.pw, dw1, B, T, E, C, st)) != cudaSuccess) return err;
  if ((err = weight_grad(w.h, w.da2c, w.pw, dw2, B, T, C, E, st)) != cudaSuccess) return err;
  if ((err = sum_rows(w.pdb1, db1, 1, B * conv_tiles(T), C, st)) != cudaSuccess) return err;
  if ((err = sum_rows(w.pvec, dvec, 1, B * row_tiles(T), 3 * E, st)) != cudaSuccess)
    return err;
  return sum_rows(w.pfilm, dfilm, B, row_tiles(T), 2 * E, st);
}

bool takes(int B, int T, int E, int C) {
  return B > 0 && T > 0 && E % 128 == 0 && E >= 128 && E <= 512 && C > 0 && C % 128 == 0;
}

}  // namespace

// Bytes of device scratch the forward (backward = 0) or the backward needs.
extern "C" long long conv_ff_blocked_tc_workspace_bytes(int B, int T, int E, int C,
                                                        int backward) {
  if (!takes(B, T, E, C)) return -1;
  Carve cv{nullptr};
  carve(cv, B, T, E, C, backward != 0);
  return (long long)cv.used;
}

// The largest dynamic shared memory of the instance's launches at width E:
// what the wrapper's plan mirrors.
extern "C" long long conv_ff_blocked_tc_smem_bytes(int E) { return (long long)smem_bytes(E); }

// xb: rnd(x) (B, T, E) bf16; x, out (B, T, E) f32; w1 (3, E, C), w2
// (3, C, E) bf16; b1 (C,), b2, ln_s, ln_b (E,) f32; film (B, 2E); seeds
// (B,) int32; ws: conv_ff_blocked_tc_workspace_bytes(B, T, E, C, 0) bytes.
// Every pointer 16-byte aligned.
extern "C" int conv_ff_blocked_tc_forward(const void* xb, const float* x, const void* w1,
                                          const float* b1, const void* w2, const float* b2,
                                          const float* ln_s, const float* ln_b,
                                          const float* film, const int* seeds, void* ws,
                                          float* out, int B, int T, int E, int C,
                                          int use_dropout, unsigned int threshold,
                                          float keep, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!takes(B, T, E, C)) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(xb), static_cast<const bf16*>(w1),
               static_cast<const bf16*>(w2), x, b1, b2, ln_s, ln_b, film, seeds, B, T, C,
               Dropout{use_dropout != 0, threshold, keep}};
  switch (E) {
    case 128: return forward<1>(a, ws, out, stream);
    case 256: return forward<2>(a, ws, out, stream);
    case 384: return forward<3>(a, ws, out, stream);
    default: return forward<4>(a, ws, out, stream);
  }
}

// g: (B, T, E) f32 cotangent; w1r (3, C, E), w2r (3, E, C) bf16 the
// tap-reversed transposes; ws: conv_ff_blocked_tc_workspace_bytes(B, T, E,
// C, 1) bytes. Outputs (f32): dx (B, T, E); dw1 (3, E, C); db1 (C,); dw2
// (3, C, E); dvec (3E,) = [dLN scale | dLN bias | db2]; dfilm (B, 2E).
extern "C" int conv_ff_blocked_tc_backward(
    const void* xb, const float* x, const void* w1, const float* b1, const void* w2,
    const float* b2, const float* ln_s, const float* ln_b, const float* film,
    const int* seeds, const float* g, const void* w1r, const void* w2r, void* ws, float* dx,
    float* dw1, float* db1, float* dw2, float* dvec, float* dfilm, int B, int T, int E,
    int C, int use_dropout, unsigned int threshold, float keep, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!takes(B, T, E, C)) return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(xb), static_cast<const bf16*>(w1),
               static_cast<const bf16*>(w2), x, b1, b2, ln_s, ln_b, film, seeds, B, T, C,
               Dropout{use_dropout != 0, threshold, keep}};
  const bf16 *w1t = static_cast<const bf16*>(w1r), *w2t = static_cast<const bf16*>(w2r);
  switch (E) {
    case 128:
      return backward<1>(a, g, w1t, w2t, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    case 256:
      return backward<2>(a, g, w1t, w2t, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    case 384:
      return backward<3>(a, g, w1t, w2t, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    default:
      return backward<4>(a, g, w1t, w2t, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
  }
}
