// Training attention core, forward and backward, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels daft_exprt_tpu/ops/attention_train.py
// _fwd_kernel and _bwd_kernel (K2). For each batch row b (valid key
// count len_b), head h and query row i, with D = E / H (16, 64 or 128;
// E is a runtime width):
//
//   p_ij   = exp(s_ij - m_i) / max(l_i, 1e-30),  s_ij = q_i . k_j / sqrt(D)
//            over keys j < len_b (masked keys have exactly zero weight)
//   pd_ij  = keep_ij ? p_ij * (1 / (1 - rate)) : 0
//   out_i  = sum_j rnd(pd_ij) v_j                               (f32)
//
// and the backward, with g rounded per head (gr = rnd(g)):
//
//   dv_j   = sum_i rnd(pd_ij) gr_i
//   dp_ij  = keep_ij ? (gr_i . v_j) / (1 - rate) : 0   (multiplied by 1/keep)
//   delta_i = sum_j dp_ij p_ij
//   ds_ij  = rnd(p_ij (dp_ij - delta_i) / sqrt(D))
//   dq_i   = sum_j ds_ij rnd(k_j),   dk_j = sum_i ds_ij rnd(q_i)
//
// rnd() rounds to bfloat16 at bf16 dot precision (identity at f32), at
// the points where the Pallas kernels cast to their dot dtype; q/k/v
// arrive in the compute dtype (float32 or bfloat16), and dq/dk/dv leave
// in it. The logits take q and k as they arrive; dq and dk take k and q
// rounded (rnd(k_j), rnd(q_i) above), as the Pallas backward casts them
// (a no-op on bfloat16 q/k/v). delta is the JAX kernels' sum of dp * p
// (attention_train.py:185), not FlashAttention-2's rowsum(g * out):
// at bf16 the two differ because pd was rounded before PV.
//
// A row with len <= 0 has all logits equal in the JAX function (every
// key takes finfo.min), i.e. uniform weights over all T keys; the kernels
// give the same by taking every key with logit 0.
//
// Dropout masks are bit-equal to the JAX ones: keep_ij hashes (seed_b,
// salt = h * (T / TQ) + i / TQ, row i, col j) with TQ = pick_q_tile(T),
// the JAX kernels' query tile, whatever the tiling here.
//
// What bounds it on this card: at the flagship training shape (B=16,
// T=768, E=128) the forward does 4.8 GFLOP against ~16 MB of compulsory
// traffic, right of the ridge: operations. The design keeps the traffic
// compulsory: nothing of size T x T reaches device memory in either
// direction. The forward streams key tiles through shared memory twice
// (row max and sum, then probabilities times values: one online pass
// would round exp(s - m_running) instead of the normalised, dropped
// probability that the Pallas kernel rounds) and leaves the row max and
// sum (B, H, T) f32 for the backward; the backward is two launches that
// recompute P from q, k and those stats: one per query tile (delta, then
// dq), one per key tile (dk and dv, streaming query tiles).
//
// Two instances, chosen by dtype (the wrapper's plan_attention mirrors
// the choice and the shared-memory bytes):
// - bf16 I/O with bf16 rounding, the training path: tensor cores (the tc
//   namespace below). Every product's operands are bf16 values at the
//   points the Pallas kernel rounds them, and every product accumulates in
//   f32, so mma.sync m16n8k16 bf16 -> f32 computes the same products; only
//   the order of the f32 sums changes. A block of 4 warps owns 64 query
//   rows (forward, dq) or 64 key rows (dk-dv), 16 per warp; S, P and dP
//   stay in accumulator fragments, re-packed as the A operand of the next
//   product; the streamed 64-row tiles are bf16 in dynamic shared memory,
//   double-buffered with cp.async, rows padded by 16 bytes so that
//   ldmatrix is free of bank conflicts. mma.sync rather than wgmma: per
//   score, the exp, division, mask and dropout hash on the CUDA cores
//   weigh as much as the 2 D FLOPs of each product at D <= 128.
// - f32 I/O, and bf16 I/O with rounding off (the control of the bf16
//   limits): CUDA-core FMAs over f32 tiles (tensor cores cannot give the
//   f32 path its 1e-5 tolerance). G = D / 16 lanes share a row, 128 / G
//   rows per 128-thread block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "dropout_hash.cuh"

namespace {

// Key rows (forward, dq) and query rows (dk/dv) per shared-memory tile:
// two f32 tiles of 64 x D take 64 KB at D = 128, over the 48 KB of static
// shared memory, so that width takes 32 rows.
template <int G>
__host__ __device__ constexpr int rows_per_tile() { return G == 8 ? 32 : 64; }

__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

struct Dropout {
  bool on;            // rate > 0
  uint32_t threshold; // keep iff bits >= threshold
  float inv_keep;     // 1 / (1 - rate), as the JAX kernels multiply
};

// G lanes share one row; lane g owns dims g*16 .. g*16+15 of the head.
template <int G>
__device__ __forceinline__ float dot16(const float* a, const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = b4[i];
    s = fmaf(a[4 * i], v.x, s);
    s = fmaf(a[4 * i + 1], v.y, s);
    s = fmaf(a[4 * i + 2], v.z, s);
    s = fmaf(a[4 * i + 3], v.w, s);
  }
#pragma unroll
  for (int o = 1; o < G; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Four consecutive elements as float4: q/k/v (and dq/dk/dv) are float or
// bfloat16 in device memory (the compute dtype), float in registers and
// shared memory. bfloat16 stores round to nearest even, as torch's cast.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename In>
__device__ __forceinline__ void load16(float* dst, const In* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = load4(src + 4 * i);
    dst[4 * i] = v.x; dst[4 * i + 1] = v.y; dst[4 * i + 2] = v.z; dst[4 * i + 3] = v.w;
  }
}

template <typename Out>
__device__ __forceinline__ void store16(Out* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    store4(dst + 4 * i, make_float4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]));
}

// rows [r0, r0 + n) of head h of a (T, E) matrix into dst[n][D]; rows at
// or past T read as zero. Optionally rounded (the cotangent).
template <int D, typename In>
__device__ __forceinline__ void load_rows(float (*dst)[D], const In* src, int r0,
                                          int n, int T, int E, int h, bool round,
                                          bool bf16) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < n * V4; i += blockDim.x) {
    const int j = i / V4, c = i % V4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + j < T) v = load4(src + (size_t)(r0 + j) * E + h * D + 4 * c);
    if (round) {
      v.x = rnd(v.x, bf16); v.y = rnd(v.y, bf16);
      v.z = rnd(v.z, bf16); v.w = rnd(v.w, bf16);
    }
    reinterpret_cast<float4*>(dst[j])[c] = v;
  }
}

__device__ __forceinline__ int key_count(const int* lengths, int b, int T, bool* uniform) {
  const int n = lengths[b];
  *uniform = n <= 0;
  return n <= 0 ? T : (n > T ? T : n);
}

// -------------------------------------------------------------------
// Forward. Grid (ceil(T/QT), H, B), 128 threads, QT = 128/G query rows.
// -------------------------------------------------------------------
template <int G, typename In>
__global__ void __launch_bounds__(128)
attn_fwd_kernel(const In* __restrict__ q, const In* __restrict__ k,
                const In* __restrict__ v, const int* __restrict__ lengths,
                const int* __restrict__ seeds, float* __restrict__ out,
                float* __restrict__ row_max, float* __restrict__ row_sum, int T,
                int E, int tq, float scale, Dropout drop, bool bf16) {
  constexpr int D = 16 * G, QT = 128 / G, KT = rows_per_tile<G>();
  const int H = E / D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, g = tid % G, row = q0 + tid / G;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const size_t base = (size_t)b * T * E;

  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];

  float qr[16];
  if (row < T) {
    load16(qr, q + base + (size_t)row * E + h * D + g * 16);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = 0.f;
  }
  const uint32_t seed = (uint32_t)seeds[b];
  const uint32_t salt = (uint32_t)(h * (T / tq) + row / tq);

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < nkeys; k0 += KT) {
    const int nk = min(KT, nkeys - k0);
    __syncthreads();
    load_rows<D, In>(Ks, k + base, k0, nk, T, E, h, false, bf16);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = uniform ? 0.f : dot16<G>(qr, &Ks[j][g * 16]) * scale;
      if (s > m) {
        l = l * expf(m - s) + 1.f;
        m = s;
      } else {
        l += expf(s - m);
      }
    }
  }
  const float denom = fmaxf(l, 1e-30f);

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < nkeys; k0 += KT) {
    const int nk = min(KT, nkeys - k0);
    __syncthreads();
    load_rows<D, In>(Ks, k + base, k0, nk, T, E, h, false, bf16);
    load_rows<D, In>(Vs, v + base, k0, nk, T, E, h, false, bf16);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = uniform ? 0.f : dot16<G>(qr, &Ks[j][g * 16]) * scale;
      float p = expf(s - m) / denom;
      if (drop.on)
        p = dropout_bits(seed, salt, row, k0 + j) >= drop.threshold ? p * drop.inv_keep : 0.f;
      p = rnd(p, bf16);
      const float4* vr = reinterpret_cast<const float4*>(&Vs[j][g * 16]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 vv = vr[i];
        acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }
  if (row < T) {
    store16(out + base + (size_t)row * E + h * D + g * 16, acc);
    if (g == 0) {
      row_max[((size_t)b * H + h) * T + row] = m;
      row_sum[((size_t)b * H + h) * T + row] = l;
    }
  }
}

// -------------------------------------------------------------------
// Backward 1: delta and dq per query row. Same grid as the forward.
// -------------------------------------------------------------------
template <int G, typename In>
__global__ void __launch_bounds__(128)
attn_bwd_dq_kernel(const In* __restrict__ q, const In* __restrict__ k,
                   const In* __restrict__ v, const float* __restrict__ go,
                   const int* __restrict__ lengths, const int* __restrict__ seeds,
                   const float* __restrict__ row_max, const float* __restrict__ row_sum,
                   float* __restrict__ delta, In* __restrict__ dq, int T, int E, int tq,
                   float scale, Dropout drop, bool bf16) {
  constexpr int D = 16 * G, QT = 128 / G, KT = rows_per_tile<G>();
  const int H = E / D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int tid = threadIdx.x, g = tid % G, row = q0 + tid / G;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const size_t base = (size_t)b * T * E;

  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];

  float qr[16], gr[16];
  float m = 0.f, denom = 1.f;
  if (row < T) {
    load16(qr, q + base + (size_t)row * E + h * D + g * 16);
    load16(gr, go + base + (size_t)row * E + h * D + g * 16);
#pragma unroll
    for (int i = 0; i < 16; ++i) gr[i] = rnd(gr[i], bf16);
    m = row_max[((size_t)b * H + h) * T + row];
    denom = fmaxf(row_sum[((size_t)b * H + h) * T + row], 1e-30f);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) qr[i] = gr[i] = 0.f;
  }
  const uint32_t seed = (uint32_t)seeds[b];
  const uint32_t salt = (uint32_t)(h * (T / tq) + row / tq);

  // recompute p and dp for key j of the current tile
  auto p_dp = [&](int j, int col, float* p_out) {
    const float s = uniform ? 0.f : dot16<G>(qr, &Ks[j][g * 16]) * scale;
    const float p = expf(s - m) / denom;
    float dp = dot16<G>(gr, &Vs[j][g * 16]);
    if (drop.on)
      dp = dropout_bits(seed, salt, row, col) >= drop.threshold ? dp * drop.inv_keep : 0.f;
    *p_out = p;
    return dp;
  };

  float dsum = 0.f;
  for (int k0 = 0; k0 < nkeys; k0 += KT) {
    const int nk = min(KT, nkeys - k0);
    __syncthreads();
    load_rows<D, In>(Ks, k + base, k0, nk, T, E, h, false, bf16);
    load_rows<D, In>(Vs, v + base, k0, nk, T, E, h, false, bf16);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float p;
      const float dp = p_dp(j, k0 + j, &p);
      dsum = fmaf(dp, p, dsum);
    }
  }

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < nkeys; k0 += KT) {
    const int nk = min(KT, nkeys - k0);
    __syncthreads();
    load_rows<D, In>(Ks, k + base, k0, nk, T, E, h, false, bf16);
    load_rows<D, In>(Vs, v + base, k0, nk, T, E, h, false, bf16);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float p;
      const float dp = p_dp(j, k0 + j, &p);
      const float ds = rnd(p * (dp - dsum) * scale, bf16);
      const float4* kr = reinterpret_cast<const float4*>(&Ks[j][g * 16]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 kk = kr[i];
        acc[4 * i] = fmaf(ds, rnd(kk.x, bf16), acc[4 * i]);
        acc[4 * i + 1] = fmaf(ds, rnd(kk.y, bf16), acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(ds, rnd(kk.z, bf16), acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(ds, rnd(kk.w, bf16), acc[4 * i + 3]);
      }
    }
  }
  if (row < T) {
    store16(dq + base + (size_t)row * E + h * D + g * 16, acc);
    if (g == 0) delta[((size_t)b * H + h) * T + row] = dsum;
  }
}

// -------------------------------------------------------------------
// Backward 2: dk and dv per key row. Grid (ceil(T/KR), H, B), 128
// threads, KR = 128/G key rows; query tiles stream through shared memory.
// -------------------------------------------------------------------
template <int G, typename In>
__global__ void __launch_bounds__(128)
attn_bwd_dkdv_kernel(const In* __restrict__ q, const In* __restrict__ k,
                     const In* __restrict__ v, const float* __restrict__ go,
                     const int* __restrict__ lengths, const int* __restrict__ seeds,
                     const float* __restrict__ row_max, const float* __restrict__ row_sum,
                     const float* __restrict__ delta, In* __restrict__ dk,
                     In* __restrict__ dv, int T, int E, int tq, float scale, Dropout drop,
                     bool bf16) {
  constexpr int D = 16 * G, KR = 128 / G, QTB = rows_per_tile<G>();
  const int H = E / D;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * KR;
  const int tid = threadIdx.x, g = tid % G, col = k0 + tid / G;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const size_t base = (size_t)b * T * E;
  const size_t stat = ((size_t)b * H + h) * T;

  float dka[16], dva[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) dka[i] = dva[i] = 0.f;
  // Keys at or past the count have zero probability for every query:
  // their gradients are zero.
  if (k0 >= nkeys) {
    if (col < T) {
      store16(dk + base + (size_t)col * E + h * D + g * 16, dka);
      store16(dv + base + (size_t)col * E + h * D + g * 16, dva);
    }
    return;
  }

  __shared__ __align__(16) float Qs[QTB][D];
  __shared__ __align__(16) float Gs[QTB][D];
  __shared__ float Ms[QTB], Ls[QTB], Ds[QTB];

  float kr[16], vr[16];
  const bool live = col < nkeys;
  if (live) {
    load16(kr, k + base + (size_t)col * E + h * D + g * 16);
    load16(vr, v + base + (size_t)col * E + h * D + g * 16);
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) kr[i] = vr[i] = 0.f;
  }
  const uint32_t seed = (uint32_t)seeds[b];
  const int tiles_per_head = T / tq;

  for (int i0 = 0; i0 < T; i0 += QTB) {
    const int nq = min(QTB, T - i0);
    __syncthreads();
    load_rows<D, In>(Qs, q + base, i0, nq, T, E, h, false, bf16);
    load_rows<D, float>(Gs, go + base, i0, nq, T, E, h, true, bf16);
    for (int i = tid; i < nq; i += blockDim.x) {
      Ms[i] = row_max[stat + i0 + i];
      Ls[i] = fmaxf(row_sum[stat + i0 + i], 1e-30f);
      Ds[i] = delta[stat + i0 + i];
    }
    __syncthreads();
    for (int ii = 0; ii < nq; ++ii) {
      const int row = i0 + ii;
      const float sc = uniform ? 0.f : dot16<G>(kr, &Qs[ii][g * 16]) * scale;
      float p = live ? expf(sc - Ms[ii]) / Ls[ii] : 0.f;
      float dp = dot16<G>(vr, &Gs[ii][g * 16]);
      float pd = p;
      if (drop.on) {
        const bool keep = dropout_bits(seed, (uint32_t)(h * tiles_per_head + row / tq),
                                       (uint32_t)row, (uint32_t)col) >= drop.threshold;
        pd = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      pd = rnd(pd, bf16);
      const float ds = rnd(p * (dp - Ds[ii]) * scale, bf16);
      const float* qrow = &Qs[ii][g * 16];
      const float* grow = &Gs[ii][g * 16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        dva[i] = fmaf(pd, grow[i], dva[i]);
        dka[i] = fmaf(ds, rnd(qrow[i], bf16), dka[i]);
      }
    }
  }
  if (col < T) {
    store16(dk + base + (size_t)col * E + h * D + g * 16, dka);
    store16(dv + base + (size_t)col * E + h * D + g * 16, dva);
  }
}

// -------------------------------------------------------------------
// Tensor-core instance: bf16 q/k/v, bf16 rounding at the Pallas points.
// -------------------------------------------------------------------
namespace tc {

// Dynamic shared memory of dk-dv (the wrapper's plan_attention mirrors
// it, the largest of the instance's launches): K, V + 2 x (Q, G) + 2 x
// the query rows' terms (row max, 1 / row sum, delta, dropout row term).
// The forward's and dq's, key_smem, is in attention_tc.cuh.
constexpr int QTERMS = 4;
template <int D>
constexpr size_t dkdv_smem() {
  return 6 * tile_elems<D>() * sizeof(bf16) + 2 * QTERMS * TILE * sizeof(float);
}

// The per-row terms of queries [i0, i0 + TILE) (row max, row sum, delta
// of one (b, h)) into dst[0..3][TILE]; rows past T read as zero.
__device__ __forceinline__ void load_stats(float* dst, const float* row_max,
                                           const float* row_sum, const float* delta,
                                           int i0, int T) {
  for (int i = threadIdx.x; i < 3 * TILE; i += THREADS) {
    const int which = i / TILE, r = i % TILE;
    const bool valid = i0 + r < T;
    const float* src = which == 0 ? row_max : which == 1 ? row_sum : delta;
    cp4(saddr(dst + i), src + (valid ? i0 + r : 0), valid);
  }
}

// -------------------------------------------------------------------
// Forward. Grid (ceil(T/64), H, B), 128 threads; warp w owns query rows
// q0 + 16 w .. + 15. Pass 1: row max and sum over key tiles of 64; pass
// 2: P, dropout, rounding, PV. Key tiles past the length are not read.
// -------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ lengths,
                   const int* __restrict__ seeds, float* __restrict__ out,
                   float* __restrict__ row_max, float* __restrict__ row_sum, int T, int E,
                   int tq, float scale, Dropout drop) {
  constexpr int TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // two stages
  bf16* Vs = Ks + 2 * TE;                      // two stages
  bf16* Qs = Vs;  // until pass 2 streams V, which pass 1 does not read
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = q0 + 16 * warp;  // the warp's first row; this lane's: + g, + g + 8
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const int ntiles = (nkeys + TILE - 1) / TILE;
  const size_t base = (size_t)b * T * E;
  const bf16 *qb = q + base, *kb = k + base, *vb = v + base;

  load_tile<D>(Qs, qb, q0, T, E, h);
  load_tile<D>(Ks, kb, 0, T, E, h);
  cp_commit();

  uint32_t qf[D / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, E, h);
    cp_commit();
    cp_wait_one();
    __syncthreads();
    if (j == 0) load_a<D>(qf, saddr(Qs), 16 * warp, lane);
    const uint32_t kt = saddr(Ks + (j & 1) * TE);
    float s[TILE / 16][2][4];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      scores16<D>(s[c], qf, kt, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * TILE + 16 * c + 8 * n + 2 * t + (e & 1);
          const float x = col < nkeys ? (uniform ? 0.f : s[c][n][e] * scale) : -INFINITY;
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

  load_tile<D>(Ks, kb, 0, T, E, h);
  load_tile<D>(Vs, vb, 0, T, E, h);
  cp_commit();
  const uint32_t seed = (uint32_t)seeds[b];
  float inv_l[2];
  uint32_t rowterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    inv_l[r] = 1.f / fmaxf(l[r], 1e-30f);
    rowterm[r] = dropout_row(seed, (uint32_t)(h * (T / tq) + row / tq), (uint32_t)row);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, E, h);
      load_tile<D>(Vs + ((j + 1) & 1) * TE, vb, (j + 1) * TILE, T, E, h);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = saddr(Ks + (j & 1) * TE), vt = saddr(Vs + (j & 1) * TE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      const int k0 = j * TILE + 16 * c;
      float s[2][4];
      scores16<D>(s, qf, kt, 16 * c, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1), r = e >> 1;
          float p = expf((uniform ? 0.f : s[n][e] * scale) - m[r]) * inv_l[r];
          if (drop.on)
            p = dropout_mix(rowterm[r] + dropout_col(col)) >= drop.threshold
                    ? p * drop.inv_keep
                    : 0.f;
          s[n][e] = col < nkeys ? p : 0.f;  // a select: no branch in the tile
        }
      uint32_t a[4];
      acc_to_a(a, s[0], s[1]);  // rnd(pd)
      accumulate16<D>(acc, a, vt, 16 * c, lane);
    }
    __syncthreads();
  }
  store_rows<D>(out + base, acc, r0, T, E, h, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + (lane >> 2) + 8 * r;
      if (row < T) {
        row_max[((size_t)b * H + h) * T + row] = m[r];
        row_sum[((size_t)b * H + h) * T + row] = l[r];
      }
    }
  }
}

// -------------------------------------------------------------------
// Backward 1: delta and dq. Grid and rows as the forward; gr is the
// cotangent already rounded to bf16 (the wrapper's one conversion).
// Pass 1: delta_i = sum_j dp_ij p_ij; pass 2: ds, dq += ds K.
// -------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ gr,
                      const int* __restrict__ lengths, const int* __restrict__ seeds,
                      const float* __restrict__ row_max, const float* __restrict__ row_sum,
                      float* __restrict__ delta, bf16* __restrict__ dq, int T, int E, int tq,
                      float scale, Dropout drop) {
  constexpr int TE = tile_elems<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // two stages
  bf16* Vs = Ks + 2 * TE;                      // two stages
  bf16 *Qs = Ks + TE, *Gs = Vs + TE;  // in stage 1 until the fragments are read
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane & 3;
  const int r0 = q0 + 16 * warp;
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const int ntiles = (nkeys + TILE - 1) / TILE;
  const size_t base = (size_t)b * T * E, stat = ((size_t)b * H + h) * T;
  const bf16 *kb = k + base, *vb = v + base;

  load_tile<D>(Qs, q + base, q0, T, E, h);
  load_tile<D>(Gs, gr + base, q0, T, E, h);
  load_tile<D>(Ks, kb, 0, T, E, h);
  load_tile<D>(Vs, vb, 0, T, E, h);
  cp_commit();
  uint32_t qf[D / 16][4], gf[D / 16][4];
  cp_wait_all();
  __syncthreads();
  load_a<D>(qf, saddr(Qs), 16 * warp, lane);
  load_a<D>(gf, saddr(Gs), 16 * warp, lane);
  __syncthreads();  // stage 1 is free for key tile 1

  const uint32_t seed = (uint32_t)seeds[b];
  float m[2], inv_l[2];
  uint32_t rowterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (lane >> 2) + 8 * r;
    m[r] = row < T ? row_max[stat + row] : 0.f;
    inv_l[r] = row < T ? 1.f / fmaxf(row_sum[stat + row], 1e-30f) : 1.f;
    rowterm[r] = dropout_row(seed, (uint32_t)(h * (T / tq) + row / tq), (uint32_t)row);
  }

  // p (undropped) and dp (dropped) of the 16 keys at tile row c0.
  auto p_dp = [&](float (&s)[2][4], float (&dp)[2][4], uint32_t kt, uint32_t vt, int c0,
                  int k0) {
    scores16<D>(s, qf, kt, c0, lane);
    scores16<D>(dp, gf, vt, c0, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1), r = e >> 1;
        const float p = expf((uniform ? 0.f : s[n][e] * scale) - m[r]) * inv_l[r];
        float d = dp[n][e];
        if (drop.on)
          d = dropout_mix(rowterm[r] + dropout_col(col)) >= drop.threshold
                  ? d * drop.inv_keep
                  : 0.f;
        s[n][e] = col < nkeys ? p : 0.f;
        dp[n][e] = col < nkeys ? d : 0.f;
      }
  };

  float dsum[2] = {0.f, 0.f};
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, E, h);
      load_tile<D>(Vs + ((j + 1) & 1) * TE, vb, (j + 1) * TILE, T, E, h);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = saddr(Ks + (j & 1) * TE), vt = saddr(Vs + (j & 1) * TE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      float s[2][4], dp[2][4];
      p_dp(s, dp, kt, vt, 16 * c, j * TILE + 16 * c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(dp[n][e], s[n][e], dsum[e >> 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 1);
    dsum[r] += __shfl_xor_sync(0xffffffffu, dsum[r], 2);
  }

  load_tile<D>(Ks, kb, 0, T, E, h);
  load_tile<D>(Vs, vb, 0, T, E, h);
  cp_commit();
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_tile<D>(Ks + ((j + 1) & 1) * TE, kb, (j + 1) * TILE, T, E, h);
      load_tile<D>(Vs + ((j + 1) & 1) * TE, vb, (j + 1) * TILE, T, E, h);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t kt = saddr(Ks + (j & 1) * TE), vt = saddr(Vs + (j & 1) * TE);
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      float s[2][4], dp[2][4];
      p_dp(s, dp, kt, vt, 16 * c, j * TILE + 16 * c);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = s[n][e] * (dp[n][e] - dsum[e >> 1]) * scale;
      uint32_t a[4];
      acc_to_a(a, s[0], s[1]);  // ds = rnd(p (dp - delta) / sqrt(D))
      accumulate16<D>(acc, a, kt, 16 * c, lane);
    }
    __syncthreads();
  }
  store_rows<D>(dq + base, acc, r0, T, E, h, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + (lane >> 2) + 8 * r;
      if (row < T) delta[stat + row] = dsum[r];
    }
  }
}

// -------------------------------------------------------------------
// Backward 2: dk and dv. Grid (ceil(T/64), H, B), 128 threads; warp w owns
// key rows k0 + 16 w .. + 15 and works on the transposed products: S^T =
// K Q^T and dP^T = V G^T per 16 queries, then dv += rnd(pd)^T G and dk +=
// ds^T Q. Query tiles of 64 (with their row max, sum and delta) stream
// through shared memory.
// -------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ gr,
                        const int* __restrict__ lengths, const int* __restrict__ seeds,
                        const float* __restrict__ row_max, const float* __restrict__ row_sum,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int T, int E, int tq, float scale,
                        Dropout drop) {
  constexpr int TE = tile_elems<D>(), LD = ld<D>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TE;
  bf16* Qs = Vs + TE;      // two stages
  bf16* Gs = Qs + 2 * TE;  // two stages
  float* St = reinterpret_cast<float*>(Gs + 2 * TE);  // two stages of [QTERMS][TILE]
  const int H = E / D, b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int kw = k0 + 16 * warp;  // the warp's first key
  bool uniform;
  const int nkeys = key_count(lengths, b, T, &uniform);
  const size_t base = (size_t)b * T * E, stat = ((size_t)b * H + h) * T;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  // Keys at or past the count have zero probability for every query:
  // their gradients are zero.
  if (k0 >= nkeys) {
    store_rows<D>(dk + base, dka, kw, T, E, h, lane);
    store_rows<D>(dv + base, dva, kw, T, E, h, lane);
    return;
  }

  const bf16 *qb = q + base, *gb = gr + base;
  load_tile<D>(Ks, k + base, k0, T, E, h);
  load_tile<D>(Vs, v + base, k0, T, E, h);
  load_tile<D>(Qs, qb, 0, T, E, h);
  load_tile<D>(Gs, gb, 0, T, E, h);
  load_stats(St, row_max + stat, row_sum + stat, delta + stat, 0, T);  // stage 0
  cp_commit();

  const uint32_t seed = (uint32_t)seeds[b];
  const int tiles_per_head = T / tq;
  const bool warp_live = kw < nkeys;
  bool key_live[2];
  uint32_t keyterm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_live[r] = kw + g + 8 * r < nkeys;
    keyterm[r] = dropout_col((uint32_t)(kw + g + 8 * r));
  }
  const uint32_t kt = saddr(Ks), vt = saddr(Vs);
  const int nq = (T + TILE - 1) / TILE;
  for (int i = 0; i < nq; ++i) {
    if (i + 1 < nq) {
      const int st = (i + 1) & 1;
      load_tile<D>(Qs + st * TE, qb, (i + 1) * TILE, T, E, h);
      load_tile<D>(Gs + st * TE, gb, (i + 1) * TILE, T, E, h);
      load_stats(St + st * QTERMS * TILE, row_max + stat, row_sum + stat, delta + stat,
                 (i + 1) * TILE, T);
    }
    cp_commit();
    cp_wait_one();
    __syncthreads();
    const uint32_t qt = saddr(Qs + (i & 1) * TE), gt = saddr(Gs + (i & 1) * TE);
    float* S = St + (i & 1) * QTERMS * TILE;
    uint32_t* R = reinterpret_cast<uint32_t*>(S + 3 * TILE);
    // once per query of the tile: 1 / row sum, and the dropout hash's row term
    if (threadIdx.x < TILE) {
      const int row = i * TILE + threadIdx.x;
      S[TILE + threadIdx.x] = 1.f / fmaxf(S[TILE + threadIdx.x], 1e-30f);
      R[threadIdx.x] =
          dropout_row(seed, (uint32_t)(h * tiles_per_head + row / tq), (uint32_t)row);
    }
    __syncthreads();
    if (warp_live) {
#pragma unroll
      for (int c = 0; c < TILE / 16; ++c) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t a[4], bq[4];
          ldsm(a, a_addr<LD>(kt, 16 * warp, ks * 16, lane));
          ldsm(bq, b_addr<LD>(qt, 16 * c, ks * 16, lane));
          mma(s[0], a, bq[0], bq[1]);
          mma(s[1], a, bq[2], bq[3]);
          ldsm(a, a_addr<LD>(vt, 16 * warp, ks * 16, lane));
          ldsm(bq, b_addr<LD>(gt, 16 * c, ks * 16, lane));
          mma(dp[0], a, bq[0], bq[1]);
          mma(dp[1], a, bq[2], bq[3]);
        }
        // fragment rows are keys (g, g + 8), columns queries (2t, 2t + 1)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int ql = 16 * c + 8 * n + 2 * t + cc, row = i * TILE + ql;
            const float mq = S[ql], inv_l = S[TILE + ql], dl = S[2 * TILE + ql];
            const uint32_t rowterm = R[ql];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int e = 2 * r + cc;
              const float p = expf((uniform ? 0.f : s[n][e] * scale) - mq) * inv_l;
              float pd = p, d = dp[n][e];
              if (drop.on) {
                const bool keep = dropout_mix(rowterm + keyterm[r]) >= drop.threshold;
                pd = keep ? p * drop.inv_keep : 0.f;
                d = keep ? d * drop.inv_keep : 0.f;
              }
              const bool live = row < T && key_live[r];
              s[n][e] = live ? pd : 0.f;
              dp[n][e] = live ? p * (d - dl) * scale : 0.f;
            }
          }
        uint32_t apd[4], ads[4];
        acc_to_a(apd, s[0], s[1]);   // rnd(pd)^T
        acc_to_a(ads, dp[0], dp[1]);  // rnd(ds)^T
        accumulate16<D>(dva, apd, gt, 16 * c, lane);
        accumulate16<D>(dka, ads, qt, 16 * c, lane);
      }
    }
    __syncthreads();
  }
  store_rows<D>(dk + base, dka, kw, T, E, h, lane);
  store_rows<D>(dv + base, dva, kw, T, E, h, lane);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
int forward(const bf16* q, const bf16* k, const bf16* v, const int* lengths,
            const int* seeds, float* out, float* row_max, float* row_sum, int B, int T,
            int E, int H, int tq, float scale, Dropout drop, cudaStream_t stream) {
  const size_t bytes = key_smem<D>();
  cudaError_t err = allow_smem(attn_fwd_tc_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  attn_fwd_tc_kernel<D><<<dim3((T + ROWS - 1) / ROWS, H, B), THREADS, bytes, stream>>>(
      q, k, v, lengths, seeds, out, row_max, row_sum, T, E, tq, scale, drop);
  return cudaGetLastError();
}

template <int D>
int backward(const bf16* q, const bf16* k, const bf16* v, const bf16* gr,
             const int* lengths, const int* seeds, const float* row_max,
             const float* row_sum, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int T,
             int E, int H, int tq, float scale, Dropout drop, cudaStream_t stream) {
  const dim3 grid((T + ROWS - 1) / ROWS, H, B);
  cudaError_t err = allow_smem(attn_bwd_dq_tc_kernel<D>, key_smem<D>());
  if (err != cudaSuccess) return err;
  attn_bwd_dq_tc_kernel<D><<<grid, THREADS, key_smem<D>(), stream>>>(
      q, k, v, gr, lengths, seeds, row_max, row_sum, delta, dq, T, E, tq, scale, drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(attn_bwd_dkdv_tc_kernel<D>, dkdv_smem<D>())) != cudaSuccess)
    return err;
  attn_bwd_dkdv_tc_kernel<D><<<grid, THREADS, dkdv_smem<D>(), stream>>>(
      q, k, v, gr, lengths, seeds, row_max, row_sum, delta, dk, dv, T, E, tq, scale, drop);
  return cudaGetLastError();
}

int launch_forward(const void* q, const void* k, const void* v, const int* lengths,
                   const int* seeds, float* out, float* row_max, float* row_sum, int B,
                   int T, int E, int H, int tq, float scale, Dropout drop,
                   cudaStream_t stream) {
  const bf16 *qi = static_cast<const bf16*>(q), *ki = static_cast<const bf16*>(k),
             *vi = static_cast<const bf16*>(v);
  switch (E / H) {
    case 16:
      return forward<16>(qi, ki, vi, lengths, seeds, out, row_max, row_sum, B, T, E, H, tq,
                         scale, drop, stream);
    case 64:
      return forward<64>(qi, ki, vi, lengths, seeds, out, row_max, row_sum, B, T, E, H, tq,
                         scale, drop, stream);
    case 128:
      return forward<128>(qi, ki, vi, lengths, seeds, out, row_max, row_sum, B, T, E, H, tq,
                          scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_backward(const void* q, const void* k, const void* v, const void* gr,
                    const int* lengths, const int* seeds, const float* row_max,
                    const float* row_sum, float* delta, void* dq, void* dk, void* dv, int B,
                    int T, int E, int H, int tq, float scale, Dropout drop,
                    cudaStream_t stream) {
  const bf16 *qi = static_cast<const bf16*>(q), *ki = static_cast<const bf16*>(k),
             *vi = static_cast<const bf16*>(v), *gi = static_cast<const bf16*>(gr);
  bf16 *dqi = static_cast<bf16*>(dq), *dki = static_cast<bf16*>(dk),
       *dvi = static_cast<bf16*>(dv);
  switch (E / H) {
    case 16:
      return backward<16>(qi, ki, vi, gi, lengths, seeds, row_max, row_sum, delta, dqi, dki,
                          dvi, B, T, E, H, tq, scale, drop, stream);
    case 64:
      return backward<64>(qi, ki, vi, gi, lengths, seeds, row_max, row_sum, delta, dqi, dki,
                          dvi, B, T, E, H, tq, scale, drop, stream);
    case 128:
      return backward<128>(qi, ki, vi, gi, lengths, seeds, row_max, row_sum, delta, dqi, dki,
                           dvi, B, T, E, H, tq, scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int D) {
  switch (D) {
    case 16: return dkdv_smem<16>();
    case 64: return dkdv_smem<64>();
    case 128: return dkdv_smem<128>();
    default: return 0;
  }
}

static_assert(dkdv_smem<128>() >= key_smem<128>(),
              "dk-dv takes the most shared memory");
static_assert(dkdv_smem<128>() <= 227 * 1024, "a block's shared memory on an H100");

}  // namespace tc

template <typename In>
int launch_forward(const void* q, const void* k, const void* v, const int* lengths,
                   const int* seeds, float* out, float* row_max, float* row_sum, int B,
                   int T, int E, int H, int tq, float scale, Dropout drop, bool bf16,
                   cudaStream_t stream) {
  const In *qi = static_cast<const In*>(q), *ki = static_cast<const In*>(k),
           *vi = static_cast<const In*>(v);
  switch (E / H) {
    case 16:
      attn_fwd_kernel<1, In><<<dim3((T + 127) / 128, H, B), 128, 0, stream>>>(
          qi, ki, vi, lengths, seeds, out, row_max, row_sum, T, E, tq, scale, drop, bf16);
      break;
    case 64:
      attn_fwd_kernel<4, In><<<dim3((T + 31) / 32, H, B), 128, 0, stream>>>(
          qi, ki, vi, lengths, seeds, out, row_max, row_sum, T, E, tq, scale, drop, bf16);
      break;
    case 128:
      attn_fwd_kernel<8, In><<<dim3((T + 15) / 16, H, B), 128, 0, stream>>>(
          qi, ki, vi, lengths, seeds, out, row_max, row_sum, T, E, tq, scale, drop, bf16);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int G, typename In>
int launch_backward_g(const In* q, const In* k, const In* v, const float* g,
                      const int* lengths, const int* seeds, const float* row_max,
                      const float* row_sum, float* delta, In* dq, In* dk, In* dv, int B,
                      int T, int E, int H, int tq, float scale, Dropout drop, bool bf16,
                      cudaStream_t stream) {
  constexpr int R = 128 / G;  // query rows (dq) or key rows (dk, dv) per block
  attn_bwd_dq_kernel<G, In><<<dim3((T + R - 1) / R, H, B), 128, 0, stream>>>(
      q, k, v, g, lengths, seeds, row_max, row_sum, delta, dq, T, E, tq, scale, drop, bf16);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<G, In><<<dim3((T + R - 1) / R, H, B), 128, 0, stream>>>(
      q, k, v, g, lengths, seeds, row_max, row_sum, delta, dk, dv, T, E, tq, scale, drop,
      bf16);
  return cudaGetLastError();
}

template <typename In>
int launch_backward(const void* q, const void* k, const void* v, const float* g,
                    const int* lengths, const int* seeds, const float* row_max,
                    const float* row_sum, float* delta, void* dq, void* dk, void* dv, int B,
                    int T, int E, int H, int tq, float scale, Dropout drop, bool bf16,
                    cudaStream_t stream) {
  const In *qi = static_cast<const In*>(q), *ki = static_cast<const In*>(k),
           *vi = static_cast<const In*>(v);
  In *dqi = static_cast<In*>(dq), *dki = static_cast<In*>(dk), *dvi = static_cast<In*>(dv);
  switch (E / H) {
    case 16:
      return launch_backward_g<1, In>(qi, ki, vi, g, lengths, seeds, row_max, row_sum,
                                      delta, dqi, dki, dvi, B, T, E, H, tq, scale, drop,
                                      bf16, stream);
    case 64:
      return launch_backward_g<4, In>(qi, ki, vi, g, lengths, seeds, row_max, row_sum,
                                      delta, dqi, dki, dvi, B, T, E, H, tq, scale, drop,
                                      bf16, stream);
    case 128:
      return launch_backward_g<8, In>(qi, ki, vi, g, lengths, seeds, row_max, row_sum,
                                      delta, dqi, dki, dvi, B, T, E, H, tq, scale, drop,
                                      bf16, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v: (B, T, E), float32 or (io_bf16) bfloat16; out: (B, T, E) f32;
// lengths, seeds: (B,) int32; row_max, row_sum: (B, H, T) f32 outputs.
// The wrapper checks the shapes, that E / H is 16, 64 or 128, that tq
// divides T and (tensor-core instance) that q/k/v are 16-byte aligned.
// bf16 I/O with bf16 rounding takes the tensor-core instance, the rest the
// CUDA-core one. Returns the first CUDA error.
extern "C" int attention_train_forward(const void* q, const void* k, const void* v,
                                       const int* lengths, const int* seeds, float* out,
                                       float* row_max, float* row_sum, int B, int T,
                                       int E, int H, int tq, float scale, int use_dropout,
                                       unsigned int threshold, float inv_keep,
                                       int round_bf16, int io_bf16, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Dropout drop{use_dropout != 0, threshold, inv_keep};
  const bool bf16 = round_bf16 != 0;
  if (io_bf16 && bf16)
    return tc::launch_forward(q, k, v, lengths, seeds, out, row_max, row_sum, B, T, E, H, tq,
                              scale, drop, stream);
  return io_bf16 ? launch_forward<__nv_bfloat16>(q, k, v, lengths, seeds, out, row_max,
                                                 row_sum, B, T, E, H, tq, scale, drop, bf16,
                                                 stream)
                 : launch_forward<float>(q, k, v, lengths, seeds, out, row_max, row_sum, B,
                                         T, E, H, tq, scale, drop, bf16, stream);
}

// g: (B, T, E) cotangent of out: f32 for the CUDA-core instance, which
// rounds it per head itself; bfloat16 (already rounded, once, by the
// wrapper) for the tensor-core instance. delta: (B, H, T) f32 scratch;
// dq, dk, dv: (B, T, E) outputs in q's element type.
extern "C" int attention_train_backward(const void* q, const void* k, const void* v,
                                        const void* g, const int* lengths,
                                        const int* seeds, const float* row_max,
                                        const float* row_sum, float* delta, void* dq,
                                        void* dk, void* dv, int B, int T, int E, int H,
                                        int tq,
                                        float scale, int use_dropout,
                                        unsigned int threshold, float inv_keep,
                                        int round_bf16, int io_bf16, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Dropout drop{use_dropout != 0, threshold, inv_keep};
  const bool bf16 = round_bf16 != 0;
  if (io_bf16 && bf16)
    return tc::launch_backward(q, k, v, g, lengths, seeds, row_max, row_sum, delta, dq, dk,
                               dv, B, T, E, H, tq, scale, drop, stream);
  const float* gf = static_cast<const float*>(g);
  return io_bf16
             ? launch_backward<__nv_bfloat16>(q, k, v, gf, lengths, seeds, row_max, row_sum,
                                              delta, dq, dk, dv, B, T, E, H, tq, scale,
                                              drop, bf16, stream)
             : launch_backward<float>(q, k, v, gf, lengths, seeds, row_max, row_sum, delta,
                                      dq, dk, dv, B, T, E, H, tq, scale, drop, bf16, stream);
}

// The largest dynamic shared memory of the tensor-core instance's launches
// at head dim D (0 for a head dim it does not take): what the wrapper's
// plan_attention mirrors.
extern "C" long long attention_train_tc_smem_bytes(int D) {
  return (long long)tc::smem_bytes(D);
}
