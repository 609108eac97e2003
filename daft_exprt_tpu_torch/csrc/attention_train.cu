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
// recompute P from q, k and those stats: one per query tile (dq), one per
// key tile (dk and dv, streaming query tiles).
//
// Two instances, chosen by dtype (the wrapper's plan_attention mirrors
// the choice and the shared-memory bytes):
// - bf16 I/O with bf16 rounding, the training path: tensor cores,
//   attention_wgmma.cuh (wgmma and TMA; its header says how). Every
//   product's operands are bf16 values at the points the Pallas kernel
//   rounds them, and every product accumulates in f32, so the tensor cores
//   compute the same products; only the order of the f32 sums changes.
//   The forward also leaves o' = sum_j pd_ij v_j (B, T, E) f32 with the
//   unrounded pd, from which the backward takes delta_i = rnd(g_i) . o'_i
//   without a pass over the keys.
// - f32 I/O, and bf16 I/O with rounding off (the control of the bf16
//   limits): CUDA-core FMAs over f32 tiles (tensor cores cannot give the
//   f32 path its 1e-5 tolerance). G = D / 16 lanes share a row, 128 / G
//   rows per 128-thread block; the dq launch takes delta in a first pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"
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

// libcuda's tensor-map encoder, cuTensorMapEncodeTiled, needs the device's
// context current on the calling thread. A thread on which the runtime has
// made no call yet, such as autograd's worker running a backward, has
// none; cudaSetDevice binds the primary context.
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// The tensor-core instance at the head dim E / H (attention_wgmma.cuh).
int tc_forward(const void* q, const void* k, const void* v, const int* lengths,
               const int* seeds, float* out, float* oprime, float* stats, int B, int T, int E,
               int H, int tq, float scale, Dropout drop, cudaStream_t stream) {
  using wg::bf16;
  const bf16 *qi = static_cast<const bf16*>(q), *ki = static_cast<const bf16*>(k),
             *vi = static_cast<const bf16*>(v);
  float* row_sum = stats + (size_t)B * H * T;
  switch (E / H) {
    case 16:
      return wg::forward<16>(qi, ki, vi, lengths, seeds, out, oprime, stats, row_sum, B, T, E,
                             H, tq, scale, drop, stream);
    case 64:
      return wg::forward<64>(qi, ki, vi, lengths, seeds, out, oprime, stats, row_sum, B, T, E,
                             H, tq, scale, drop, stream);
    case 128:
      return wg::forward<128>(qi, ki, vi, lengths, seeds, out, oprime, stats, row_sum, B, T,
                              E, H, tq, scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int tc_backward(const void* q, const void* k, const void* v, const float* g,
                const int* lengths, const int* seeds, const float* stats, const float* oprime,
                float* terms, void* gr, void* dq, void* dk, void* dv, int B, int T, int E,
                int H, int tq, float scale, Dropout drop, cudaStream_t stream) {
  using wg::bf16;
  const bf16 *qi = static_cast<const bf16*>(q), *ki = static_cast<const bf16*>(k),
             *vi = static_cast<const bf16*>(v);
  bf16 *gi = static_cast<bf16*>(gr), *dqi = static_cast<bf16*>(dq),
       *dki = static_cast<bf16*>(dk), *dvi = static_cast<bf16*>(dv);
  const float* row_sum = stats + (size_t)B * H * T;
  switch (E / H) {
    case 16:
      return wg::backward<16>(qi, ki, vi, g, lengths, seeds, stats, row_sum, oprime, terms, gi,
                              dqi, dki, dvi, B, T, E, H, tq, scale, drop, stream);
    case 64:
      return wg::backward<64>(qi, ki, vi, g, lengths, seeds, stats, row_sum, oprime, terms, gi,
                              dqi, dki, dvi, B, T, E, H, tq, scale, drop, stream);
    case 128:
      return wg::backward<128>(qi, ki, vi, g, lengths, seeds, stats, row_sum, oprime, terms,
                               gi, dqi, dki, dvi, B, T, E, H, tq, scale, drop, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The CUDA-core instance. q, k, v: (B, T, E), float32 or (io_bf16)
// bfloat16 with rounding off (round_bf16 = 0) or float32 with bf16
// rounding; out: (B, T, E) f32; lengths, seeds: (B,) int32; row_max,
// row_sum: (B, H, T) f32 outputs. bf16 I/O with bf16 rounding is the
// tensor-core instance's (attention_train_tc_forward) and is refused here.
// The wrapper checks the shapes, that E / H is 16, 64 or 128 and that tq
// divides T. Returns the first CUDA error.
extern "C" int attention_train_forward(const void* q, const void* k, const void* v,
                                       const int* lengths, const int* seeds, float* out,
                                       float* row_max, float* row_sum, int B, int T,
                                       int E, int H, int tq, float scale, int use_dropout,
                                       unsigned int threshold, float inv_keep,
                                       int round_bf16, int io_bf16, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const Dropout drop{use_dropout != 0, threshold, inv_keep};
  const bool bf16 = round_bf16 != 0;
  if (io_bf16 && bf16) return cudaErrorInvalidValue;
  return io_bf16 ? launch_forward<__nv_bfloat16>(q, k, v, lengths, seeds, out, row_max,
                                                 row_sum, B, T, E, H, tq, scale, drop, bf16,
                                                 stream)
                 : launch_forward<float>(q, k, v, lengths, seeds, out, row_max, row_sum, B,
                                         T, E, H, tq, scale, drop, bf16, stream);
}

// g: (B, T, E) f32 cotangent of out, rounded per head by the kernels;
// delta: (B, H, T) f32 scratch; dq, dk, dv: (B, T, E) outputs in q's
// element type.
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
  if (io_bf16 && bf16) return cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  return io_bf16
             ? launch_backward<__nv_bfloat16>(q, k, v, gf, lengths, seeds, row_max, row_sum,
                                              delta, dq, dk, dv, B, T, E, H, tq, scale,
                                              drop, bf16, stream)
             : launch_backward<float>(q, k, v, gf, lengths, seeds, row_max, row_sum, delta,
                                      dq, dk, dv, B, T, E, H, tq, scale, drop, bf16, stream);
}

// The tensor-core instance (bf16 q/k/v, bf16 rounding). q, k, v: (B, T,
// E) bf16, 16-byte aligned (TMA); out and oprime: (B, T, E) f32 outputs
// (o' = sum_j pd_ij v_j with the unrounded pd, for the backward's delta);
// stats: (2, B, H, T) f32 outputs, row max then row sum. Returns the
// first CUDA error, or -1 if cuTensorMapEncodeTiled refuses a tensor map.
extern "C" int attention_train_tc_forward(const void* q, const void* k, const void* v,
                                          const int* lengths, const int* seeds, float* out,
                                          float* oprime, float* stats, int B, int T, int E,
                                          int H, int tq, float scale, int use_dropout,
                                          unsigned int threshold, float inv_keep,
                                          void* stream_handle) {
  const cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  return tc_forward(q, k, v, lengths, seeds, out, oprime, stats, B, T, E, H, tq, scale,
                    Dropout{use_dropout != 0, threshold, inv_keep},
                    static_cast<cudaStream_t>(stream_handle));
}

// g: (B, T, E) f32 cotangent, rounded to bf16 once here (the Pallas kernel
// rounds it per head: the same values) into gr, (B, T, E) bf16 scratch;
// stats and oprime: the forward's; terms: (B, H, T, 4) f32 scratch; dq,
// dk, dv: (B, T, E) bf16 outputs.
extern "C" int attention_train_tc_backward(const void* q, const void* k, const void* v,
                                           const float* g, const int* lengths,
                                           const int* seeds, const float* stats,
                                           const float* oprime, float* terms, void* gr,
                                           void* dq, void* dk, void* dv, int B, int T, int E,
                                           int H, int tq, float scale, int use_dropout,
                                           unsigned int threshold, float inv_keep,
                                           void* stream_handle) {
  const cudaError_t err = bind_context();
  if (err != cudaSuccess) return err;
  return tc_backward(q, k, v, g, lengths, seeds, stats, oprime, terms, gr, dq, dk, dv, B, T,
                     E, H, tq, scale, Dropout{use_dropout != 0, threshold, inv_keep},
                     static_cast<cudaStream_t>(stream_handle));
}

// The largest dynamic shared memory of the tensor-core instance's launches
// at head dim D (0 for a head dim it does not take): what the wrapper's
// plan_attention mirrors.
extern "C" long long attention_train_tc_smem_bytes(int D) {
  return (long long)wg::smem_bytes(D);
}

// The tensor maps the tensor-core launches have encoded since the library
// loaded (out[0]) and the host nanoseconds spent encoding them (out[1]).
extern "C" void attention_train_tc_map_stats(long long* out) {
  out[0] = wg::maps_encoded;
  out[1] = wg::map_encode_ns;
}
