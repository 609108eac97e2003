// Fused FFT block forward (inference) for Hopper, sm_90a: the CUDA-core
// instance (float32 dots, and bf16 dots where the plan names it; the
// bf16 serving path takes the tensor-core instance, fft_block_tc.cu).
//
// Replaces the Pallas TPU kernel daft_exprt_tpu/ops/fft_block.py:_kernel
// (K1). For each batch row b with valid length len_b it computes
//
//   q,k,v = rnd(rnd(x) @ Wqkv + bqkv)
//   ctx   = rnd(concat_h softmax_{col < len}(q_h k_h^T / sqrt(D)) @ v_h)
//   a     = mask(LN1(ctx @ Wo + bo + x))
//   h     = rnd(relu(conv3(rnd(a), W1) + b1)), zero outside [0, T)
//   out   = mask(FiLM(LN2(conv3(h, W2) + b2 + a)))
//
// where rnd() rounds to bfloat16 when the block runs at bf16 dot precision
// (identity at f32), exactly at the points where the Pallas kernel casts to
// its dot dtype. Products accumulate in f32; LayerNorm and FiLM are f32.
//
// What bounds it on this card: the FLOPs. At the frame-decoder shape
// (B=8, T=512, E=128, C=1024) the block does ~8 GFLOP against ~7.6 MB of
// compulsory traffic, far right of the H100's ~295 FLOP/byte ridge.
// What the design does about it: it keeps the bytes compulsory, so the
// FLOPs are all that is left. The (T, C) conv hidden, the largest
// intermediate, lives only in shared memory: each conv-FF block holds a
// TT-row output tile plus its 2-row halo of hidden rows ((TT+2) x C f32,
// 136 KB at TT=32, C=1024). Attention never writes a T x T tile: each
// query row streams its keys from shared memory twice (row max and
// denominator, then probabilities times values). Rows at or past a
// row's length are skipped wherever their values cannot reach the
// output. The products run on CUDA-core FMAs: tensor cores cannot give
// the float32 path its 2e-4 tolerance. Every kernel is templated on the
// model width E = 128, 256 or 512 (head dims 16, 64, 128).
//
// Four launches on the caller's stream, no allocation:
//   1. qkv_kernel         q/k/v projections            -> qkv  (B, T, 3E)
//   2. attention_kernel   masked softmax attention     -> ctx  (B, T, E)
//   3. outproj_ln_kernel  out projection + x, LN1, mask -> attn (B, T, E)
//   4. conv_ff_kernel     conv-FF, LN2, FiLM, mask      -> out  (B, T, E)
//
// Weight layouts (prepared by the Python wrapper, bf16-rounded there when
// dot precision is bf16): wqkv (E, 3E), wo (E, E), w1 (3, E, C),
// w2 (3, C, E), all "in x out" row-major, float32; biases and LN params
// f32. FiLM rows are read with the caller's batch stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "conv_ff_tile.cuh"

namespace {

constexpr float LN_EPS = 1e-5f;

__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__device__ __forceinline__ int row_length(const int* lengths, int b, int T) {
  const int n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : n);
}

// ---------------------------------------------------------------------
// 1. qkv = rnd(rnd(x) @ wqkv + bqkv). Grid (ceil(T/64), 3E/64, B),
//    256 threads, 64x64 output tile, 4x4 outputs per thread.
// ---------------------------------------------------------------------
constexpr int P_TM = 64, P_TN = 64, P_TK = 32;

template <int E>
__global__ void __launch_bounds__(256)
qkv_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
           const float* __restrict__ w, const float* __restrict__ bias,
           float* __restrict__ qkv, int T, bool bf16) {
  constexpr int N = 3 * E;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * P_TM;
  const int n0 = blockIdx.y * P_TN;
  // q, k and v rows at or past the length are never read downstream.
  if (t0 >= row_length(lengths, b, T)) return;

  __shared__ float As[P_TK][P_TM + 1];  // x tile, transposed: As[k][m]
  __shared__ float Bs[P_TK][P_TN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xb = x + (size_t)b * T * E;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < E; k0 += P_TK) {
    for (int i = tid; i < P_TM * P_TK; i += 256) {
      const int m = i / P_TK, k = i % P_TK;
      const int t = t0 + m;
      As[k][m] = t < T ? rnd(xb[(size_t)t * E + k0 + k], bf16) : 0.f;
    }
    for (int i = tid; i < P_TK * P_TN; i += 256) {
      const int k = i / P_TN, n = i % P_TN;
      Bs[k][n] = w[(size_t)(k0 + k) * N + n0 + n];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < P_TK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
    float* dst = qkv + ((size_t)b * T + t) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      dst[n] = rnd(acc[i][j] + bias[n], bf16);
    }
  }
}

// ---------------------------------------------------------------------
// 2. Masked softmax attention, one head per block. G = D/16 lanes share a
//    query row, each owning 16 of its D dims; QT = 128/G query rows per
//    128-thread block. Keys stream through shared memory in KT-row
//    tiles, only up to the row's length (masked keys get exactly zero
//    probability in the reference, whose max is over valid keys); KT = 32
//    key rows at D = 128 keeps the two tiles within 48 KB of static
//    shared memory.
//    Pass 1: running max m and denominator l. Pass 2: p = exp(s - m) /
//    max(l, 1e-30), rounded, accumulated against v.
// ---------------------------------------------------------------------
template <int G, int E>
__global__ void __launch_bounds__(128)
attention_kernel(const float* __restrict__ qkv,
                 const int* __restrict__ lengths, float* __restrict__ ctx,
                 int T, float scale, bool bf16) {
  constexpr int D = 16 * G;
  constexpr int QT = 128 / G;
  constexpr int KT = G == 8 ? 32 : 64;
  constexpr int N = 3 * E;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int len = row_length(lengths, b, T);
  // Query rows at or past the length are zeroed after LN1 and never read.
  if (q0 >= len) return;

  __shared__ __align__(16) float Ks[KT][D];
  __shared__ __align__(16) float Vs[KT][D];
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row = q0 + tid / G;
  const float* base = qkv + (size_t)b * T * N;

  float q[16];
  if (row < T) {
    const float4* src =
        reinterpret_cast<const float4*>(base + (size_t)row * N + h * D + g * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = src[i];
      q[4 * i] = v.x; q[4 * i + 1] = v.y; q[4 * i + 2] = v.z; q[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = 0.f;
  }

  auto logit = [&](int j) {
    const float4* kr = reinterpret_cast<const float4*>(&Ks[j][g * 16]);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 kv = kr[i];
      s = fmaf(q[4 * i], kv.x, s);
      s = fmaf(q[4 * i + 1], kv.y, s);
      s = fmaf(q[4 * i + 2], kv.z, s);
      s = fmaf(q[4 * i + 3], kv.w, s);
    }
#pragma unroll
    for (int o = 1; o < G; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s * scale;
  };

  auto load_tile = [&](float (*dst)[D], int k0, int nk, int col0) {
    constexpr int V4 = D / 4;
    for (int i = tid; i < nk * V4; i += 128) {
      const int j = i / V4, c = i % V4;
      reinterpret_cast<float4*>(dst[j])[c] = reinterpret_cast<const float4*>(
          base + (size_t)(k0 + j) * N + col0 + h * D)[c];
    }
  };

  float m = -FLT_MAX, l = 0.f;
  for (int k0 = 0; k0 < len; k0 += KT) {
    const int nk = min(KT, len - k0);
    __syncthreads();
    load_tile(Ks, k0, nk, E);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float s = logit(j);
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
  for (int k0 = 0; k0 < len; k0 += KT) {
    const int nk = min(KT, len - k0);
    __syncthreads();
    load_tile(Ks, k0, nk, E);
    load_tile(Vs, k0, nk, 2 * E);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      const float p = rnd(expf(logit(j) - m) / denom, bf16);
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
    float4* dst =
        reinterpret_cast<float4*>(ctx + ((size_t)b * T + row) * E + h * D + g * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = make_float4(rnd(acc[4 * i], bf16), rnd(acc[4 * i + 1], bf16),
                           rnd(acc[4 * i + 2], bf16), rnd(acc[4 * i + 3], bf16));
  }
}

// ---------------------------------------------------------------------
// 3. attn = mask(LN1(ctx @ wo + bo + x)). Grid (ceil(T/32), B), 256
//    threads: tile row r = tid/8, columns c8 + 8j (j < E/8); the wo slice
//    of KC = 4096 / E rows takes 16 KB at every width. Writes every row
//    < T (zeros at or past the length), so launch 4 can read halos.
// ---------------------------------------------------------------------
template <int E>
__global__ void __launch_bounds__(256)
outproj_ln_kernel(const float* __restrict__ ctx, const float* __restrict__ x,
                  const int* __restrict__ lengths, const float* __restrict__ wo,
                  const float* __restrict__ bo, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, float* __restrict__ attn,
                  int T) {
  constexpr int RT = 32, KC = 4096 / E, NJ = E / 8;
  const int b = blockIdx.y, t0 = blockIdx.x * RT;
  const int len = row_length(lengths, b, T);
  const int tid = threadIdx.x, r = tid / 8, c8 = tid % 8;
  const int t = t0 + r;
  float* dst = attn + ((size_t)b * T + t) * E;
  if (t0 >= len) {
    if (t < T)
      for (int j = 0; j < NJ; ++j) dst[c8 + 8 * j] = 0.f;
    return;
  }

  __shared__ float Cs[RT][KC + 1];
  __shared__ __align__(16) float Ws[KC][E];
  float v[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) v[j] = 0.f;

  for (int k0 = 0; k0 < E; k0 += KC) {
    for (int i = tid; i < RT * KC; i += 256) {
      const int rr = i / KC, k = i % KC;
      const int tt = t0 + rr;
      // ctx rows at or past the length may be unwritten: never read them.
      Cs[rr][k] = tt < len ? ctx[((size_t)b * T + tt) * E + k0 + k] : 0.f;
    }
    for (int i = tid; i < KC * E / 4; i += 256) {
      const int k = i / (E / 4), c = i % (E / 4);
      reinterpret_cast<float4*>(Ws[k])[c] =
          reinterpret_cast<const float4*>(wo + (size_t)(k0 + k) * E)[c];
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float a = Cs[r][k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = fmaf(a, Ws[k][c8 + 8 * j], v[j]);
    }
    __syncthreads();
  }

  const bool valid = t < len;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int n = c8 + 8 * j;
    v[j] = valid ? v[j] + bo[n] + x[((size_t)b * T + t) * E + n] : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float mean = sum / E;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) sq += (v[j] - mean) * (v[j] - mean);
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
  const float inv = 1.f / sqrtf(sq / E + LN_EPS);
  if (t < T) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = c8 + 8 * j;
      dst[n] = valid ? (v[j] - mean) * inv * ln_s[n] + ln_b[n] : 0.f;
    }
  }
}

// ---------------------------------------------------------------------
// 4. Conv feed-forward over a TT-row output tile, 256 threads, built from
//    the tile stages of conv_ff_tile.cuh (shared with the training
//    conv-FF). Shared memory: ext (TT+4) x E = rnd(attn) rows lo-2 ..
//    lo+TT+1, hid (TT+2) x C = hidden rows lo-1 .. lo+TT, and the W2 slice.
// ---------------------------------------------------------------------
using conv_ff::TT;
using conv_ff::RW;
using conv_ff::warp_sum;

template <int E>
constexpr size_t conv_ff_smem_bytes(int C) {
  return sizeof(float) * conv_ff::smem_floats<E>(C);
}

template <int E>
__global__ void __launch_bounds__(256)
conv_ff_kernel(const float* __restrict__ attn, const int* __restrict__ lengths,
               const float* __restrict__ w1, const float* __restrict__ b1,
               const float* __restrict__ w2, const float* __restrict__ b2,
               const float* __restrict__ ln_s, const float* __restrict__ ln_b,
               const float* __restrict__ film, int film_stride,
               float* __restrict__ out, int T, int C, bool bf16) {
  constexpr int EV = E / 128;
  const int b = blockIdx.y, lo = blockIdx.x * TT;
  const int len = row_length(lengths, b, T);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ob = out + (size_t)b * T * E;
  if (lo >= len) {  // the whole tile is padding: zeros
    for (int i = tid; i < TT * E; i += 256) {
      const int t = lo + i / E;
      if (t < T) ob[(size_t)t * E + i % E] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* ext = smem;
  float* hid = ext + (TT + 4) * E;
  float* w2s = hid + (TT + 2) * C;
  const float* ab = attn + (size_t)b * T * E;

  // Conv input: rows outside [0, T) are SAME zero padding; rows in
  // [len, T) were zeroed by launch 3.
  for (int i = tid; i < (TT + 4) * E; i += 256) {
    const int t = lo - 2 + i / E;
    ext[i] = (t >= 0 && t < T) ? rnd(ab[(size_t)t * E + i % E], bf16) : 0.f;
  }
  __syncthreads();

  // conv1 + b1 -> relu -> rnd. Hidden rows in [len, T) stay relu(b1 + ...)
  // as in the reference; only rows outside [0, T) are zero.
  conv_ff::conv_e_to_c<E>(ext, w1, hid, C, [&](int r, int c0, const float* a) {
    const int t = lo - 1 + r;
    const bool inside = t >= 0 && t < T;
    const float4 bias = *reinterpret_cast<const float4*>(b1 + c0);
    float4 hv;
    hv.x = inside ? rnd(fmaxf(a[0] + bias.x, 0.f), bf16) : 0.f;
    hv.y = inside ? rnd(fmaxf(a[1] + bias.y, 0.f), bf16) : 0.f;
    hv.z = inside ? rnd(fmaxf(a[2] + bias.z, 0.f), bf16) : 0.f;
    hv.w = inside ? rnd(fmaxf(a[3] + bias.w, 0.f), bf16) : 0.f;
    return hv;
  });
  __syncthreads();

  // conv2: output tile row o reads hidden rows o, o+1, o+2 (taps d=0..2).
  float acc2[RW][4 * EV];
  conv_ff::conv_c_to_e<E>(hid, w2, w2s, C, acc2);

  // + b2 + residual -> LN2 -> FiLM -> mask; lane l owns columns
  // 128 j + 4 l .. + 3.
  const float* fb = film == nullptr ? nullptr : film + (size_t)b * film_stride;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int t = lo + warp * RW + r;
    float v[4 * EV], sum = 0.f;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      const float4 bias2 = *reinterpret_cast<const float4*>(b2 + n);
      float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) res = *reinterpret_cast<const float4*>(ab + (size_t)t * E + n);
      v[4 * j] = acc2[r][4 * j] + bias2.x + res.x;
      v[4 * j + 1] = acc2[r][4 * j + 1] + bias2.y + res.y;
      v[4 * j + 2] = acc2[r][4 * j + 2] + bias2.z + res.z;
      v[4 * j + 3] = acc2[r][4 * j + 3] + bias2.w + res.w;
      sum += v[4 * j] + v[4 * j + 1] + v[4 * j + 2] + v[4 * j + 3];
    }
    const float mean = warp_sum(sum) / E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
    if (t >= T) continue;  // the same for the whole warp
    const bool valid = t < len;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      const float4 s4 = *reinterpret_cast<const float4*>(ln_s + n);
      const float4 o4 = *reinterpret_cast<const float4*>(ln_b + n);
      float4 gam = make_float4(1.f, 1.f, 1.f, 1.f), bet = make_float4(0.f, 0.f, 0.f, 0.f);
      if (fb != nullptr) {
        gam = *reinterpret_cast<const float4*>(fb + n);
        bet = *reinterpret_cast<const float4*>(fb + E + n);
      }
      float4 y;
      y.x = valid ? gam.x * ((v[4 * j] - mean) * inv * s4.x + o4.x) + bet.x : 0.f;
      y.y = valid ? gam.y * ((v[4 * j + 1] - mean) * inv * s4.y + o4.y) + bet.y : 0.f;
      y.z = valid ? gam.z * ((v[4 * j + 2] - mean) * inv * s4.z + o4.z) + bet.z : 0.f;
      y.w = valid ? gam.w * ((v[4 * j + 3] - mean) * inv * s4.w + o4.w) + bet.w : 0.f;
      *reinterpret_cast<float4*>(ob + (size_t)t * E + n) = y;
    }
  }
}

// The kernel's dynamic shared memory limit, raised once per instance to
// the most any call so far needed (not at every call: the serving path's
// pace is set by the host).
template <int E>
cudaError_t allow_conv_ff_smem(size_t bytes) {
  static size_t allowed = 0;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      conv_ff_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

struct Args {
  const float *x;
  const int* lengths;
  const float *wqkv, *bqkv, *wo, *bo, *ln1_s, *ln1_b, *w1, *b1, *w2, *b2, *ln2_s, *ln2_b,
      *film;
  int film_stride;
  float *qkv, *ctx, *attn, *out;
  int B, T, C, H;
  bool bf16;
};

template <int E>
cudaError_t forward(const Args& a, cudaStream_t stream) {
  const int B = a.B, T = a.T, C = a.C, D = E / a.H;
  cudaError_t err;
  qkv_kernel<E><<<dim3((T + P_TM - 1) / P_TM, 3 * E / P_TN, B), 256, 0, stream>>>(
      a.x, a.lengths, a.wqkv, a.bqkv, a.qkv, T, a.bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  switch (D) {
    case 16:
      attention_kernel<1, E><<<dim3((T + 127) / 128, a.H, B), 128, 0, stream>>>(
          a.qkv, a.lengths, a.ctx, T, scale, a.bf16);
      break;
    case 64:
      attention_kernel<4, E><<<dim3((T + 31) / 32, a.H, B), 128, 0, stream>>>(
          a.qkv, a.lengths, a.ctx, T, scale, a.bf16);
      break;
    case 128:
      attention_kernel<8, E><<<dim3((T + 15) / 16, a.H, B), 128, 0, stream>>>(
          a.qkv, a.lengths, a.ctx, T, scale, a.bf16);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  outproj_ln_kernel<E><<<dim3((T + 31) / 32, B), 256, 0, stream>>>(
      a.ctx, a.x, a.lengths, a.wo, a.bo, a.ln1_s, a.ln1_b, a.attn, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem = conv_ff_smem_bytes<E>(C);
  if ((err = allow_conv_ff_smem<E>(smem)) != cudaSuccess) return err;
  conv_ff_kernel<E><<<dim3((T + TT - 1) / TT, B), 256, smem, stream>>>(
      a.attn, a.lengths, a.w1, a.b1, a.w2, a.b2, a.ln2_s, a.ln2_b, a.film, a.film_stride,
      a.out, T, C, a.bf16);
  return cudaGetLastError();
}

size_t smem_bytes(int E, int C) {
  switch (E) {
    case 128: return conv_ff_smem_bytes<128>(C);
    case 256: return conv_ff_smem_bytes<256>(C);
    case 512: return conv_ff_smem_bytes<512>(C);
    default: return 0;
  }
}

// One block's shared memory must hold the TT=32 conv tile.
bool takes(int B, int T, int E, int C, int H) {
  const int D = H > 0 && E % H == 0 ? E / H : 0;
  return B > 0 && T > 0 && smem_bytes(E, C) > 0 && (D == 16 || D == 64 || D == 128) &&
         C > 0 && C % 16 == 0 && smem_bytes(E, C) <= 227 * 1024;
}

}  // namespace

// The conv-FF launch's dynamic shared memory at width E and C channels:
// the instance's largest, what the wrapper's plan mirrors (0 outside the
// widths it takes).
extern "C" long long fft_block_smem_bytes(int E, int C) { return (long long)smem_bytes(E, C); }

// Runs one FFT block. All pointers are device pointers; film may be null
// (identity FiLM), its rows film_stride floats apart. qkv (B*T*3E), ctx
// (B*T*E) and attn (B*T*E) are scratch. Returns the first CUDA error (0
// on success); cudaErrorInvalidValue outside E in {128, 256, 512}, D =
// E / H in {16, 64, 128}, C % 16 == 0 within one block's shared memory.
extern "C" int fft_block_forward(
    const float* x, const int* lengths, const float* wqkv, const float* bqkv,
    const float* wo, const float* bo, const float* ln1_s, const float* ln1_b,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const float* ln2_s, const float* ln2_b, const float* film, int film_stride, float* qkv,
    float* ctx, float* attn, float* out, int B, int T, int E, int C, int H,
    int round_bf16, void* stream_handle) {
  if (!takes(B, T, E, C, H)) return cudaErrorInvalidValue;
  const Args a{x,  lengths, wqkv,  bqkv, wo,   bo,   ln1_s, ln1_b, w1,  b1, w2, b2,
               ln2_s, ln2_b, film, film_stride, qkv, ctx, attn, out, B, T, C, H,
               round_bf16 != 0};
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (E) {
    case 128: return forward<128>(a, stream);
    case 256: return forward<256>(a, stream);
    default: return forward<512>(a, stream);
  }
}
