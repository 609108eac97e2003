// C-blocked training conv feed-forward (K4), forward and backward, for
// Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels daft_exprt_tpu/ops/conv_ff_train.py
// _fwd_kernel_blocked, _bwd_rowlocal_kernel, _bwd_blockgrads_kernel and
// _bwd_dx_kernel (K4). The function is K3's (conv_ff_train.cu), at model
// widths E = 128, 256, 384 or 512, with the C hidden channels taken in
// blocks of cb:
//
//   a1 = conv1(rnd(x)) + b1;   h = rnd(relu(a1))
//   a2 = conv2(h) + b2;        r = drop(a2) + x,  drop(a) = keep ? a / (1 - rate) : 0
//   y  = LN(r) * s + b;        out = gamma * y + beta   (film = [gamma | beta])
//
// and its backward (dy_ln = g * gamma; LN backward per row):
//
//   dfilm = (sum_t g * y, sum_t g);  ds, db = sum dy_ln * n, sum dy_ln
//   dr  = LN_bwd(dy_ln);  da2 = drop(dr);  db2 = sum da2
//   per block: dW2 = sum shift(h)^T rnd(da2);  da1 = a1 > 0 ? conv2^T(rnd(da2)) : 0
//              db1 = sum da1;  dW1 = sum shift(rnd(x))^T rnd(da1)
//   dx  = dr + sum over blocks of conv1^T(rnd(da1))
//
// rnd() rounds to bfloat16 at bf16 dot precision (identity at f32), where
// the Pallas kernels cast; weights arrive rounded from the wrapper. Rows
// outside [0, T) are zero; there is no length mask (the block masks rows
// afterwards). Dropout bits are those of K2/K3 (salt 0, row t, col e).
//
// What bounds it on this card: operations. At the wide ablation's shape
// (B=16, T=768, E=512, C=512) the forward does 38.7 GFLOP against ~55 MB
// of compulsory traffic, the backward three times the FLOPs.
//
// Design. The TPU grid (B, C blocks) carries the a2 sum in a VMEM scratch
// from one sequential grid step to the next, and its backward is three
// calls only because Pallas revisits an output block on consecutive steps
// alone. Here a 256-thread block owns a TT=32-row tile of one batch row
// and loops over the C blocks itself, so nothing carries between blocks:
// the x halo (TT+6 rows x E, f32) stays in shared memory, each C block's
// hidden (TT+2 rows x cb) is made in shared memory and consumed at once,
// and the a2 (or dx) sum of the tile stays in registers (warp w owns rows
// 4w..4w+3, lane l the columns 128j + 4l .. 128j + 4l + 3), so a row's
// LayerNorm reductions stay within one warp. At E=512, cb=128 that is
// 95,232 bytes of dynamic shared memory. Weights stream from L2 through the
// read-only path (every warp of a block reads the same rows). The
// backward is K3's sequence with the same fixed-order reductions, no
// float atomics, so two runs give bit-identical gradients:
//   1. rows kernel: recompute a2 over the C blocks, writing the tile's
//      rows of h (B, T, C) to device memory; the LN backward gives dr and
//      rnd(da2) (B, T, E) and per-tile partial sums of dfilm, dLN and db2;
//   2. hidden kernel: per C block, dh from rnd(da2) rows lo-2 .. lo+TT+1,
//      the ReLU mask from h, per-tile db1 partials, rnd(da1) (B, T, C) to
//      device memory, and the block's term of dx, summed in registers;
//   3. the weight-gradient products and the reductions of the partials
//      (conv_ff_wgrad.cuh, shared with K3).
// The products run on CUDA-core FMAs. This is K4's float32 instance (and
// chip_smoke's bf16 control with the rounding off); bf16 dots, the
// training path, take the tensor-core instance, conv_ff_blocked_tc.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_ff_tile.cuh"
#include "conv_ff_wgrad.cuh"
#include "dropout_hash.cuh"

namespace {

using conv_ff::RW;
using conv_ff::THREADS;
using conv_ff::TT;
using conv_ff::rnd;
using conv_ff::warp_sum;

constexpr float LN_EPS = 1e-5f;
constexpr int HALO = TT + 6;  // input rows in shared memory: lo-2 .. lo+TT+3
constexpr int HID = TT + 2;   // hidden rows: lo-1 .. lo+TT
constexpr int RG = 6;         // hidden rows per thread in the E -> C stage
constexpr int NRG = (HID + RG - 1) / RG;
static_assert(NRG * RG + 2 <= HALO, "the last row group reads inside the halo");
static_assert(TT == 8 * RW, "8 warps split the tile rows");

int n_tiles(int T) { return (T + TT - 1) / TT; }

// Shared memory of one tile: the halo and one C block's hidden; the
// backward's rows kernel reuses it for 8 warps x 5 partial sums of E.
size_t smem_floats(int E, int cb) {
  const size_t tile = (size_t)HALO * E + (size_t)HID * cb, red = (size_t)8 * 5 * E;
  return tile > red ? tile : red;
}

size_t smem_bytes(int E, int cb) { return sizeof(float) * smem_floats(E, cb); }

// Rows lo-2 .. lo+TT+3 of a (T, E) matrix into in[HALO x E], rounded; rows
// outside [0, T) are zero.
template <int E>
__device__ __forceinline__ void load_halo(float* in, const float* src, int lo, int T,
                                          bool bf16) {
  for (int i = threadIdx.x; i < HALO * E / 4; i += THREADS) {
    const int t = lo - 2 + i / (E / 4), c = 4 * (i % (E / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      v = *reinterpret_cast<const float4*>(src + (size_t)t * E + c);
      v.x = rnd(v.x, bf16); v.y = rnd(v.y, bf16);
      v.z = rnd(v.z, bf16); v.w = rnd(v.w, bf16);
    }
    reinterpret_cast<float4*>(in)[i] = v;
  }
}

// out[r][c0..c0+3] = epi(r, c0, acc) for hidden rows r < HID and the
// block's cb channels, acc[i] = sum_d sum_e in[r + d][e] * w[d][e][c0 + i];
// w points at the block's first channel inside a (3, E, C) tensor. A
// thread owns 4 channels and RG rows; cb / 4 is a multiple of 32, so the
// lanes of a warp share their rows (broadcast reads of the halo) and read
// one coalesced weight row.
template <int E, class Epi>
__device__ __forceinline__ void conv_e_to_c_block(const float* in, const float* __restrict__ w,
                                                  float* out, int C, int cb, Epi epi) {
  const int groups = cb / 4;
  for (int item = threadIdx.x; item < groups * NRG; item += THREADS) {
    const int c0 = 4 * (item % groups), r0 = RG * (item / groups);
    float acc[RG][4];
#pragma unroll
    for (int r = 0; r < RG; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int d = 0; d < 3; ++d) {
      const float* wd = w + (size_t)d * E * C + c0;
      const float* xd = in + (size_t)(r0 + d) * E;
#pragma unroll 4
      for (int e = 0; e < E; ++e) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wd + (size_t)e * C));
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float a = xd[r * E + e];
          acc[r][0] = fmaf(a, wv.x, acc[r][0]);
          acc[r][1] = fmaf(a, wv.y, acc[r][1]);
          acc[r][2] = fmaf(a, wv.z, acc[r][2]);
          acc[r][3] = fmaf(a, wv.w, acc[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RG; ++r)
      if (r0 + r < HID)
        *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * cb + c0) = epi(r0 + r, c0, acc[r]);
  }
}

// acc[r][4j + i] += sum_d sum_c in[warp*RW + r + d][c] * w[d][c][128j + 4 lane + i]
// over the block's cb channels; in is HID x cb, w points at the block's
// first row inside a (3, C, E) tensor.
template <int EV>
__device__ __forceinline__ void conv_c_to_e_block(const float* in, const float* __restrict__ w,
                                                  int C, int cb, float (&acc)[RW][4 * EV]) {
  constexpr int E = 128 * EV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int d = 0; d < 3; ++d) {
    const float* wd = w + (size_t)d * C * E + 4 * lane;
    const float* hd = in + (size_t)(warp * RW + d) * cb;
#pragma unroll 2
    for (int c = 0; c < cb; ++c) {
      float4 wv[EV];
#pragma unroll
      for (int j = 0; j < EV; ++j)
        wv[j] = __ldg(reinterpret_cast<const float4*>(wd + (size_t)c * E + 128 * j));
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float a = hd[r * cb + c];
#pragma unroll
        for (int j = 0; j < EV; ++j) {
          acc[r][4 * j] = fmaf(a, wv[j].x, acc[r][4 * j]);
          acc[r][4 * j + 1] = fmaf(a, wv[j].y, acc[r][4 * j + 1]);
          acc[r][4 * j + 2] = fmaf(a, wv[j].z, acc[r][4 * j + 2]);
          acc[r][4 * j + 3] = fmaf(a, wv[j].w, acc[r][4 * j + 3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// -------------------------------------------------------------------
// Forward (BWD = false) and backward launch 1 (BWD = true).
// Grid (ceil(T/TT), B), 256 threads, smem_bytes(E, cb) dynamic shared
// memory.
// -------------------------------------------------------------------
template <int EV, bool BWD>
__global__ void __launch_bounds__(256)
cffb_rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const float* __restrict__ film,
                 const int* __restrict__ seeds, const float* __restrict__ g,
                 float* __restrict__ out, float* __restrict__ h_out,
                 float* __restrict__ da2c, float* __restrict__ pfilm,
                 float* __restrict__ pvec, int T, int C, int cb, Dropout drop, bool bf16) {
  constexpr int E = 128 * EV;
  const int b = blockIdx.y, tile = blockIdx.x, lo = tile * TT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  float* ext = smem;
  float* hid = ext + HALO * E;
  const float* xb = x + (size_t)b * T * E;

  load_halo<E>(ext, xb, lo, T, bf16);
  float acc[RW][4 * EV];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) acc[r][i] = 0.f;
  for (int cb0 = 0; cb0 < C; cb0 += cb) {
    __syncthreads();  // the halo is in; the last block's hidden is consumed
    conv_e_to_c_block<E>(ext, w1 + cb0, hid, C, cb, [&](int r, int c0, const float* a) {
      const int t = lo - 1 + r;
      const bool inside = t >= 0 && t < T;
      const float4 bias = *reinterpret_cast<const float4*>(b1 + cb0 + c0);
      float4 hv;
      hv.x = inside ? rnd(fmaxf(a[0] + bias.x, 0.f), bf16) : 0.f;
      hv.y = inside ? rnd(fmaxf(a[1] + bias.y, 0.f), bf16) : 0.f;
      hv.z = inside ? rnd(fmaxf(a[2] + bias.z, 0.f), bf16) : 0.f;
      hv.w = inside ? rnd(fmaxf(a[3] + bias.w, 0.f), bf16) : 0.f;
      if (BWD && r >= 1 && r <= TT && t < T)  // the tile's own rows
        *reinterpret_cast<float4*>(h_out + ((size_t)b * T + t) * C + cb0 + c0) = hv;
      return hv;
    });
    __syncthreads();
    conv_c_to_e_block<EV>(hid, w2 + (size_t)cb0 * E, C, cb, acc);
  }

  // Backward: 8 warps x 5 partial sums (g*y, g, dy*n, dy, da2) of E each,
  // in the shared memory the tile no longer reads; each (warp, column) is
  // one thread's, added in row order.
  float* red = smem;
  if (BWD) {
    __syncthreads();
    for (int i = tid; i < 8 * 5 * E; i += THREADS) red[i] = 0.f;
    __syncthreads();
  }
  const uint32_t seed = (uint32_t)seeds[b];
  const float* fb = film + (size_t)b * 2 * E;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int t = lo + warp * RW + rr;
    const bool inside = t < T;
    float v[4 * EV];
    bool keep[4 * EV];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float xr[4] = {0.f, 0.f, 0.f, 0.f}, bias[4];
      if (inside) load4(xr, xb + (size_t)t * E + n);
      load4(bias, b2 + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a2 = acc[rr][4 * j + i] + bias[i];
        keep[4 * j + i] = true;
        if (drop.on) {
          keep[4 * j + i] =
              dropout_bits(seed, 0u, (uint32_t)t, (uint32_t)(n + i)) >= drop.threshold;
          a2 = keep[4 * j + i] ? a2 / drop.keep : 0.f;
        }
        v[4 * j + i] = a2 + xr[i];
        s += v[4 * j + i];
      }
    }
    const float mean = warp_sum(s) / E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
    float nrm[4 * EV], y[4 * EV], gam[4 * EV];
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float sv[4], ov[4], bet[4];
      load4(sv, ln_s + n);
      load4(ov, ln_b + n);
      load4(gam + 4 * j, fb + n);
      load4(bet, fb + E + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        nrm[4 * j + i] = (v[4 * j + i] - mean) * inv;
        y[4 * j + i] = nrm[4 * j + i] * sv[i] + ov[i];
        // forward: v becomes the output row; backward: dn = dy * s
        v[4 * j + i] = gam[4 * j + i] * y[4 * j + i] + bet[i];
      }
    }
    if (!BWD) {
      if (inside)
#pragma unroll
        for (int j = 0; j < EV; ++j)
          store4(out + ((size_t)b * T + t) * E + 128 * j + 4 * lane, v + 4 * j);
      continue;
    }
    float gr[4 * EV], dn[4 * EV];
    float s_dn = 0.f, s_dnn = 0.f;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float sv[4];
      load4(sv, ln_s + n);
      gr[4 * j] = gr[4 * j + 1] = gr[4 * j + 2] = gr[4 * j + 3] = 0.f;
      if (inside) load4(gr + 4 * j, g + ((size_t)b * T + t) * E + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dn[4 * j + i] = gr[4 * j + i] * gam[4 * j + i] * sv[i];
        s_dn += dn[4 * j + i];
        s_dnn += dn[4 * j + i] * nrm[4 * j + i];
      }
    }
    const float m_dn = warp_sum(s_dn) / E, m_dnn = warp_sum(s_dnn) / E;
    if (!inside) continue;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const int n = 128 * j + 4 * lane;
      float dr[4], da2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * j + i;
        const float dy = gr[k] * gam[k];
        dr[i] = (dn[k] - m_dn - nrm[k] * m_dnn) * inv;
        da2[i] = drop.on ? (keep[k] ? dr[i] / drop.keep : 0.f) : dr[i];
        float* rw = red + (size_t)warp * 5 * E + n + i;
        rw[0] += gr[k] * y[k];
        rw[E] += gr[k];
        rw[2 * E] += dy * nrm[k];
        rw[3 * E] += dy;
        rw[4 * E] += da2[i];
        da2[i] = rnd(da2[i], bf16);
      }
      const size_t o = ((size_t)b * T + t) * E + n;
      store4(out + o, dr);
      store4(da2c + o, da2);
    }
  }
  if (!BWD) return;

  // Per-tile partials: the 8 warps' sums, added in warp order.
  __syncthreads();
  const int tiles = gridDim.x;
  for (int i = tid; i < 5 * E; i += THREADS) {
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
// Backward launch 2: per C block, dh, da1, the db1 partials and rnd(da1);
// dx = dr + the blocks' conv1^T(rnd(da1)) terms, summed in registers.
// w2r (3, E, C): w2r[d] = W2[2 - d]^T; w1r (3, C, E): w1r[d] = W1[2 - d]^T.
// -------------------------------------------------------------------
template <int EV>
__global__ void __launch_bounds__(256)
cffb_hidden_kernel(const float* __restrict__ da2c, const float* __restrict__ h,
                   const float* __restrict__ dr, const float* __restrict__ w2r,
                   const float* __restrict__ w1r, float* __restrict__ da1c,
                   float* __restrict__ pdb1, float* __restrict__ dx, int T, int C, int cb,
                   bool bf16) {
  constexpr int E = 128 * EV;
  const int b = blockIdx.y, tile = blockIdx.x, lo = tile * TT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  float* ext = smem;
  float* hid = ext + HALO * E;
  const int rows = min(TT, T - lo);

  load_halo<E>(ext, da2c + (size_t)b * T * E, lo, T, false);  // already rounded
  float acc[RW][4 * EV];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) acc[r][i] = 0.f;
  for (int cb0 = 0; cb0 < C; cb0 += cb) {
    __syncthreads();
    // dh rows lo-1 .. lo+TT; da1 = dh where the hidden was positive
    // (h = rnd(relu(a1)) > 0 iff a1 > 0), zero outside [0, T).
    conv_e_to_c_block<E>(ext, w2r + cb0, hid, C, cb, [&](int r, int c0, const float* a) {
      const int t = lo - 1 + r;
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t >= 0 && t < T) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h + ((size_t)b * T + t) * C + cb0 + c0);
        d.x = hv.x > 0.f ? a[0] : 0.f;
        d.y = hv.y > 0.f ? a[1] : 0.f;
        d.z = hv.z > 0.f ? a[2] : 0.f;
        d.w = hv.w > 0.f ? a[3] : 0.f;
      }
      return d;
    });
    __syncthreads();
    // db1 partial over the tile's own rows (unrounded da1), then round the
    // hidden in place and write the tile's rows of rnd(da1).
    for (int c = tid; c < cb; c += THREADS) {
      float s = 0.f;
      for (int r = 1; r <= rows; ++r) s += hid[(size_t)r * cb + c];
      pdb1[((size_t)b * gridDim.x + tile) * C + cb0 + c] = s;
    }
    __syncthreads();
    for (int i = tid; i < HID * cb; i += THREADS) {
      const float v = rnd(hid[i], bf16);
      hid[i] = v;
      const int r = i / cb;
      if (r >= 1 && r <= rows) da1c[((size_t)b * T + lo - 1 + r) * C + cb0 + i % cb] = v;
    }
    __syncthreads();
    conv_c_to_e_block<EV>(hid, w1r + (size_t)cb0 * E, C, cb, acc);
  }
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int t = lo + warp * RW + rr;
    if (t >= T) continue;
#pragma unroll
    for (int j = 0; j < EV; ++j) {
      const size_t o = ((size_t)b * T + t) * E + 128 * j + 4 * lane;
      float d[4];
      load4(d, dr + o);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] += acc[rr][4 * j + i];
      store4(dx + o, d);
    }
  }
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const float *x, *w1, *b1, *w2, *b2, *ln_s, *ln_b, *film;
  const int* seeds;
  int B, T, C, cb;
  Dropout drop;
  bool bf16;
};

template <int EV>
cudaError_t forward(const Args& a, float* out, cudaStream_t stream) {
  const size_t bytes = smem_bytes(128 * EV, a.cb);
  cudaError_t err = allow_smem(cffb_rows_kernel<EV, false>, bytes);
  if (err != cudaSuccess) return err;
  cffb_rows_kernel<EV, false><<<dim3(n_tiles(a.T), a.B), THREADS, bytes, stream>>>(
      a.x, a.w1, a.b1, a.w2, a.b2, a.ln_s, a.ln_b, a.film, a.seeds, nullptr, out, nullptr,
      nullptr, nullptr, nullptr, a.T, a.C, a.cb, a.drop, a.bf16);
  return cudaGetLastError();
}

template <int EV>
cudaError_t backward(const Args& a, const float* g, const float* w1r, const float* w2r,
                     float* ws, float* dx, float* dw1, float* db1, float* dw2, float* dvec,
                     float* dfilm, cudaStream_t stream) {
  constexpr int E = 128 * EV;
  const int B = a.B, T = a.T, C = a.C, tiles = n_tiles(T);
  const size_t bt = (size_t)B * T, bytes = smem_bytes(E, a.cb);
  float* h = ws;
  float* da1c = h + bt * C;
  float* dr = da1c + bt * C;
  float* da2c = dr + bt * E;
  float* pfilm = da2c + bt * E;
  float* pvec = pfilm + (size_t)B * tiles * 2 * E;
  float* pdb1 = pvec + (size_t)B * tiles * 3 * E;
  float* pw = pdb1 + (size_t)B * tiles * C;
  cudaError_t err;

  if ((err = allow_smem(cffb_rows_kernel<EV, true>, bytes)) != cudaSuccess) return err;
  cffb_rows_kernel<EV, true><<<dim3(tiles, B), THREADS, bytes, stream>>>(
      a.x, a.w1, a.b1, a.w2, a.b2, a.ln_s, a.ln_b, a.film, a.seeds, g, dr, h, da2c, pfilm,
      pvec, T, C, a.cb, a.drop, a.bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = allow_smem(cffb_hidden_kernel<EV>, bytes)) != cudaSuccess) return err;
  cffb_hidden_kernel<EV><<<dim3(tiles, B), THREADS, bytes, stream>>>(
      da2c, h, dr, w2r, w1r, da1c, pdb1, dx, T, C, a.cb, a.bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = weight_grads(a.x, da1c, h, da2c, pw, dw1, dw2, B, T, E, C, a.bf16, stream)) !=
      cudaSuccess)
    return err;
  if ((err = sum_rows(pdb1, db1, 1, B * tiles, C, stream)) != cudaSuccess) return err;
  if ((err = sum_rows(pvec, dvec, 1, B * tiles, 3 * E, stream)) != cudaSuccess) return err;
  return sum_rows(pfilm, dfilm, B, tiles, 2 * E, stream);
}

// What the kernels take: E = 128, 256, 384 or 512; cb a multiple of 128
// dividing C; the tile within the 227 KB of shared memory a block can use.
bool takes(int E, int C, int cb) {
  return E % 128 == 0 && E >= 128 && E <= 512 && cb > 0 && cb % 128 == 0 && C % cb == 0 &&
         smem_bytes(E, cb) <= 227 * 1024;
}

}  // namespace

// Floats of device scratch the backward needs at (B, T, E, C).
extern "C" long long conv_ff_blocked_workspace_floats(int B, int T, int E, int C) {
  const long long bt = (long long)B * T, tiles = (long long)B * n_tiles(T);
  return 2 * bt * C + 2 * bt * E + tiles * (5 * E + C) +
         (long long)n_splits(B, T) * 3 * E * C;
}

// x, out: (B, T, E) f32; w1 (3, E, C), w2 (3, C, E) rounded to the dot
// dtype; b1 (C,), b2, ln_s, ln_b (E,); film (B, 2E); seeds (B,) int32.
extern "C" int conv_ff_blocked_forward(const float* x, const float* w1, const float* b1,
                                       const float* w2, const float* b2, const float* ln_s,
                                       const float* ln_b, const float* film,
                                       const int* seeds, float* out, int B, int T, int E,
                                       int C, int c_block, int use_dropout,
                                       unsigned int threshold, float keep, int round_bf16,
                                       void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!takes(E, C, c_block)) return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, B, T, C, c_block,
               Dropout{use_dropout != 0, threshold, keep}, round_bf16 != 0};
  switch (E) {
    case 128: return forward<1>(a, out, stream);
    case 256: return forward<2>(a, out, stream);
    case 384: return forward<3>(a, out, stream);
    default: return forward<4>(a, out, stream);
  }
}

// g: (B, T, E) cotangent; w1r (3, C, E), w2r (3, E, C) the tap-reversed
// transposes (rounded); ws: conv_ff_blocked_workspace_floats(B, T, E, C)
// floats. Outputs: dx (B, T, E); dw1 (3, E, C); db1 (C,); dw2 (3, C, E);
// dvec (3E,) = [dLN scale | dLN bias | db2]; dfilm (B, 2E).
extern "C" int conv_ff_blocked_backward(
    const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* ln_s, const float* ln_b, const float* film, const int* seeds,
    const float* g, const float* w1r, const float* w2r, float* ws, float* dx, float* dw1,
    float* db1, float* dw2, float* dvec, float* dfilm, int B, int T, int E, int C,
    int c_block, int use_dropout, unsigned int threshold, float keep, int round_bf16,
    void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (!takes(E, C, c_block)) return cudaErrorInvalidValue;
  const Args a{x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, B, T, C, c_block,
               Dropout{use_dropout != 0, threshold, keep}, round_bf16 != 0};
  switch (E) {
    case 128:
      return backward<1>(a, g, w1r, w2r, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    case 256:
      return backward<2>(a, g, w1r, w2r, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    case 384:
      return backward<3>(a, g, w1r, w2r, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
    default:
      return backward<4>(a, g, w1r, w2r, ws, dx, dw1, db1, dw2, dvec, dfilm, stream);
  }
}
