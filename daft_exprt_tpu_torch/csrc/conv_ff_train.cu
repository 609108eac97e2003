// Training conv feed-forward, forward and backward, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels daft_exprt_tpu/ops/conv_ff_train.py
// _fwd_kernel and _bwd_kernel (K3). Per batch row (T rows of width
// E = 128, C hidden channels, k=3 SAME convs, rows outside [0, T) zero):
//
//   a1 = conv1(rnd(x)) + b1;   h = rnd(relu(a1))
//   a2 = conv2(h) + b2;        r = drop(a2) + x,  drop(a) = keep ? a / (1 - rate) : 0
//   y  = LN(r) * s + b;        out = gamma * y + beta   (film = [gamma | beta])
//
// and its backward (dy_ln = g * gamma; LN backward per row):
//
//   dfilm = (sum_t g * y, sum_t g) per batch row
//   ds, db = sum dy_ln * n, sum dy_ln          (n = normalized r)
//   dr  = LN_bwd(dy_ln);  da2 = drop(dr);      db2 = sum da2
//   dW2[d] = sum shift_d(h)^T rnd(da2)
//   dh  = conv2^T(rnd(da2));  da1 = a1 > 0 ? dh : 0;  db1 = sum da1
//   dW1[d] = sum shift_d(rnd(x))^T rnd(da1)
//   dx  = dr + conv1^T(rnd(da1))
//
// rnd() rounds to bfloat16 at bf16 dot precision (identity at f32), at
// the points where the Pallas kernels cast; weights arrive rounded from
// the wrapper. There is no length mask: the block masks rows afterwards.
// Dropout bits are those of the JAX kernels (salt 0, row t, col e).
//
// What bounds it on this card: operations. At the flagship training
// shape (B=16, T=768, C=1024) the forward does 19.3 GFLOP against ~15 MB
// of compulsory traffic, the backward three times the FLOPs.
//
// Design. Blocks run in parallel in no order, so the TPU kernel's
// sequential accumulation of the weight gradients over the grid does not
// carry over; the backward is six launches with fixed-order sums, no
// float atomics, so two runs give bit-identical gradients:
//   1. rows kernel (per 32-row tile): recompute the hidden (TT+2 rows, in
//      shared memory, as the forward), write h (B, T, C) to device
//      memory, then a2, r, LN and the LN backward: dr and rnd(da2)
//      (B, T, E), and per-tile partial sums of dfilm, dLN and db2;
//   2. hidden kernel (per tile): dh over TT+2 rows from rnd(da2) rows
//      lo-2 .. lo+TT+1 (conv_e_to_c with tap-reversed W2^T), the ReLU
//      mask from h, per-tile db1 partials, rnd(da1) (B, T, C) to device
//      memory, and dx = dr + conv1^T(rnd(da1)) (conv_c_to_e);
//   3./4. weight-gradient products dW1 and dW2, each split over row
//      chunks into partials (fixed split count), then reduced in order;
//   5. one reduction of the small per-tile partials
// (3.-5. in conv_ff_wgrad.cuh, shared with K4). So the (B, T, C) tensors
// h and rnd(da1) do pass through device memory in the backward (2 x 50 MB
// each way at the flagship shape, f32); the forward keeps the hidden in
// shared memory. The products run on CUDA-core FMAs; tensor cores are
// later work. Widths this tile does not take run the C-blocked K4
// (conv_ff_blocked.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_ff_tile.cuh"
#include "conv_ff_wgrad.cuh"
#include "dropout_hash.cuh"

namespace {

using conv_ff::E;
using conv_ff::RW;
using conv_ff::TT;
using conv_ff::rnd;
using conv_ff::warp_sum;

constexpr float LN_EPS = 1e-5f;
int n_tiles(int T) { return (T + TT - 1) / TT; }

// Load rows lo-2 .. lo+TT+1 of a (T, E) matrix into in[(TT+4) x E],
// rounded; rows outside [0, T) are zero.
__device__ __forceinline__ void load_halo(float* in, const float* src, int lo, int T,
                                          bool bf16) {
  for (int i = threadIdx.x; i < (TT + 4) * E; i += conv_ff::THREADS) {
    const int t = lo - 2 + i / E;
    in[i] = (t >= 0 && t < T) ? rnd(src[(size_t)t * E + i % E], bf16) : 0.f;
  }
}

// -------------------------------------------------------------------
// Forward (BWD = false) and backward launch 1 (BWD = true).
// Grid (ceil(T/TT), B), 256 threads, dynamic shared memory
// conv_ff::smem_floats(C) floats.
// -------------------------------------------------------------------
template <bool BWD>
__global__ void __launch_bounds__(256)
cff_rows_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ ln_s,
                const float* __restrict__ ln_b, const float* __restrict__ film,
                const int* __restrict__ seeds, const float* __restrict__ g,
                float* __restrict__ out, float* __restrict__ h_out,
                float* __restrict__ da2c, float* __restrict__ pfilm,
                float* __restrict__ pvec, int T, int C, Dropout drop, bool bf16) {
  const int b = blockIdx.y, tile = blockIdx.x, lo = tile * TT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  float* ext = smem;
  float* hid = ext + (TT + 4) * E;
  float* ws = hid + (TT + 2) * C;
  const float* xb = x + (size_t)b * T * E;

  load_halo(ext, xb, lo, T, bf16);
  __syncthreads();
  conv_ff::conv_e_to_c(ext, w1, hid, C, [&](int r, int c0, const float* a) {
    const int t = lo - 1 + r;
    const bool inside = t >= 0 && t < T;
    const float4 bias = *reinterpret_cast<const float4*>(b1 + c0);
    float4 hv;
    hv.x = inside ? rnd(fmaxf(a[0] + bias.x, 0.f), bf16) : 0.f;
    hv.y = inside ? rnd(fmaxf(a[1] + bias.y, 0.f), bf16) : 0.f;
    hv.z = inside ? rnd(fmaxf(a[2] + bias.z, 0.f), bf16) : 0.f;
    hv.w = inside ? rnd(fmaxf(a[3] + bias.w, 0.f), bf16) : 0.f;
    if (BWD && r >= 1 && r <= TT && t < T)  // the tile's own rows
      *reinterpret_cast<float4*>(h_out + ((size_t)b * T + t) * C + c0) = hv;
    return hv;
  });
  __syncthreads();
  float acc[RW][4];
  conv_ff::conv_c_to_e(hid, w2, ws, C, acc);

  const int n = 4 * lane;
  const float4 bias2 = *reinterpret_cast<const float4*>(b2 + n);
  const float4 s4 = *reinterpret_cast<const float4*>(ln_s + n);
  const float4 o4 = *reinterpret_cast<const float4*>(ln_b + n);
  const float4 gam = *reinterpret_cast<const float4*>(film + (size_t)b * 2 * E + n);
  const float4 bet = *reinterpret_cast<const float4*>(film + (size_t)b * 2 * E + E + n);
  const float sv[4] = {s4.x, s4.y, s4.z, s4.w}, ov[4] = {o4.x, o4.y, o4.z, o4.w};
  const float gv[4] = {gam.x, gam.y, gam.z, gam.w}, bv[4] = {bet.x, bet.y, bet.z, bet.w};
  const float b2v[4] = {bias2.x, bias2.y, bias2.z, bias2.w};
  const uint32_t seed = (uint32_t)seeds[b];
  // per-lane partial sums over this warp's rows: g*y, g, dy*n, dy, da2
  float part[5][4] = {};

#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int t = lo + warp * RW + rr;
    const bool inside = t < T;
    float xr[4] = {0.f, 0.f, 0.f, 0.f};
    if (inside) {
      const float4 x4 = *reinterpret_cast<const float4*>(xb + (size_t)t * E + n);
      xr[0] = x4.x; xr[1] = x4.y; xr[2] = x4.z; xr[3] = x4.w;
    }
    bool keep[4] = {true, true, true, true};
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a2 = acc[rr][i] + b2v[i];
      if (drop.on) {
        keep[i] = dropout_bits(seed, 0u, (uint32_t)t, (uint32_t)(n + i)) >= drop.threshold;
        a2 = keep[i] ? a2 / drop.keep : 0.f;
      }
      v[i] = a2 + xr[i];
    }
    const float mean = warp_sum(v[0] + v[1] + v[2] + v[3]) / E;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) sq += (v[i] - mean) * (v[i] - mean);
    const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
    float nrm[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nrm[i] = (v[i] - mean) * inv;
      y[i] = nrm[i] * sv[i] + ov[i];
    }
    if (!BWD) {
      if (inside)
        *reinterpret_cast<float4*>(out + ((size_t)b * T + t) * E + n) =
            make_float4(gv[0] * y[0] + bv[0], gv[1] * y[1] + bv[1],
                        gv[2] * y[2] + bv[2], gv[3] * y[3] + bv[3]);
      continue;
    }
    float gr[4] = {0.f, 0.f, 0.f, 0.f};
    if (inside) {
      const float4 g4 = *reinterpret_cast<const float4*>(g + ((size_t)b * T + t) * E + n);
      gr[0] = g4.x; gr[1] = g4.y; gr[2] = g4.z; gr[3] = g4.w;
    }
    float dn[4], dy[4];
    float s_dn = 0.f, s_dnn = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dy[i] = gr[i] * gv[i];
      dn[i] = dy[i] * sv[i];
      s_dn += dn[i];
      s_dnn += dn[i] * nrm[i];
    }
    const float m_dn = warp_sum(s_dn) / E, m_dnn = warp_sum(s_dnn) / E;
    float dr[4], da2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dr[i] = (dn[i] - m_dn - nrm[i] * m_dnn) * inv;
      da2[i] = drop.on ? (keep[i] ? dr[i] / drop.keep : 0.f) : dr[i];
    }
    if (inside) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[0][i] += gr[i] * y[i];
        part[1][i] += gr[i];
        part[2][i] += dy[i] * nrm[i];
        part[3][i] += dy[i];
        part[4][i] += da2[i];
      }
      const size_t o = ((size_t)b * T + t) * E + n;
      *reinterpret_cast<float4*>(out + o) = make_float4(dr[0], dr[1], dr[2], dr[3]);
      *reinterpret_cast<float4*>(da2c + o) =
          make_float4(rnd(da2[0], bf16), rnd(da2[1], bf16), rnd(da2[2], bf16),
                      rnd(da2[3], bf16));
    }
  }
  if (!BWD) return;

  // Per-tile partials: the 8 warps' sums, added in warp order.
  float* red = hid;  // the hidden is no longer read
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[(warp * 5 + k) * E + n + i] = part[k][i];
  __syncthreads();
  const int tiles = gridDim.x;
  for (int i = tid; i < 5 * E; i += conv_ff::THREADS) {
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
// Backward launch 2: dh, da1, db1 partials, rnd(da1) and dx per tile.
// w2r (3, E, C): w2r[d] = W2[2 - d]^T; w1r (3, C, E): w1r[d] = W1[2 - d]^T.
// -------------------------------------------------------------------
__global__ void __launch_bounds__(256)
cff_hidden_kernel(const float* __restrict__ da2c, const float* __restrict__ h,
                  const float* __restrict__ dr, const float* __restrict__ w2r,
                  const float* __restrict__ w1r, float* __restrict__ da1c,
                  float* __restrict__ pdb1, float* __restrict__ dx, int T, int C,
                  bool bf16) {
  const int b = blockIdx.y, tile = blockIdx.x, lo = tile * TT;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  float* ext = smem;
  float* hid = ext + (TT + 4) * E;
  float* ws = hid + (TT + 2) * C;

  load_halo(ext, da2c + (size_t)b * T * E, lo, T, false);  // already rounded
  __syncthreads();
  // dh rows lo-1 .. lo+TT; da1 = dh where the hidden was positive
  // (h = rnd(relu(a1)) > 0 iff a1 > 0), zero outside [0, T).
  conv_ff::conv_e_to_c(ext, w2r, hid, C, [&](int r, int c0, const float* a) {
    const int t = lo - 1 + r;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      const float4 hv = *reinterpret_cast<const float4*>(h + ((size_t)b * T + t) * C + c0);
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
  const int rows = min(TT, T - lo);
  for (int c = tid; c < C; c += conv_ff::THREADS) {
    float s = 0.f;
    for (int r = 1; r <= rows; ++r) s += hid[(size_t)r * C + c];
    pdb1[((size_t)b * gridDim.x + tile) * C + c] = s;
  }
  __syncthreads();
  for (int i = tid; i < (TT + 2) * C; i += conv_ff::THREADS) {
    const float v = rnd(hid[i], bf16);
    hid[i] = v;
    const int r = i / C;
    if (r >= 1 && r <= rows)
      da1c[((size_t)b * T + lo - 1 + r) * C + i % C] = v;
  }
  __syncthreads();
  float acc[RW][4];
  conv_ff::conv_c_to_e(hid, w1r, ws, C, acc);
  const int n = 4 * lane;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int t = lo + warp * RW + rr;
    if (t >= T) continue;
    const size_t o = ((size_t)b * T + t) * E + n;
    const float4 d4 = *reinterpret_cast<const float4*>(dr + o);
    *reinterpret_cast<float4*>(dx + o) =
        make_float4(d4.x + acc[rr][0], d4.y + acc[rr][1], d4.z + acc[rr][2],
                    d4.w + acc[rr][3]);
  }
}

size_t smem_bytes(int C) { return sizeof(float) * conv_ff::smem_floats(C); }

template <class K>
cudaError_t allow_smem(K kernel, int C) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(C));
}

}  // namespace

// Floats of device scratch the backward needs at (B, T, C).
extern "C" long long conv_ff_train_workspace_floats(int B, int T, int C) {
  const long long bt = (long long)B * T, tiles = (long long)B * n_tiles(T);
  return 2 * bt * C + 2 * bt * E + tiles * (5 * E + C) +
         (long long)n_splits(B, T) * 3 * E * C;
}

// x, out: (B, T, 128) f32; w1 (3, E, C), w2 (3, C, E) rounded to the dot
// dtype; b1 (C,), b2, ln_s, ln_b (E,); film (B, 2E); seeds (B,) int32.
// The wrapper checks C % 64 == 0 and that the tile fits shared memory.
extern "C" int conv_ff_train_forward(const float* x, const float* w1, const float* b1,
                                     const float* w2, const float* b2, const float* ln_s,
                                     const float* ln_b, const float* film,
                                     const int* seeds, float* out, int B, int T, int C,
                                     int use_dropout, unsigned int threshold, float keep,
                                     int round_bf16, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (smem_bytes(C) > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(cff_rows_kernel<false>, C);
  if (err != cudaSuccess) return err;
  const Dropout drop{use_dropout != 0, threshold, keep};
  cff_rows_kernel<false><<<dim3(n_tiles(T), B), 256, smem_bytes(C), stream>>>(
      x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, nullptr, out, nullptr, nullptr, nullptr,
      nullptr, T, C, drop, round_bf16 != 0);
  return cudaGetLastError();
}

// g: (B, T, E) cotangent; w1r (3, C, E), w2r (3, E, C) the tap-reversed
// transposes (rounded); ws: conv_ff_train_workspace_floats(B, T, C)
// floats. Outputs: dx (B, T, E); dw1 (3, E, C); db1 (C,); dw2 (3, C, E);
// dvec (3E,) = [dLN scale | dLN bias | db2]; dfilm (B, 2E).
extern "C" int conv_ff_train_backward(
    const float* x, const float* w1, const float* b1, const float* w2, const float* b2,
    const float* ln_s, const float* ln_b, const float* film, const int* seeds,
    const float* g, const float* w1r, const float* w2r, float* ws, float* dx, float* dw1,
    float* db1, float* dw2, float* dvec, float* dfilm, int B, int T, int C,
    int use_dropout, unsigned int threshold, float keep, int round_bf16,
    void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (smem_bytes(C) > 227 * 1024) return cudaErrorInvalidValue;
  const bool bf16 = round_bf16 != 0;
  const Dropout drop{use_dropout != 0, threshold, keep};
  const int tiles = n_tiles(T);
  const size_t bt = (size_t)B * T;
  float* h = ws;
  float* da1c = h + bt * C;
  float* dr = da1c + bt * C;
  float* da2c = dr + bt * E;
  float* pfilm = da2c + bt * E;
  float* pvec = pfilm + (size_t)B * tiles * 2 * E;
  float* pdb1 = pvec + (size_t)B * tiles * 3 * E;
  float* pw = pdb1 + (size_t)B * tiles * C;
  cudaError_t err;

  if ((err = allow_smem(cff_rows_kernel<true>, C)) != cudaSuccess) return err;
  cff_rows_kernel<true><<<dim3(tiles, B), 256, smem_bytes(C), stream>>>(
      x, w1, b1, w2, b2, ln_s, ln_b, film, seeds, g, dr, h, da2c, pfilm, pvec, T, C, drop,
      bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = allow_smem(cff_hidden_kernel, C)) != cudaSuccess) return err;
  cff_hidden_kernel<<<dim3(tiles, B), 256, smem_bytes(C), stream>>>(
      da2c, h, dr, w2r, w1r, da1c, pdb1, dx, T, C, bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = weight_grads(x, da1c, h, da2c, pw, dw1, dw2, B, T, E, C, bf16, stream)) !=
      cudaSuccess)
    return err;
  if ((err = sum_rows(pdb1, db1, 1, B * tiles, C, stream)) != cudaSuccess) return err;
  if ((err = sum_rows(pvec, dvec, 1, B * tiles, 3 * E, stream)) != cudaSuccess) return err;
  return sum_rows(pfilm, dfilm, B, tiles, 2 * E, stream);
}
