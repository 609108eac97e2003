// The conv feed-forward tile, shared by the inference FFT block (K1,
// fft_block.cu) and the training conv-FF (K3, conv_ff_train.cu).
//
// A 256-thread block works on a TT-row output tile of one batch row. Two
// stages of k=3 SAME convolutions as shifted products, both reading their
// input from shared memory:
//
//   conv_e_to_c: in (TT+4) x E  ->  out (TT+2) x C    (conv1; also the
//                data gradient through conv2 with tap-reversed weights)
//   conv_c_to_e: in (TT+2) x C  ->  TT x E registers  (conv2; also the
//                data gradient through conv1)
//
// so the (TT+2) x C hidden lives only in shared memory. Row r of a stage's
// output reads its input rows r, r+1, r+2 (taps d = 0, 1, 2). Products
// run on CUDA-core FMAs in f32. The model width EW is a template argument
// (default E = 128, K3's; K1 also takes 256 and 512): lane l of a warp
// owns the E-side columns 128 j + 4 l .. + 3, and the weight slice of
// conv_c_to_e keeps 3 x 16 x 128 floats at every width.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace conv_ff {

constexpr int E = 128;      // model width
constexpr int TT = 32;      // output rows per tile
constexpr int KC2 = 16;     // conv_c_to_e weight slice (channels)
constexpr int THREADS = 256;
constexpr int RG = (TT + 2) / 2;  // conv_e_to_c rows per pass (2 passes)
constexpr int RW = TT / 8;        // conv_c_to_e rows per warp
static_assert(TT % 8 == 0, "8 warps split the tile rows");

// Channels of conv_c_to_e's weight slice at width EW (16, 8, 4).
template <int EW = E>
__host__ __device__ constexpr int kc2() { return KC2 * E / EW; }

// Shared memory of one tile: in (TT+4) x EW, hidden (TT+2) x C, and the
// 3 x kc2 x EW weight slice of conv_c_to_e.
template <int EW = E>
__host__ __device__ constexpr size_t smem_floats(int C) {
  return (size_t)(TT + 4) * EW + (size_t)(TT + 2) * C + 3 * kc2<EW>() * EW;
}

__device__ __forceinline__ float rnd(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// out[r][c] = epi(r, c0, acc) for the 4 channels c0..c0+3 a thread owns,
// acc[i] = sum_d sum_e in[r + d][e] * w[d][e][c0 + i]; w is (3, EW, C).
template <int EW = E, class Epi>
__device__ __forceinline__ void conv_e_to_c(const float* in, const float* __restrict__ w,
                                            float* out, int C, Epi epi) {
  for (int c0 = 4 * threadIdx.x; c0 < C; c0 += 4 * THREADS) {
    for (int r0 = 0; r0 < TT + 2; r0 += RG) {
      float acc[RG][4];
#pragma unroll
      for (int r = 0; r < RG; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
      for (int d = 0; d < 3; ++d) {
        const float* wd = w + (size_t)d * EW * C + c0;
        const float* xd = in + (r0 + d) * EW;
#pragma unroll 4
        for (int e = 0; e < EW; ++e) {
          const float4 wv = *reinterpret_cast<const float4*>(wd + (size_t)e * C);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float a = xd[r * EW + e];
            acc[r][0] = fmaf(a, wv.x, acc[r][0]);
            acc[r][1] = fmaf(a, wv.y, acc[r][1]);
            acc[r][2] = fmaf(a, wv.z, acc[r][2]);
            acc[r][3] = fmaf(a, wv.w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r)
        *reinterpret_cast<float4*>(out + (size_t)(r0 + r) * C + c0) = epi(r0 + r, c0, acc[r]);
    }
  }
}

// acc[r][4 j + i] += sum_d sum_c in[warp*RW + r + d][c] * w[d][c][128 j + 4 lane + i];
// w is (3, C, EW), staged through ws (3 x kc2 x EW floats). Warp w owns
// tile rows w*RW .. w*RW+RW-1 and lane l columns 128 j + 4l .. + 3, so a
// row's EW-wide reductions stay within one warp.
template <int EW = E>
__device__ __forceinline__ void conv_c_to_e(const float* in, const float* __restrict__ w,
                                            float* ws, int C,
                                            float (&acc)[RW][4 * (EW / 128)]) {
  constexpr int EV = EW / 128, K = kc2<EW>();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int i = 0; i < 4 * EV; ++i) acc[r][i] = 0.f;
  for (int c0 = 0; c0 < C; c0 += K) {
    for (int i = tid; i < 3 * K * EW / 4; i += THREADS) {
      const int d = i / (K * EW / 4), rem = i % (K * EW / 4);
      const int cc = rem / (EW / 4), e4 = rem % (EW / 4);
      reinterpret_cast<float4*>(ws)[i] =
          *reinterpret_cast<const float4*>(w + ((size_t)d * C + c0 + cc) * EW + 4 * e4);
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll 4
      for (int cc = 0; cc < K; ++cc) {
        const float4* wr = reinterpret_cast<const float4*>(ws + (d * K + cc) * EW);
#pragma unroll
        for (int j = 0; j < EV; ++j) {
          const float4 wv = wr[32 * j + lane];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const float a = in[(size_t)(warp * RW + r + d) * C + c0 + cc];
            acc[r][4 * j] = fmaf(a, wv.x, acc[r][4 * j]);
            acc[r][4 * j + 1] = fmaf(a, wv.y, acc[r][4 * j + 1]);
            acc[r][4 * j + 2] = fmaf(a, wv.z, acc[r][4 * j + 2]);
            acc[r][4 * j + 3] = fmaf(a, wv.w, acc[r][4 * j + 3]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Sum over the 32 lanes of a warp.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace conv_ff
