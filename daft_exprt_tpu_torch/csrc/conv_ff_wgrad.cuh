// The conv-FF backward's cross-tile reductions, shared by the training
// conv-FF kernels K3 (conv_ff_train.cu) and K4 (conv_ff_blocked.cu):
// the k=3 weight-gradient products split over row chunks into partials,
// and fixed-order sums of partials. No float atomics, so two runs give
// bit-identical gradients.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_ff_tile.cuh"

namespace {

struct Dropout {
  bool on;
  uint32_t threshold;  // keep iff bits >= threshold
  float keep;          // 1 - rate: kept values are divided by it
};

constexpr int WG_TILE = 64;  // weight-gradient output tile (64 x 64)
constexpr int WG_ROWS = 32;  // rows per shared-memory chunk
constexpr int SPLIT_ROWS = 512;
constexpr int MAX_SPLITS = 32;

int n_splits(int B, int T) {
  const int rows = B * T;
  int s = (rows + SPLIT_ROWS - 1) / SPLIT_ROWS;
  return s < 1 ? 1 : (s > MAX_SPLITS ? MAX_SPLITS : s);
}

// Weight gradients, split over row chunks:
//   part[s][d][i][j] = sum_{rows (b, t) of chunk s} A[b, t+d-1, i] G[b, t, j]
// A (B, T, M) (rounded on load if round_a; rows outside [0, T) zero),
// G (B, T, N). Grid (N/64, M/64, 3 * splits), 256 threads, 4x4 per thread.
__global__ void __launch_bounds__(256)
wgrad_kernel(const float* __restrict__ A, const float* __restrict__ G,
             float* __restrict__ part, int B, int T, int M, int N, int splits,
             bool round_a, bool bf16) {
  const int j0 = blockIdx.x * WG_TILE, i0 = blockIdx.y * WG_TILE;
  const int d = blockIdx.z % 3, s = blockIdx.z / 3;
  const int rows = B * T;
  const int chunk = (rows + splits - 1) / splits;
  const int r_begin = s * chunk, r_end = min(rows, r_begin + chunk);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  __shared__ __align__(16) float As[WG_ROWS][WG_TILE];
  __shared__ __align__(16) float Gs[WG_ROWS][WG_TILE];
  float acc[4][4] = {};
  for (int r0 = r_begin; r0 < r_end; r0 += WG_ROWS) {
    for (int i = tid; i < WG_ROWS * WG_TILE / 4; i += 256) {
      const int rr = i / (WG_TILE / 4), c4 = i % (WG_TILE / 4);
      const int row = r0 + rr;
      float4 av = make_float4(0.f, 0.f, 0.f, 0.f), gv = av;
      if (row < r_end) {
        const int b = row / T, t = row % T, ts = t + d - 1;
        if (ts >= 0 && ts < T) {
          av = *reinterpret_cast<const float4*>(A + ((size_t)b * T + ts) * M + i0 + 4 * c4);
          if (round_a) {
            av.x = conv_ff::rnd(av.x, bf16); av.y = conv_ff::rnd(av.y, bf16);
            av.z = conv_ff::rnd(av.z, bf16); av.w = conv_ff::rnd(av.w, bf16);
          }
        }
        gv = *reinterpret_cast<const float4*>(G + (size_t)row * N + j0 + 4 * c4);
      }
      reinterpret_cast<float4*>(As[rr])[c4] = av;
      reinterpret_cast<float4*>(Gs[rr])[c4] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < WG_ROWS; ++k) {
      float a[4], gg[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = As[k][ty + 16 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u) gg[u] = Gs[k][tx + 16 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(a[u], gg[w], acc[u][w]);
    }
    __syncthreads();
  }
  float* dst = part + ((size_t)s * 3 + d) * M * N;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      dst[(size_t)(i0 + ty + 16 * u) * N + j0 + tx + 16 * w] = acc[u][w];
}

// out[g][n] = sum_{r < R} P[g][r][n], in order of r.
__global__ void sum_rows_kernel(const float* __restrict__ P, float* __restrict__ out,
                                int G, int R, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)G * N) return;
  const size_t gi = idx / N, n = idx % N;
  const float* p = P + gi * R * N + n;
  float s = 0.f;
  for (int r = 0; r < R; ++r) s += p[(size_t)r * N];
  out[idx] = s;
}

cudaError_t sum_rows(const float* P, float* out, int G, int R, int N, cudaStream_t st) {
  const size_t n = (size_t)G * N;
  sum_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(P, out, G, R, N);
  return cudaGetLastError();
}

// dW1 (3, E, C) from rnd(x) and rnd(da1); dW2 (3, C, E) from h and rnd(da2);
// pw holds n_splits(B, T) * 3 * E * C floats of partials.
cudaError_t weight_grads(const float* x, const float* da1c, const float* h,
                         const float* da2c, float* pw, float* dw1, float* dw2, int B,
                         int T, int E, int C, bool bf16, cudaStream_t stream) {
  const int splits = n_splits(B, T);
  cudaError_t err;
  wgrad_kernel<<<dim3(C / WG_TILE, E / WG_TILE, 3 * splits), 256, 0, stream>>>(
      x, da1c, pw, B, T, E, C, splits, true, bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_rows(pw, dw1, 1, splits, 3 * E * C, stream)) != cudaSuccess) return err;
  wgrad_kernel<<<dim3(E / WG_TILE, C / WG_TILE, 3 * splits), 256, 0, stream>>>(
      h, da2c, pw, B, T, C, E, splits, false, bf16);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_rows(pw, dw2, 1, splits, 3 * E * C, stream);
}

}  // namespace
