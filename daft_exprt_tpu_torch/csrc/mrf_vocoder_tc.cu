// Fused multi-receptive-field (MRF) vocoder stage (K5), tensor-core
// instance, for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel daft_exprt_tpu/ops/mrf_vocoder.py
// _make_kernel (K5) at C = 32, 64 and 128 (every stage of a V1 generator);
// C = 8 and 16 keep the CUDA-core instance (mrf_vocoder.cu), whose header
// states the function: per chain and dilation unit
//
//   x <- x + mask(conv2(rnd(leaky(mask(conv1_d(rnd(leaky(x))) + b1)))) + b2)
//
// bf16 operands and weights, f32 sums, f32 carries, out = the chains'
// sum in order times 1 / nk.
//
// What bounds it on this card: operations. A V1 pass does 1.9 TFLOP of
// products (126 taps of 2 C^2 FLOPs per sample and stage) against 8 C
// bytes of compulsory traffic per sample, ~8,000 FLOP per byte.
//
// Design. Every conv is a shifted-row GEMM on the tensor cores (mma.sync
// m16n8k16 bf16 -> f32): output rows r, K = k C, tap i reads operand row
// r - pad + i d, and ldmatrix takes one row address per lane, so the
// dilated shift costs nothing. Each 32-channel chunk of a tap is summed on
// the tensor cores and added into the float32 accumulators with a rounded
// add. One block owns one batch row's tile of TN
// output samples and keeps every inter-conv activation of the fan in
// shared memory: the f32 carry X and one bf16 operand A over the tile and
// the widest chain's halo (R = TN + 2H rows, rows padded by 16 bytes for
// conflict-free ldmatrix phases). A single operand buffer suffices because
// each conv's whole output stays in registers until every warp has read
// its operand (the ring's closing barrier); the epilogue then overwrites A
// in place: conv1 with rnd(leaky(mask(acc + b1))), conv2 with the next
// unit's rnd(leaky(X)) after X += mask(acc + b2). The chains' sum never
// needs shared memory: a chain's last epilogue adds the tile into the
// block's own rows of out, in chain order (no other block writes them).
// Weights stream through a 3-stage cp.async ring, 32 input channels of one
// tap (C x 32 bf16) a stage.
//
// Warps: a warp's tile is 16-row m16 tiles times WC = min(C, 64) output
// columns; the C / WC column groups times RG = 8 / (C / WC) row groups
// cover the block. A conv's region [lo + pad, hi - pad) shrinks with the
// chain's remaining halo; its m16 tiles go round-robin to the row groups,
// up to MT a warp (128 f32 accumulators a lane), so a short region costs
// proportionally less. The tile: the largest TN (a multiple of 16) whose
// R rows fit shared memory and the warps' accumulators (plan_mrf in
// ops/mrf_vocoder.py mirrors tile_rows and mrf_smem_bytes): TN = 128 /
// 384 / 816 at C = 128 / 64 / 32 for V1's halo of 60, one block of 8 warps
// per SM. Rows past a region's end in its last m16 tile read clamped
// operand rows and are never stored.
//
// One launch per stage on the caller's stream, grid (ceil(N / TN), B),
// 256 threads, no allocation, no atomics: the output is bit-identical
// from run to run.
//
// Two alternatives to the design's choices are built beside it for
// chip_smoke.py to time against it (mrf_tc_forward_variant; no path runs
// them): ONE_ACCUMULATOR sums every product of a conv in the f32
// accumulators on the tensor cores, and WEIGHTS_FROM_L2 reads each warp's
// B fragments straight from global memory (L2) with no ring, from taps
// laid out (n_taps, C_out, C_in) so that a lane's pair of input channels is
// one 32-bit word; it computes the same products in the same order as the
// shipped kernel, so its output is bit-identical to it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_ff_tc.cuh"

namespace {

using tc::bf16;

constexpr int THREADS = 256;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block (H100)
constexpr int CK = 32;              // input channels of one ring stage
constexpr int PAD = 8;              // elements of padding per shared-memory row
constexpr float SLOPE = 0.1f;

// descriptor flags (ops/mrf_vocoder.py)
constexpr int CHAIN_START = 1, TO_CARRY = 4, CHAIN_END = 8, FIRST_CHAIN = 16;

// the kernel's variants (see the header)
constexpr int SHIPPED = 0, ONE_ACCUMULATOR = 1, WEIGHTS_FROM_L2 = 2;

template <int C>
struct Shape {
  static constexpr int WC = C < 64 ? C : 64;  // a warp's output columns
  static constexpr int NT = WC / 8;           // its n8 tiles
  static constexpr int CG = C / WC;           // column groups
  static constexpr int RG = 8 / CG;           // row groups
  static constexpr int MT = 32 / NT;          // m16 tiles a warp holds
  static constexpr int LD = C + PAD;          // row stride of X, A and the ring
  static constexpr int STAGE = CK * LD;       // bf16 of one ring stage
  static constexpr int ROW_BYTES = LD * 4 + LD * 2;
  static constexpr int RING_BYTES = cftc::STAGES * STAGE * 2;
  static constexpr int MAX_ROWS = RG * MT * 16;
};

template <int C>
int tile_rows(int H) {
  using S = Shape<C>;
  int rows = (SMEM_LIMIT - S::RING_BYTES) / S::ROW_BYTES;
  if (rows > S::MAX_ROWS) rows = S::MAX_ROWS;
  const int tn = (rows - 2 * H) / 16 * 16;
  return tn >= 16 ? tn : 0;
}

template <int C>
int smem_bytes(int H) {
  using S = Shape<C>;
  const int tn = tile_rows<C>(H);
  return tn ? (tn + 2 * H) * S::ROW_BYTES + S::RING_BYTES : 0;
}

__device__ __forceinline__ float leaky(float v) { return v >= 0.f ? v : v * SLOPE; }

template <int C, int VARIANT>
__global__ void __launch_bounds__(THREADS, 1)
mrf_tc_kernel(const float* __restrict__ x, const bf16* __restrict__ w_taps,
              const float* __restrict__ biases, const int* __restrict__ desc,
              float* __restrict__ out, int N, int n_convs, int H, int TN, float inv_nk) {
  using S = Shape<C>;
  constexpr int LD = S::LD, NT = S::NT, MT = S::MT, RG = S::RG, KC = C / CK;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = TN + 2 * H;
  float* X = reinterpret_cast<float*>(smem);
  bf16* A = reinterpret_cast<bf16*>(X + R * LD);
  bf16* ring = A + R * LD;
  const uint32_t a_base = tc::saddr(A);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp % RG, c_lo = (warp / RG) * S::WC;
  const int b = blockIdx.y, t0 = blockIdx.x * TN, g0 = t0 - H;
  const float* xb = x + (size_t)b * N * C;
  float* ob = out + (size_t)b * N * C;

  int lo = 0, hi = 0;
  for (int ci = 0; ci < n_convs; ++ci) {
    const int k = __ldg(desc + 5 * ci), d = __ldg(desc + 5 * ci + 1);
    const int tap0 = __ldg(desc + 5 * ci + 2), flags = __ldg(desc + 5 * ci + 3);
    if (flags & CHAIN_START) {
      // X rows [lo, hi) <- x (zero outside [0, N)), A <- rnd(leaky(X))
      const int reach = __ldg(desc + 5 * ci + 4);
      lo = H - reach;
      hi = H + TN + reach;
      constexpr int C4 = C / 4;
      for (int i = tid; i < (hi - lo) * C4; i += THREADS) {
        const int r = lo + i / C4, c = (i % C4) * 4, g = g0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g >= 0 && g < N) v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)g * C + c));
        *reinterpret_cast<float4*>(X + r * LD + c) = v;
        uint2 p;
        p.x = tc::pack(leaky(v.x), leaky(v.y));
        p.y = tc::pack(leaky(v.z), leaky(v.w));
        *reinterpret_cast<uint2*>(A + r * LD + c) = p;
      }
      __syncthreads();
    }
    const int pad = (k - 1) * d / 2, olo = lo + pad, ohi = hi - pad;
    const int ntiles = (ohi - olo + 15) / 16;
    const int mine = ntiles > rg ? (ntiles - rg + RG - 1) / RG : 0;

    float acc[MT][NT][4];
#pragma unroll
    for (int s = 0; s < MT; ++s)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][n][e] = 0.f;

    const bf16* w = w_taps + (size_t)tap0 * C * C;
    auto load = [&](bf16* ws, int i) {  // chunk i: input channels (i % KC) CK.. of tap i / KC
      const bf16* src = w + ((size_t)(i / KC) * C + (i % KC) * CK) * C;
      for (int j = tid; j < CK * (C / 8); j += THREADS) {
        const int r = j / (C / 8), c = (j % (C / 8)) * 8;
        tc::cp16(tc::saddr(ws + r * LD + c), src + (size_t)r * C + c, true);
      }
    };
    // Each chunk's products go into a fresh accumulator that is then added
    // into acc with a rounded float32 add. With one accumulator taking all
    // k C products (ONE_ACCUMULATOR), the tensor cores' own float32 sums
    // end further from exact sums than the staged convs' (chip_smoke.py's
    // mrf_exact check at C=128 on an H100); chains of 2 k16 steps keep
    // their error small.
    using Frags = uint32_t[CK / 16][NT / 2][4];
    auto products = [&](const Frags& bfr, int i) {
      const int shift = (i / KC) * d - pad, k0 = (i % KC) * CK;
#pragma unroll
      for (int s = 0; s < MT; ++s) {
        if (s >= mine) continue;
        int row = olo + 16 * (rg + RG * s) + (lane & 15) + shift;
        row = row < R - 1 ? row : R - 1;
        float part[NT][4] = {};
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks) {
          uint32_t afr[4];
          tc::ldsm(afr, a_base + 2 * (row * LD + k0 + 16 * ks + (lane >> 4) * 8));
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint32_t b0 = bfr[ks][n >> 1][2 * (n & 1)];
            const uint32_t b1 = bfr[ks][n >> 1][2 * (n & 1) + 1];
            if constexpr (VARIANT == ONE_ACCUMULATOR)
              tc::mma(acc[s][n], afr, b0, b1);
            else
              tc::mma(part[n], afr, b0, b1);
          }
        }
        if constexpr (VARIANT != ONE_ACCUMULATOR) {
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[s][n][e] += part[n][e];
        }
      }
    };
    if constexpr (VARIANT == WEIGHTS_FROM_L2) {
      for (int i = 0; i < k * KC; ++i) {
        // w: (taps, C_out, C_in); b0 / b1 of n8 tile n: input channels
        // 2 (lane % 4) + {0, 1} and + 8, output channel lane / 4
        const bf16* src = w + (size_t)(i / KC) * C * C + (i % KC) * CK + 2 * (lane & 3);
        Frags bfr;
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks)
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const unsigned int* p = reinterpret_cast<const unsigned int*>(
                src + (size_t)(c_lo + 8 * n + (lane >> 2)) * C + 16 * ks);
            bfr[ks][n >> 1][2 * (n & 1)] = __ldg(p);
            bfr[ks][n >> 1][2 * (n & 1) + 1] = __ldg(p + 4);
          }
        products(bfr, i);
      }
      __syncthreads();  // every operand read: the epilogue may overwrite A
    } else {
      auto compute = [&](uint32_t wt, int i) {
        Frags bfr;
#pragma unroll
        for (int ks = 0; ks < CK / 16; ++ks)
#pragma unroll
          for (int nn = 0; nn < NT / 2; ++nn)
            tc::ldsm_t(bfr[ks][nn], tc::a_addr<LD>(wt, 16 * ks, c_lo + 16 * nn, lane));
        products(bfr, i);
      };
      // ends with every operand read: the epilogue may overwrite A in place
      cftc::ring<S::STAGE>(ring, k * KC, load, compute);
    }

    const float* bias = biases + ci * C;
    const bool to_carry = flags & TO_CARRY, end = flags & CHAIN_END;
    const bool first = flags & FIRST_CHAIN, last = ci == n_convs - 1;
#pragma unroll
    for (int s = 0; s < MT; ++s) {
      if (s >= mine) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = olo + 16 * (rg + RG * s) + (lane >> 2) + 8 * h;
        if (r >= ohi) continue;
        const int g = g0 + r;
        const bool valid = g >= 0 && g < N;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int c = c_lo + 8 * n + 2 * (lane & 3);
          const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + c));
          const float y0 = valid ? acc[s][n][2 * h] + bv.x : 0.f;
          const float y1 = valid ? acc[s][n][2 * h + 1] + bv.y : 0.f;
          uint32_t* a2 = reinterpret_cast<uint32_t*>(A + r * LD + c);
          if (!to_carry) {
            *a2 = tc::pack(leaky(y0), leaky(y1));
            continue;
          }
          float2* xr = reinterpret_cast<float2*>(X + r * LD + c);
          float2 v = *xr;
          v.x += y0;
          v.y += y1;
          if (!end) {
            *xr = v;
            *a2 = tc::pack(leaky(v.x), leaky(v.y));
          } else if (valid) {  // the tile's row r - H: add the chain into out
            float2* o = reinterpret_cast<float2*>(ob + (size_t)g * C + c);
            if (!first) {
              const float2 prev = *o;
              v.x = prev.x + v.x;
              v.y = prev.y + v.y;
            }
            if (last) {
              v.x *= inv_nk;
              v.y *= inv_nk;
            }
            *o = v;
          }
        }
      }
    }
    __syncthreads();
    lo = olo;
    hi = ohi;
  }
}

template <int C, int VARIANT>
int launch(const float* x, const void* w_taps, const float* biases, const int* desc,
           float* out, int B, int N, int n_convs, int H, int TN, int smem, float inv_nk,
           cudaStream_t stream) {
  if (TN != tile_rows<C>(H) || smem != smem_bytes<C>(H) || TN == 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mrf_tc_kernel<C, VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mrf_tc_kernel<C, VARIANT><<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(
      x, static_cast<const bf16*>(w_taps), biases, desc, out, N, n_convs, H, TN, inv_nk);
  return cudaGetLastError();
}

template <int VARIANT>
int launch_c(const float* x, const void* w_taps, const float* biases, const int* desc,
             float* out, int B, int N, int C, int n_convs, int H, int TN, int smem,
             float inv_nk, cudaStream_t stream) {
  if (H < 0 || n_convs <= 0 || B <= 0 || N <= 0) return cudaErrorInvalidValue;
  switch (C) {
    case 32:
      return launch<32, VARIANT>(x, w_taps, biases, desc, out, B, N, n_convs, H, TN, smem,
                                 inv_nk, stream);
    case 64:
      return launch<64, VARIANT>(x, w_taps, biases, desc, out, B, N, n_convs, H, TN, smem,
                                 inv_nk, stream);
    case 128:
      return launch<128, VARIANT>(x, w_taps, biases, desc, out, B, N, n_convs, H, TN, smem,
                                  inv_nk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of one block at width C and halo H (0: not taken):
// what plan_mrf mirrors.
extern "C" int mrf_smem_bytes(int C, int H) {
  if (H < 0) return 0;
  switch (C) {
    case 32: return smem_bytes<32>(H);
    case 64: return smem_bytes<64>(H);
    case 128: return smem_bytes<128>(H);
    default: return 0;
  }
}

// x, out: (B, N, C) f32; w_taps (n_taps, C_in, C_out) bf16; biases
// (n_convs, C) f32; desc (n_convs, 5) int32 (k, dilation, first tap,
// flags, chain halo); TN and smem as tile_rows and mrf_smem_bytes give
// them (the launch refuses others). Every pointer 16-byte aligned.
extern "C" int mrf_tc_forward(const float* x, const void* w_taps, const float* biases,
                              const int* desc, float* out, int B, int N, int C, int n_convs,
                              int H, int TN, int smem, float inv_nk, void* stream_handle) {
  return launch_c<SHIPPED>(x, w_taps, biases, desc, out, B, N, C, n_convs, H, TN, smem, inv_nk,
                           static_cast<cudaStream_t>(stream_handle));
}

// mrf_tc_forward's variant 0 (SHIPPED), 1 (ONE_ACCUMULATOR) or 2
// (WEIGHTS_FROM_L2: w_taps (n_taps, C_out, C_in)), for timing them side by
// side.
extern "C" int mrf_tc_forward_variant(const float* x, const void* w_taps, const float* biases,
                                      const int* desc, float* out, int B, int N, int C,
                                      int n_convs, int H, int TN, int smem, float inv_nk,
                                      int variant, void* stream_handle) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  switch (variant) {
    case SHIPPED:
      return launch_c<SHIPPED>(x, w_taps, biases, desc, out, B, N, C, n_convs, H, TN, smem,
                               inv_nk, st);
    case ONE_ACCUMULATOR:
      return launch_c<ONE_ACCUMULATOR>(x, w_taps, biases, desc, out, B, N, C, n_convs, H, TN,
                                       smem, inv_nk, st);
    case WEIGHTS_FROM_L2:
      return launch_c<WEIGHTS_FROM_L2>(x, w_taps, biases, desc, out, B, N, C, n_convs, H, TN,
                                       smem, inv_nk, st);
    default:
      return cudaErrorInvalidValue;
  }
}
