// Fused multi-receptive-field (MRF) vocoder stage for Hopper, sm_90a:
// K5's CUDA-core instance, for the stages of C = 8 and 16 channels; C =
// 32, 64 and 128 (every V1 stage) take the tensor-core instance in
// mrf_vocoder_tc.cu.
//
// Replaces the Pallas TPU kernel daft_exprt_tpu/ops/mrf_vocoder.py
// _make_kernel (K5). One HiFi-GAN upsample stage with input x (B, N, C)
// runs nk resblock chains and averages them; per chain and dilation unit
//
//   x <- x + mask(conv2(rnd(leaky(mask(conv1_d(rnd(leaky(x))) + b1)))) + b2)
//
// (ResBlock1; ResBlock2 has conv1 only), where rnd() rounds to bfloat16,
// the weights are bfloat16, products accumulate in f32, the f32 bias is
// added after the tap sum, mask() zeroes conv outputs at global positions
// outside [0, N) (per-conv SAME zero padding), and the carries are f32.
// out = (chain_0 + chain_1 + ...) * (1 / nk).
//
// What bounds it on this card: the FLOPs, 2 C^2 per sample for each tap
// of the fan (126 for V1's kernels 3/7/11 and dilations 1/3/5) against 8 C
// bytes of compulsory traffic per sample (x in, out, f32): 31.5 C FLOP per
// byte, 252 at C=8, right of the CUDA cores' ~20 FLOP per byte ridge
// (67 TFLOP/s float32 at 3.35 TB/s). What the design does about it: it
// keeps the bytes compulsory, so the FLOPs are all that is left. One
// block owns one batch row's tile of TN = 8192 / C output samples. It
// reads the tile and the widest chain's halo (60 samples a side for V1)
// straight from device
// memory, once per chain, and keeps every inter-conv activation of the
// chain in shared memory: the f32 carry X, the bf16 operand A =
// rnd(leaky(X)), and the bf16 operand A2 that conv1 hands to conv2. The
// chains' sum over the tile stays in shared memory too, so the 18
// inter-conv activations of a V1 stage never reach device memory. Each
// conv's region shrinks by its padding, so a chain computes only the rows
// its later convs read. Each tap's weights are streamed from L2 through
// the read-only cache as the products need them. The products run on
// CUDA-core FMAs (each thread 8 rows x 4 output channels, two input
// channels per step): at C = 8 and 16 an m16n8k16 tile would be mostly
// padding.
//
// The tap program comes at run time: per conv (kernel size, dilation,
// first tap in w_taps, flags, chain halo). w_taps is (n_taps, C_in,
// C_out) bf16, biases (n_convs, C) f32. One launch per stage on the
// caller's stream, grid (ceil(N / TN), B), 256 threads, no allocation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int OC = 4;     // output channels per thread
constexpr int RT = 8;     // consecutive rows per thread in one pass
constexpr int SLACK = 8;  // rows past the region a last row group may read
constexpr float SLOPE = 0.1f;

// flags of a conv's descriptor (ops/mrf_vocoder.py)
constexpr int CHAIN_START = 1, SECOND_CONV = 2, TO_CARRY = 4, CHAIN_END = 8,
              FIRST_CHAIN = 16;

__device__ __forceinline__ float leaky(float v) {
  return v >= 0.f ? v : v * SLOPE;
}

__device__ __forceinline__ void unpack4(uint2 raw, float* w) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  w[0] = lo.x;
  w[1] = lo.y;
  w[2] = hi.x;
  w[3] = hi.y;
}

__device__ __forceinline__ void store_rnd_leaky4(__nv_bfloat16* dst,
                                                 float4 v) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  d2[0] = __floats2bfloat162_rn(leaky(v.x), leaky(v.y));
  d2[1] = __floats2bfloat162_rn(leaky(v.z), leaky(v.w));
}

// X rows [lo, hi) <- x at global rows g0 + r (zero outside [0, N)),
// A rows [lo, hi) <- rnd(leaky(X)).
template <int C>
__device__ void load_input(const float* __restrict__ xb, float* X,
                           __nv_bfloat16* A, int lo, int hi, int g0, int N) {
  constexpr int C4 = C / 4;
  const int n = (hi - lo) * C4;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int r = lo + idx / C4;
    const int c = (idx % C4) * 4;
    const int g = g0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g >= 0 && g < N)
      v = __ldg(reinterpret_cast<const float4*>(xb + (size_t)g * C + c));
    *reinterpret_cast<float4*>(X + r * C + c) = v;
    store_rnd_leaky4(A + r * C + c, v);
  }
}

// A rows [lo, hi) <- rnd(leaky(X)).
template <int C>
__device__ void refresh_operand(const float* X, __nv_bfloat16* A, int lo,
                                int hi) {
  constexpr int C4 = C / 4;
  const int n = (hi - lo) * C4;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int off = (lo + idx / C4) * C + (idx % C4) * 4;
    store_rnd_leaky4(A + off, *reinterpret_cast<const float4*>(X + off));
  }
}

// One conv over output rows [olo, ohi): y = mask(sum_tap src[r - pad +
// tap d] @ w[tap] + bias). to_carry: X[r] += y; else A2[r] = rnd(leaky(y)).
template <int C>
__device__ void conv_pass(const __nv_bfloat16* src,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias, int k, int d,
                          int olo, int ohi, int g0, int N, bool to_carry,
                          float* X, __nv_bfloat16* A2) {
  constexpr int NOG = C / OC;          // output-channel groups
  constexpr int NRG = THREADS / NOG;   // row groups
  constexpr int PASS = NRG * RT;       // rows per pass of the block
  const int o0 = (threadIdx.x % NOG) * OC;
  const int rg = threadIdx.x / NOG;
  const int pad = (k - 1) * d / 2;
  float bv[OC];
#pragma unroll
  for (int o = 0; o < OC; ++o) bv[o] = __ldg(bias + o0 + o);

  for (int base = olo; base < ohi; base += PASS) {
    const int r0 = base + rg * RT;
    if (r0 >= ohi) continue;
    float acc[RT][OC];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int o = 0; o < OC; ++o) acc[i][o] = 0.f;

    for (int tap = 0; tap < k; ++tap) {
      const __nv_bfloat16* a = src + (r0 - pad + tap * d) * C;
      const __nv_bfloat16* wt = w + (size_t)tap * C * C + o0;
#pragma unroll 4
      for (int c = 0; c < C; c += 2) {
        float w0[OC], w1[OC];
        unpack4(__ldg(reinterpret_cast<const uint2*>(wt + c * C)), w0);
        unpack4(__ldg(reinterpret_cast<const uint2*>(wt + (c + 1) * C)), w1);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float2 av = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(a + i * C + c));
#pragma unroll
          for (int o = 0; o < OC; ++o) {
            acc[i][o] = fmaf(av.x, w0[o], acc[i][o]);
            acc[i][o] = fmaf(av.y, w1[o], acc[i][o]);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + i;
      if (r >= ohi) break;
      const int g = g0 + r;
      const bool valid = g >= 0 && g < N;
      float4 y;
      y.x = valid ? acc[i][0] + bv[0] : 0.f;
      y.y = valid ? acc[i][1] + bv[1] : 0.f;
      y.z = valid ? acc[i][2] + bv[2] : 0.f;
      y.w = valid ? acc[i][3] + bv[3] : 0.f;
      if (to_carry) {
        float4* xr = reinterpret_cast<float4*>(X + r * C + o0);
        float4 v = *xr;
        v.x += y.x;
        v.y += y.y;
        v.z += y.z;
        v.w += y.w;
        *xr = v;
      } else {
        store_rnd_leaky4(A2 + r * C + o0, y);
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS)
mrf_kernel(const float* __restrict__ x,
           const __nv_bfloat16* __restrict__ w_taps,
           const float* __restrict__ biases, const int* __restrict__ desc,
           float* __restrict__ out, int N, int n_convs, int H, int TN,
           float inv_nk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = TN + 2 * H;
  float* X = reinterpret_cast<float*>(smem);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(X + R * C);
  __nv_bfloat16* A2 = A + (R + SLACK) * C;
  float* ACC = reinterpret_cast<float*>(A2 + (R + SLACK) * C);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TN;
  const int g0 = t0 - H;  // global row of local row 0
  const float* xb = x + (size_t)b * N * C;
  constexpr int C4 = C / 4;

  int lo = 0, hi = 0;
  for (int ci = 0; ci < n_convs; ++ci) {
    const int k = __ldg(desc + 5 * ci);
    const int d = __ldg(desc + 5 * ci + 1);
    const int tap0 = __ldg(desc + 5 * ci + 2);
    const int flags = __ldg(desc + 5 * ci + 3);
    if (flags & CHAIN_START) {
      const int reach = __ldg(desc + 5 * ci + 4);
      lo = H - reach;
      hi = H + TN + reach;
      load_input<C>(xb, X, A, lo, hi, g0, N);
      __syncthreads();
    }
    const int pad = (k - 1) * d / 2;
    conv_pass<C>((flags & SECOND_CONV) ? A2 : A,
                 w_taps + (size_t)tap0 * C * C, biases + ci * C, k, d,
                 lo + pad, hi - pad, g0, N, (flags & TO_CARRY) != 0, X, A2);
    __syncthreads();
    lo += pad;
    hi -= pad;
    if (flags & CHAIN_END) {
      // the carry now covers exactly the tile, local rows [H, H + TN)
      const bool first = (flags & FIRST_CHAIN) != 0;
      for (int idx = threadIdx.x; idx < TN * C4; idx += THREADS) {
        const int off = (idx / C4) * C + (idx % C4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(X + H * C + off);
        float4* accp = reinterpret_cast<float4*>(ACC + off);
        if (first) {
          *accp = v;
        } else {
          float4 s = *accp;
          s.x += v.x;
          s.y += v.y;
          s.z += v.z;
          s.w += v.w;
          *accp = s;
        }
      }
      __syncthreads();
    } else if (flags & TO_CARRY) {
      refresh_operand<C>(X, A, lo, hi);
      __syncthreads();
    }
  }

  float* ob = out + (size_t)b * N * C;
  for (int idx = threadIdx.x; idx < TN * C4; idx += THREADS) {
    const int t = idx / C4;
    if (t0 + t >= N) continue;
    const int c = (idx % C4) * 4;
    float4 s = *reinterpret_cast<const float4*>(ACC + t * C + c);
    s.x *= inv_nk;
    s.y *= inv_nk;
    s.z *= inv_nk;
    s.w *= inv_nk;
    *reinterpret_cast<float4*>(ob + (size_t)(t0 + t) * C + c) = s;
  }
}

template <int C>
int launch(const float* x, const void* w_taps, const float* biases,
           const int* desc, float* out, int B, int N, int n_convs, int H,
           int TN, int smem, float inv_nk, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mrf_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mrf_kernel<C><<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(w_taps), biases, desc, out, N,
      n_convs, H, TN, inv_nk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mrf_forward(const float* x, const void* w_taps,
                           const float* biases, const int* desc, float* out,
                           int B, int N, int C, int n_convs, int H, int TN,
                           int smem, float inv_nk, void* stream_handle) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (TN != 8192 / C || H < 0 || n_convs <= 0) return cudaErrorInvalidValue;
  switch (C) {
    case 8:
      return launch<8>(x, w_taps, biases, desc, out, B, N, n_convs, H, TN,
                       smem, inv_nk, stream);
    case 16:
      return launch<16>(x, w_taps, biases, desc, out, B, N, n_convs, H, TN,
                        smem, inv_nk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
