// Fused multi-receptive-field (MRF) vocoder stage (K5), tensor-core
// instance, for Hopper, sm_90a: wgmma products, weights fed by the TMA
// unit, a producer warpgroup beside two consumer warpgroups.
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
// bytes of compulsory traffic per sample, ~8,000 FLOP per byte. In this
// design the products themselves are bound by shared memory: every wgmma
// reads its m64 x k16 operand (2 KB) and N x k16 of weights from shared
// memory, 8 KB per 262 kFLOP at C = 128 (two warpgroups of N = 64), 4 KB
// per 131 kFLOP at C = 64, 3 KB per 65 kFLOP at C = 32: at the tensor
// cores' rate that is 128, 128 and 192 bytes a clock, against the SM's
// 128.
//
// Design. One block owns one batch row's tile of TN output samples and
// keeps every inter-conv activation of the fan in shared memory over the
// tile and the widest chain's halo (R = TN + 2H rows): the f32 carry X
// (rows of C floats, 8-float groups XOR-swizzled by row so that the
// epilogue's and the loads' accesses are conflict-free) and one bf16
// operand A. Every conv is a shifted-row GEMM on wgmma (m64 x N x k16,
// bf16 -> f32): tap i of an m64 tile of output rows from r reads operand
// rows r - pad + i d. A is stored as [C / 8][RS][8] bf16 (8 channels of
// a row are 16 bytes, RS = R rounded up to 1 mod 8 rows a channel group),
// which is the no-swizzle K-major layout of a wgmma operand: a shift of
// one row moves the descriptor's start address by 16 bytes, so the
// dilated shift costs nothing and A never leaves shared memory. The last
// m64 tile of a region reads up to 63 rows past it (into the next channel
// group, past A's end into X): those rows' products are discarded.
//
// Weights: build_mrf_program packs each tap as [C_in / 8][C_out][8] bf16,
// the K-major no-swizzle image of the B operand, so a ring stage (32 input
// channels of one tap, 64 C bytes) is one contiguous bulk copy
// (cp.async.bulk with an L2 evict-last hint: every block streams the same
// taps) and needs no tensor map. One thread of the producer warpgroup
// keeps STAGES copies in flight through full/empty mbarriers across the
// whole fan; the consumer warps never wait on a block-wide barrier for
// weights. The producer warpgroup gives its registers to the consumers
// (setmaxnreg 40 / 232 a thread from the launch's 168: ptxas budgets a
// wgmma kernel by whole warpgroups, and at 168 the consumers' 192 sums
// and partials spilled).
//
// Consumers: warpgroup w takes, at C = 128, every m64 tile of a conv at
// output columns [64 w, 64 w + 64); at C = 64 and 32, every other m64
// tile at all C columns. Each thread holds 128 f32 sums (MT tiles of the
// m64 x N accumulator). A chunk's products (two ring stages, k64, at C =
// 128 and 64; one, a tap's k32, at C = 32) go into a fresh partial
// accumulator that is then added into the sums with a rounded f32 add; NP
// partials rotate so that one tile's products run while another's are
// added. With one accumulator over all of a conv's products (no adds) the
// kernel ends about as far from exact sums as plain does, on wgmma as on
// mma.sync; with the partials it stays well inside plain's distance
// (chip_smoke.py's mrf_exact check at each V1 stage). A conv's region
// [lo + pad, hi - pad) shrinks
// with the chain's remaining halo; only its m64 tiles are computed (the
// tile count picks a fully unrolled instance: no product is issued on a
// branch of its own, and none is in flight across a loop's back edge).
// After a conv's products the consumers meet on a named barrier, the
// epilogue overwrites A in place (conv1: rnd(leaky(mask(acc + b1))); conv2:
// X += mask(acc + b2), then the next unit's rnd(leaky(X))), a row of a
// thread at a time with its loads issued before its stores, and they meet
// again after the async-proxy fence. A chain's last epilogue adds the
// tile into the block's own rows of out, in chain order.
//
// The tile: the largest TN (a multiple of 64) whose R rows fit shared
// memory beside the ring and the warpgroups' sums (plan_mrf in
// ops/mrf_vocoder.py mirrors tile_rows and mrf_smem_bytes): TN = 128 /
// 384 / 896 at C = 128 / 64 / 32 for V1's halo of 60.
//
// One launch per stage on the caller's stream, grid (ceil(N / TN), B),
// 384 threads, no allocation, no atomics: the output is bit-identical
// from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "smem_limit.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// registers a thread: the launch's (65536 / THREADS), the producer's and
// the consumers' after setmaxnreg (the pool stays 65536 - 1024)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int LAUNCH_REGS = 168;
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS == LAUNCH_REGS * THREADS,
              "setmaxnreg keeps the block's register pool");
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory of one block (H100)
constexpr int SYNC = 1;                  // the consumers' named barrier
constexpr float SLOPE = 0.1f;

// descriptor flags (ops/mrf_vocoder.py)
constexpr int CHAIN_START = 1, TO_CARRY = 4, CHAIN_END = 8, FIRST_CHAIN = 16;

template <int C>
struct Shape {
  static constexpr bool SPLIT_N = C == 128;  // warpgroups split the columns
  static constexpr int WN = SPLIT_N ? C / 2 : C;  // a warpgroup's columns (wgmma N)
  static constexpr int ACC = WN / 2;              // sums a thread per m64 tile
  static constexpr int MT = 128 / ACC;            // m64 tiles a warpgroup holds
  static constexpr int TILES = SPLIT_N ? MT : 2 * MT;  // m64 tiles a block holds
  static constexpr int NP = C == 32 ? 4 : 2;      // partial accumulators
  static constexpr int CHUNK = C == 32 ? 1 : 2;   // ring stages a partial sum spans
  static constexpr int SLICE = 32 * C;            // bytes of a k16 slice of a tap
  static constexpr int STAGE = 2 * SLICE;         // a ring stage: k32
  static constexpr int STAGES = C == 128 ? 5 : 8;
  static constexpr int M_STEP = SPLIT_N ? 64 : 128;  // rows between a warpgroup's tiles
};

// Rows of one channel group of A: R rounded up to 1 mod 8 (the loads'
// 8-byte stores of 8 channel groups then fall in distinct banks).
__host__ __device__ constexpr int group_rows(int R) { return R + ((9 - R % 8) % 8); }

template <int C>
constexpr int smem_for(int R) {
  using S = Shape<C>;
  return S::STAGES * S::STAGE + 2 * C * group_rows(R) + 4 * C * R + 16 * S::STAGES;
}

template <int C>
int tile_rows(int H) {
  if (H < 0) return 0;
  int R = Shape<C>::TILES * 64;
  while (R > 0 && smem_for<C>(R) > SMEM_LIMIT) --R;
  const int tn = (R - 2 * H) / 64 * 64;
  return tn >= 64 ? tn : 0;
}

template <int C>
int smem_bytes(int H) {
  const int tn = tile_rows<C>(H);
  return tn ? smem_for<C>(tn + 2 * H) : 0;
}

// max(v, 0.1 v) is v for v >= 0 and 0.1 v below: leaky_relu, in two
// instructions
__device__ __forceinline__ float leaky(float v) { return fmaxf(v, v * SLOPE); }

// Word of the carry X at row r, column c (C floats a row; the 8-float
// groups XOR-swizzled by r mod 4).
template <int C>
__device__ __forceinline__ int x_at(int r, int c) {
  return r * C + (c ^ ((r & 3) << 3));
}

// One chunk's products for this warpgroup's NT m64 tiles: the CHUNK ring
// stages from b[0] (two k16 slices each) of tile j into partial p[j % NP]
// (the first replacing it), then, once at most NP - 1 tiles' products are
// in flight, the oldest partial added into its sums. ``a``: the first
// tile's operand descriptor at the chunk's first slice; ``b``: the
// stages' weights at this warpgroup's columns. Straight-line code: every
// product has completed on return.
template <int C, int NT>
__device__ __forceinline__ void chunk_products(float (&acc)[Shape<C>::MT][Shape<C>::ACC],
                                               uint64_t a, const uint64_t (&b)[Shape<C>::CHUNK],
                                               int rs) {
  using S = Shape<C>;
  float p[S::NP][S::ACC];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float(&pj)[S::ACC] = p[j % S::NP];
    const uint64_t aj = a + (uint64_t)(j * S::M_STEP);
    wg_fence();
#pragma unroll
    for (int st = 0; st < S::CHUNK; ++st) {
      const uint64_t as = aj + (uint64_t)(4 * st * rs);
      wgmma_ss<S::WN>(pj, as, b[st], st);
      wgmma_ss<S::WN>(pj, as + (uint64_t)(2 * rs), b[st] + (uint64_t)(S::SLICE >> 4), 1);
    }
    wg_commit();
    if (j >= S::NP - 1) {
      const int done = j - (S::NP - 1);
      wg_wait<S::NP - 1>();
      float(&pd)[S::ACC] = p[done % S::NP];
      hold(pd);
#pragma unroll
      for (int e = 0; e < S::ACC; ++e) acc[done][e] += pd[e];
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int j = NT - S::NP + 1 < 0 ? 0 : NT - S::NP + 1; j < NT; ++j) {
    float(&pd)[S::ACC] = p[j % S::NP];
    hold(pd);
#pragma unroll
    for (int e = 0; e < S::ACC; ++e) acc[j][e] += pd[e];
  }
}

template <int C>
__device__ __forceinline__ void products(float (&acc)[Shape<C>::MT][Shape<C>::ACC], int nt,
                                         uint64_t a, const uint64_t (&b)[Shape<C>::CHUNK],
                                         int rs) {
  switch (nt) {
#define MRF_TILES(n)                            \
  case n:                                       \
    if constexpr (n <= Shape<C>::MT)            \
      chunk_products<C, n>(acc, a, b, rs);      \
    break;
    MRF_TILES(1)
    MRF_TILES(2)
    MRF_TILES(3)
    MRF_TILES(4)
    MRF_TILES(5)
    MRF_TILES(6)
    MRF_TILES(7)
    MRF_TILES(8)
#undef MRF_TILES
    default:
      break;
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
mrf_wgmma_kernel(const float* __restrict__ x, const bf16* __restrict__ w_taps,
                 const float* __restrict__ biases, const int* __restrict__ desc_rows,
                 float* __restrict__ out, int N, int n_convs, int H, int TN, float inv_nk) {
  using S = Shape<C>;
  constexpr int MT = S::MT, ACC = S::ACC, WN = S::WN;
  extern __shared__ __align__(128) unsigned char smem[];
  const int R = TN + 2 * H, rs = group_rows(R);
  const uint32_t ring = saddr(smem);
  const uint32_t a_s = ring + S::STAGES * S::STAGE;
  bf16* A = reinterpret_cast<bf16*>(smem + S::STAGES * S::STAGE);
  float* X = reinterpret_cast<float*>(smem + S::STAGES * S::STAGE + 2 * C * rs);
  const uint32_t bars = saddr(X + R * C);  // full[STAGES], then empty[STAGES]
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (S::STAGES + s), CONSUMERS / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // the producer: every tap of the fan, in order
    regs_dealloc<PRODUCER_REGS>();
    if (tid == CONSUMERS) {
      const int last = 5 * (n_convs - 1);
      const int stages = (__ldg(desc_rows + last + 2) + __ldg(desc_rows + last)) * (C / 32);
      const unsigned char* w = reinterpret_cast<const unsigned char*>(w_taps);
      for (int q = 0; q < stages; ++q) {
        const int s = q % S::STAGES;
        if (q >= S::STAGES) mbar_wait(bars + 8 * (S::STAGES + s), ((q / S::STAGES) - 1) & 1);
        mbar_expect_tx(bars + 8 * s, S::STAGE);
        bulk_load(ring + s * S::STAGE, w + (size_t)q * S::STAGE, S::STAGE, bars + 8 * s,
                  EVICT_LAST);
      }
    }
    return;
  }
  regs_alloc<CONSUMER_REGS>();

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n0 = S::SPLIT_N ? wg * WN : 0;
  const int b = blockIdx.y, t0 = blockIdx.x * TN, g0 = t0 - H;
  const float* xb = x + (size_t)b * N * C;
  float* ob = out + (size_t)b * N * C;
  // no-swizzle K-major operands: 8-row core matrices 128 bytes apart; the
  // next 8 channels RS rows (A) or C_out rows (weights) further
  const uint64_t a_desc = desc(a_s, rs * 16, 128, 0);
  const uint64_t b_desc = desc(ring + n0 * 16, C * 16, 128, 0);

  float acc[MT][ACC];
  int q = 0, lo = 0, hi = 0;
  for (int ci = 0; ci < n_convs; ++ci) {
    const int k = __ldg(desc_rows + 5 * ci), d = __ldg(desc_rows + 5 * ci + 1);
    const int flags = __ldg(desc_rows + 5 * ci + 3);
    if (flags & CHAIN_START) {
      // X rows [lo, hi) <- x (zero outside [0, N)), A <- rnd(leaky(X))
      const int reach = __ldg(desc_rows + 5 * ci + 4);
      lo = H - reach;
      hi = H + TN + reach;
      constexpr int Q = C / 4, U = 8;
      const int n = (hi - lo) * Q;
      for (int i0 = tid; i0 < n; i0 += CONSUMERS * U) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * CONSUMERS, r = lo + i / Q, c = (i % Q) * 4, g = g0 + r;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (i < n && g >= 0 && g < N)
            v[u] = __ldg(reinterpret_cast<const float4*>(xb + (size_t)g * C + c));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * CONSUMERS, r = lo + i / Q, c = (i % Q) * 4;
          if (i >= n) continue;
          *reinterpret_cast<float4*>(X + x_at<C>(r, c)) = v[u];
          uint2 p;
          p.x = pack(leaky(v[u].x), leaky(v[u].y));
          p.y = pack(leaky(v[u].z), leaky(v[u].w));
          *reinterpret_cast<uint2*>(A + ((c >> 3) * rs + r) * 8 + (c & 7)) = p;
        }
      }
      fence_proxy_async();
      named_sync(SYNC, CONSUMERS);
    }
    const int pad = (k - 1) * d / 2, olo = lo + pad, ohi = hi - pad;
    const int nt = (ohi - olo + 63) / 64;
    const int mine = S::SPLIT_N ? nt : (nt - wg + 1) / 2;
    const int first_row = olo + (S::SPLIT_N ? 0 : 64 * wg);

#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[j][e] = 0.f;

    for (int i = 0; i < k; ++i) {
      const int row = first_row + i * d - pad;
      for (int kc = 0; kc < C / 32; kc += S::CHUNK, q += S::CHUNK) {
        uint64_t bd[S::CHUNK];
#pragma unroll
        for (int st = 0; st < S::CHUNK; ++st) {
          const int s = (q + st) % S::STAGES;
          mbar_wait(bars + 8 * s, ((q + st) / S::STAGES) & 1);
          bd[st] = b_desc + (uint64_t)((s * S::STAGE) >> 4);
        }
        products<C>(acc, mine, a_desc + (uint64_t)(4 * kc * rs + row), bd, rs);
        __syncwarp();
        if (lane == 0)
#pragma unroll
          for (int st = 0; st < S::CHUNK; ++st)
            mbar_arrive(bars + 8 * (S::STAGES + (q + st) % S::STAGES));
      }
    }
    const float* bias = biases + ci * C;
    float2 bv[WN / 8];
#pragma unroll
    for (int jn = 0; jn < WN / 8; ++jn)
      bv[jn] = __ldg(reinterpret_cast<const float2*>(bias + n0 + 8 * jn + 2 * (lane & 3)));
    named_sync(SYNC, CONSUMERS);  // every product has read A: overwrite it
    const bool to_carry = flags & TO_CARRY, end = flags & CHAIN_END;
    const bool first = flags & FIRST_CHAIN, last = ci == n_convs - 1;
    // a row of this thread at a time: its loads (the carry, and at a chain
    // end the sum of the earlier chains) all issued before its stores
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      if (j >= mine) continue;
      const int m = S::SPLIT_N ? j : 2 * j + wg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = olo + 64 * m + 16 * warp + (lane >> 2) + 8 * h;
        if (r >= ohi) continue;
        const int g = g0 + r;
        const bool valid = g >= 0 && g < N;
        uint32_t* a_row = reinterpret_cast<uint32_t*>(A + r * 8 + 2 * (lane & 3));
        float2* x_row = reinterpret_cast<float2*>(X + r * C);
        float2* o_row = reinterpret_cast<float2*>(ob + (size_t)g * C + n0 + 2 * (lane & 3));
        const int swz = (r & 3) << 3;
        float2 y[WN / 8];
#pragma unroll
        for (int jn = 0; jn < WN / 8; ++jn) {
          y[jn].x = valid ? acc[j][4 * jn + 2 * h] + bv[jn].x : 0.f;
          y[jn].y = valid ? acc[j][4 * jn + 2 * h + 1] + bv[jn].y : 0.f;
        }
        if (!to_carry) {
#pragma unroll
          for (int jn = 0; jn < WN / 8; ++jn)
            a_row[(n0 / 8 + jn) * rs * 4] = pack(leaky(y[jn].x), leaky(y[jn].y));
          continue;
        }
        float2 v[WN / 8];
#pragma unroll
        for (int jn = 0; jn < WN / 8; ++jn)
          v[jn] = x_row[((n0 + 8 * jn + 2 * (lane & 3)) ^ swz) / 2];
        if (!end) {
#pragma unroll
          for (int jn = 0; jn < WN / 8; ++jn) {
            v[jn].x += y[jn].x;
            v[jn].y += y[jn].y;
            x_row[((n0 + 8 * jn + 2 * (lane & 3)) ^ swz) / 2] = v[jn];
            a_row[(n0 / 8 + jn) * rs * 4] = pack(leaky(v[jn].x), leaky(v[jn].y));
          }
          continue;
        }
        if (!valid) continue;  // the tile's row r - H: add the chain into out
        float2 prev[WN / 8];
        if (!first) {
#pragma unroll
          for (int jn = 0; jn < WN / 8; ++jn) prev[jn] = o_row[4 * jn];
        }
#pragma unroll
        for (int jn = 0; jn < WN / 8; ++jn) {
          float2 s = make_float2(v[jn].x + y[jn].x, v[jn].y + y[jn].y);
          if (!first) {
            s.x = prev[jn].x + s.x;
            s.y = prev[jn].y + s.y;
          }
          if (last) {
            s.x *= inv_nk;
            s.y *= inv_nk;
          }
          o_row[4 * jn] = s;
        }
      }
    }
    fence_proxy_async();
    named_sync(SYNC, CONSUMERS);
    lo = olo;
    hi = ohi;
  }
}

template <int C>
int launch(const float* x, const void* w_taps, const float* biases, const int* desc_rows,
           float* out, int B, int N, int n_convs, int H, int TN, int smem, float inv_nk,
           cudaStream_t stream) {
  static smem_limit::Record record;
  // setmaxnreg's pool holds only at the launch's 168 registers a thread: a
  // build that gave the kernel another count would wait forever for them
  static const int regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, mrf_wgmma_kernel<C>) == cudaSuccess ? attr.numRegs : -1;
  }();
  if (regs != LAUNCH_REGS) return cudaErrorInvalidConfiguration;
  if (TN != tile_rows<C>(H) || smem != smem_bytes<C>(H) || TN == 0) return cudaErrorInvalidValue;
  cudaError_t err = smem_limit::allow(mrf_wgmma_kernel<C>, smem, record);
  if (err != cudaSuccess) return err;
  mrf_wgmma_kernel<C><<<dim3((N + TN - 1) / TN, B), THREADS, smem, stream>>>(
      x, static_cast<const bf16*>(w_taps), biases, desc_rows, out, N, n_convs, H, TN, inv_nk);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block at width C and halo H (0: not taken):
// what plan_mrf mirrors.
extern "C" int mrf_smem_bytes(int C, int H) {
  switch (C) {
    case 32: return smem_bytes<32>(H);
    case 64: return smem_bytes<64>(H);
    case 128: return smem_bytes<128>(H);
    default: return 0;
  }
}

// x, out: (B, N, C) f32; w_taps (n_taps, C / 8, C_out, 8) bf16 (tap t's
// [g][n][e] = weight[n][8 g + e][t]); biases (n_convs, C) f32; desc
// (n_convs, 5) int32 (k, dilation, first tap, flags, chain halo); TN and
// smem as tile_rows and mrf_smem_bytes give them (the launch refuses
// others). Every pointer 16-byte aligned.
extern "C" int mrf_tc_forward(const float* x, const void* w_taps, const float* biases,
                              const int* desc_rows, float* out, int B, int N, int C,
                              int n_convs, int H, int TN, int smem, float inv_nk,
                              void* stream_handle) {
  if (H < 0 || n_convs <= 0 || B <= 0 || N <= 0) return cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (C) {
    case 32:
      return launch<32>(x, w_taps, biases, desc_rows, out, B, N, n_convs, H, TN, smem, inv_nk,
                        stream);
    case 64:
      return launch<64>(x, w_taps, biases, desc_rows, out, B, N, n_convs, H, TN, smem, inv_nk,
                        stream);
    case 128:
      return launch<128>(x, w_taps, biases, desc_rows, out, B, N, n_convs, H, TN, smem, inv_nk,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}

