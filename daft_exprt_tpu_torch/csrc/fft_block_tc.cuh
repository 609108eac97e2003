// Fused FFT block forward (inference), tensor-core instance, for Hopper,
// sm_90a: wgmma products, weights and key/value tiles fed by the TMA unit
// (bulk copies) from a producer warpgroup beside two consumer warpgroups,
// three launches chained by programmatic dependent launch.
//
// Replaces the Pallas TPU kernel daft_exprt_tpu/ops/fft_block.py:_kernel
// (K1) on the bf16 serving and evaluation path; float32 dots (and
// chip_smoke's control, the rounding off) keep the CUDA-core instance,
// fft_block.cu, whose header states the function. Widths E = 128, 256 or
// 512, head dims D = E / H in {16, 64, 128}, any conv channels C % 128 ==
// 0, any T >= 1, valid lengths per row clamped to [0, T].
//
// What bounds it on this card: operations. At the frame decoder's shape
// (B=8, T=512, E=128, C=1024) the block does ~8 GFLOP, 6.4 of them in the
// two convs, against ~5 MB of compulsory traffic: ~8 us at the bf16
// tensor-core peak against ~1.5 us of HBM time.
//
// Design. Every product is a wgmma m64nNk16 (bf16 -> f32) with its
// operands bf16 at the Pallas kernel's rounding points, both in shared
// memory in the no-swizzle K-major layout ([K / 8][rows][8] bf16, 8-row
// core matrices 128 bytes apart), or the probabilities from registers.
// The dot weights arrive as images of that layout made once a weight
// version (ops/fft_block.py pack_images): each 64 x 64 block of a (K, N)
// matrix 8 KB of [8][64][8], the blocks of a 64-column slice consecutive
// over K, so every ring stage is one bulk copy (cp.async.bulk, L2
// evict-last) issued by one producer thread into an mbarrier ring. A sum
// over K takes each k64 chunk's four k16 products into a fresh partial
// accumulator and adds it into the f32 sums (two partials in flight, one
// added while the other's products run): sums chained inside the tensor
// cores over a long K end further from exact sums than plain's (1.29x
// plain's distance at E=512 on an H100, against k64 partials' 0.71x;
// chip_smoke.py's k1_sums). Three launches, each keeping its
// intermediates on chip:
//
//   1. qkv_wgmma_kernel   q | k | v = rnd(rnd(x) Wqkv + bqkv), written as the
//      attention's operand images (q and k [D/8][64][8] a 64-row tile and
//      head, v transposed [8][D][8]) over T rounded up to 64 rows; rows
//      past T come from zero rows of x, so every tile is finite.
//   2. attn_wgmma_kernel  for 64 query rows with all heads: P = rnd(softmax
//      over keys below the length of q k^T / sqrt D), ctx = rnd(P v) into
//      shared memory, a = mask(LN1(ctx Wo + bo + x)) in the epilogue:
//      a (B, T, E) f32 and rnd(a) as conv1's operand image [B][E/8][T][8].
//   3. conv_wgmma_kernel  for 62 (E >= 256) or 126 (E = 128) output rows:
//      h = rnd(relu(conv1(rnd a) + b1)) over their 64 or 128 hidden rows
//      (zero outside [0, T)) into shared memory, then conv2, + b2 + a,
//      LN2, FiLM and the row mask. The k = 3 convs are shifted-row GEMMs:
//      a shift of one row moves a K-major descriptor's start by 16 bytes.
//
// What bounds the launches on the card is the weight and key/value
// stream, not the products: with the products taken out, launch 3 at the
// frame decoder took 36 of its 47 device us, and every ring ran at its
// bytes in flight over a ~2.5 us fetch. So every ring is as deep as the
// shared memory leaves (launches 1 and 3 up to 24 stages, launch 2 up to
// 12 a warpgroup), launch 3 splits C over a cluster of 4 blocks at E =
// 128 (a quarter of the hidden a block leaves 16 stages; 8 where the
// tiles are few) with conv2's partial sums added through distributed
// shared memory in rank order, and launch 2 splits the heads over a
// cluster of 2 blocks where the query tiles alone leave half the card
// idle (the other block's ctx columns gathered through distributed
// shared memory, the out-projection's columns and LN1's row sums split
// between them). Softmax exponentials are ex2.approx on logits pre-scaled
// into log2 units, as K2's.
//
// Launch 2's warpgroups take alternate heads (two passes over the key
// tiles: row max and sum, then P and PV, the previous tile's PV running on
// the tensor cores while this tile's probabilities are worked), then
// alternate 64-column blocks of the out-projection; LN1's row sums meet in
// shared memory. Launch 3's warpgroups take one m64 tile each at E = 128
// (sharing every weight stage), alternate hidden blocks and then halves
// of conv2's columns above. The producer warpgroup gives its registers to
// the consumers (setmaxnreg 40 / 232 from the launch's 168) in launches 2
// and 3. Tiles at or past a row's length are not computed (their rows are
// written as zeros). Launch 1 may follow the kernel that wrote the images
// (pack_images, on a weight version's first call), so it reads them only
// after griddepcontrol.wait; launch 2 reads its key tiles, then Wo, after
// it. Launch 3 starts its weight stream before the wait: it starts only
// once launch 2 has passed its wait, so launch 1, and whatever wrote the
// images before it, has completed. Every launch signals its dependents
// after its products and writes nothing before the wait.
//
// Past the hidden that a cluster of 8 holds (C above 4096, 8192 and 6144
// at E = 128, 256 and 512), launch 3 runs once for each of a few equal
// chunks of the hidden's 64-channel blocks, in order: each adds conv2's
// sums over its chunk to the f32 partial of the chunks before it (a
// (B, T, E) workspace), and the last takes the epilogue. No allocation,
// no atomics: two runs give bit-identical output.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

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
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block (H100)
constexpr int BLOCK = 8192;         // a weight block: 64 K rows x 64 N columns, [8][64][8] bf16
constexpr int ROWS = 64;            // rows of an m64 tile
constexpr int SYNC = 1;             // the consumers' named barrier; 2 + w: warpgroup w's
constexpr int MAX_CLUSTER = 8;
constexpr int RING_MAX = 24;  // stages a ring takes at most
constexpr float LN_EPS = 1e-5f;
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int align1k(int n) { return (n + 1023) & ~1023; }

__device__ __forceinline__ int row_length(const int* lengths, int b, int T) {
  const int n = lengths[b];
  return n < 0 ? 0 : (n > T ? T : n);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A K-major no-swizzle operand at ``addr``: 8-row core matrices 128 bytes
// apart, the next 8 K columns ``lbo`` bytes further.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, uint32_t lbo) {
  return desc(addr, lbo, 128, 0);
}

// ------------------------------------------------------------------
// A ring of s stages of SB bytes: load q sits in stage q % s; its "full"
// barrier completes the (q / s)-th time when its bytes have landed, its
// "empty" barrier when the consumer warps have released it.
// ------------------------------------------------------------------
template <int SB>
struct Ring {
  uint32_t data;  // stage 0
  uint32_t bars;  // full[s], then empty[s]
  int s;
  __device__ uint32_t stage(int q) const { return data + (q % s) * SB; }
  __device__ uint32_t full(int q) const { return bars + 8 * (q % s); }
  __device__ uint32_t empty(int q) const { return bars + 8 * (s + q % s); }
  __device__ void init(int warps) const {
    for (int i = 0; i < s; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (s + i), warps);
    }
  }
  // The producer thread: ``bytes`` from ``src`` as load q, once the
  // stage's previous load has been released.
  __device__ void load(int q, const void* src, uint32_t bytes) const {
    if (q >= s) mbar_wait(empty(q), ((q / s) - 1) & 1);
    mbar_expect_tx(full(q), bytes);
    bulk_load(stage(q), src, bytes, full(q), EVICT_LAST);
  }
  __device__ void wait(int q) const { mbar_wait(full(q), (q / s) & 1); }
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(q));
  }
};

// ------------------------------------------------------------------
// One warpgroup's 64 x 64 block: acc = the sum over nk ring stages (from
// load q) of a(i) times the stage's weight block, a(i, kk) the K-major
// descriptor of chunk i's k16 step kk. KP k16 products go into a fresh
// partial accumulator that is then added into acc (KP = 4: k64 partials,
// the instance's choice); KP = 0 chains all of them inside the tensor
// cores. PAIRS: two partials in flight, one added while the other's
// products run; else one (the registers of a warpgroup that keeps four
// blocks' sums, which spilled with two). Every product has completed on
// return; q moves past the stages.
// ------------------------------------------------------------------
template <int KP, bool PAIRS = true, class R, class A>
__device__ __forceinline__ void block_products(float (&acc)[32], const R& ring, int& q, int nk,
                                               A a) {
  if constexpr (KP == 0) {
    for (int i = 0; i < nk; ++i) {
      ring.wait(q + i);
      const uint64_t b = kdesc(ring.stage(q + i), ROWS * 16);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64>(acc, a(i, kk), b + (uint64_t)(kk * 2 * ROWS), i > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
      hold(acc);
      ring.release(q + i);
    }
  } else {
    constexpr int G = 4 / KP;  // partial sums a stage
    const int n = nk * G;
    float p0[32], p1[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    auto issue = [&](float(&p)[32], int gi) {
      const int i = gi / G, part = gi % G;
      if (part == 0) ring.wait(q + i);
      const uint64_t b = kdesc(ring.stage(q + i), ROWS * 16);
      wg_fence();
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int kk = part * KP + k;
        wgmma_ss<64>(p, a(i, kk), b + (uint64_t)(kk * 2 * ROWS), k);
      }
      wg_commit();
    };
    auto add = [&](float(&p)[32], int gi) {
      hold(p);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += p[e];
      if (gi % G == G - 1) ring.release(q + gi / G);
    };
    // two partial sums in flight: the first is added while the second's
    // products run, and both have completed before the loop comes round
    // (a product in flight across it would make ptxas serialize them)
    int gi = 0;
    if constexpr (PAIRS) {
      for (; gi + 1 < n; gi += 2) {
        issue(p0, gi);
        issue(p1, gi + 1);
        wg_wait<1>();
        add(p0, gi);
        wg_wait<0>();
        add(p1, gi + 1);
      }
    }
    for (; gi < n; ++gi) {
      issue(p0, gi);
      wg_wait<0>();
      add(p0, gi);
    }
  }
  q += nk;
}

// ------------------------------------------------------------------
// 1. q | k | v = rnd(rnd(x) Wqkv + bqkv). Grid (ceil(tiles / 2), 3E / 64 /
//    ng): a block takes two m64 tiles (batch row, 64-row tile j) of the
//    tiles = B NT, one a warpgroup, and ng 64-column blocks, both
//    warpgroups reading each weight stage (one ring, one producer).
// ------------------------------------------------------------------
// launch 1's ring: as many stages as the shared memory leaves beside the
// two rows tiles, up to RING_MAX
template <int E>
__host__ __device__ constexpr int qkv_stages() {
  return (SMEM_LIMIT - 2 * ROWS * E * 2) / (BLOCK + 16) > RING_MAX
             ? RING_MAX
             : (SMEM_LIMIT - 2 * ROWS * E * 2) / (BLOCK + 16);
}
template <int E>
__host__ __device__ constexpr int qkv_smem() {
  return 2 * ROWS * E * 2 + qkv_stages<E>() * (BLOCK + 16);
}

template <int E, int KP>
__global__ void __launch_bounds__(THREADS, 1)
qkv_wgmma_kernel(const float* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, bf16* __restrict__ qkv, int T, int NT, int H,
                 int tiles, int ng) {
  constexpr int KB = E / 64, G8 = E / 8;
  constexpr int A_BYTES = 2 * ROWS * E * 2;  // [E/8][128][8]
  constexpr int S = qkv_stages<E>();
  using R = Ring<BLOCK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t a_s = saddr(smem);
  const R ring{a_s + A_BYTES, a_s + A_BYTES + S * BLOCK, S};
  const int tid = threadIdx.x, nb0 = blockIdx.y * ng;
  if (tid == 0) {
    ring.init(CONSUMERS / 32);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS) {
      // the launch before may be the one that wrote the images (pack_images
      // on a weight version's first call): read them after the wait
      pdl_wait();
      const char* src = reinterpret_cast<const char*>(w) + (size_t)nb0 * KB * BLOCK;
      for (int i = 0; i < ng * KB; ++i) ring.load(i, src + (size_t)i * BLOCK, BLOCK);
    }
    return;
  }
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int mt = 2 * blockIdx.x + wg;  // this warpgroup's m64 tile
  const bool live = mt < tiles;        // else its products run on zeros and are not stored
  const int b = live ? mt / NT : 0, j = live ? mt % NT : 0;
  pdl_wait();
  // rnd(x) of rows 64 j .. into operand rows 64 wg .. (zero past T): a
  // warp reads 8 rows x 4 float4 a step (64 bytes a row), a thread's U
  // loads issued before its stores
  constexpr int ITEMS = ROWS * E / 4 / 128, U = ITEMS < 16 ? ITEMS : 16;  // float4 a thread
  for (int u0 = 0; u0 < ITEMS; u0 += U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = (tid & 127) + 128 * (u0 + u), rest = i / 32;
      const int r = i % 8 + 8 * (rest % 8), c4 = (i / 8) % 4 + 4 * (rest / 8), row = ROWS * j + r;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && row < T)
        v[u] = __ldg(reinterpret_cast<const float4*>(x + ((size_t)b * T + row) * E) + c4);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = (tid & 127) + 128 * (u0 + u), rest = i / 32;
      const int r = i % 8 + 8 * (rest % 8), c = 4 * ((i / 8) % 4 + 4 * (rest / 8));
      *reinterpret_cast<uint2*>(smem + ((c >> 3) * 2 * ROWS + ROWS * wg + r) * 16 + (c & 7) * 2) =
          make_uint2(pack(v[u].x, v[u].y), pack(v[u].z, v[u].w));
    }
  }
  fence_proxy_async();
  named_sync(2 + wg, 128);

  const uint32_t a_wg = a_s + ROWS * wg * 16;
  auto a = [&](int i, int kk) { return kdesc(a_wg + (8 * i + 2 * kk) * 2 * ROWS * 16, 2 * ROWS * 16); };
  const int D = E / H;
  const size_t region = (size_t)tiles * ROWS * E;  // elements of the q, k or v images
  int q = 0;
  for (int n = 0; n < ng; ++n) {
    const int nb = nb0 + n, which = nb * 64 / E;  // 0: q, 1: k, 2: v
    float2 bias2[8];  // loaded before the products: they hide its latency
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
      bias2[jn] = __ldg(reinterpret_cast<const float2*>(bias + nb * 64 + 8 * jn + 2 * t));
    float acc[32];
    block_products<KP>(acc, ring, q, KB, a);
    if (n == ng - 1) pdl_launch_dependents();
    if (!live) continue;
    bf16* img = qkv + which * region;
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = (nb * 64) % E + 8 * jn + 2 * t, h = col / D, d = col % D;
      const float2 bb = bias2[jn];
      bf16* base = img + (((size_t)b * H + h) * NT + j) * ROWS * D;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
        const float v0 = acc[4 * jn + 2 * hr] + bb.x, v1 = acc[4 * jn + 2 * hr + 1] + bb.y;
        if (which < 2) {
          *reinterpret_cast<uint32_t*>(base + (d >> 3) * ROWS * 8 + r * 8 + (d & 7)) = pack(v0, v1);
        } else {  // v^T: [key / 8][d][key % 8]
          const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          base[(r >> 3) * D * 8 + d * 8 + (r & 7)] = p.x;
          base[(r >> 3) * D * 8 + (d + 1) * 8 + (r & 7)] = p.y;
        }
      }
    }
  }
}

// ------------------------------------------------------------------
// 2. Attention, out-projection, residual, LN1 and the row mask for 64
//    query rows from q0 = 64 blockIdx.x of batch row blockIdx.y. Shared
//    memory: ctx [E/8][64][8] bf16, a Q tile a warpgroup, a ring a
//    warpgroup (stages of a K or V tile, or an 8 KB Wo block), LN1's row
//    sums.
// ------------------------------------------------------------------
template <int E, int D>
struct Att {
  static constexpr int TILE = ROWS * D * 2;  // bytes of a Q, K or V tile
  static constexpr int STAGE = TILE > BLOCK ? TILE : BLOCK;
  static constexpr int KPS = STAGE / TILE;  // key tiles a stage: 4 at D = 16, else 1
  // ctx, two Q tiles, LN1's row sums, then a ring a warpgroup of as many
  // stages as the rest leaves, up to 12
  static constexpr int FIXED = ROWS * E * 2 + 2 * TILE + 3 * 2 * ROWS * 4;
  static constexpr int FIT = (SMEM_LIMIT - FIXED) / (2 * (STAGE + 16));
  static constexpr int STAGES = FIT > 12 ? 12 : FIT;
  static constexpr int SMEM = FIXED + 2 * STAGES * (STAGE + 16);
};

template <int E, int D>
constexpr int attn_smem() {
  return Att<E, D>::SMEM;
}

// Rows [r0, r1) of a (zero) and of its image rnd(a) (E / 8 groups of T
// rows of 8 channels a batch row), by threads [0, n).
__device__ __forceinline__ void zero_rows(float* attn, bf16* attn_b, int b, int r0, int r1, int T,
                                          int E, int tid, int n) {
  const int G = E / 8;
  for (int i = tid; i < (r1 - r0) * G; i += n) {
    const int r = r0 + i / G, cg = i % G;
    float4* a = reinterpret_cast<float4*>(attn + ((size_t)b * T + r) * E + 8 * cg);
    a[0] = a[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<uint4*>(attn_b + (((size_t)b * G + cg) * T + r) * 8) = make_uint4(0, 0, 0, 0);
  }
}

template <int E, int D, int KP, int HS>
__global__ void __launch_bounds__(THREADS, 1)
attn_wgmma_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wo,
                  const float* __restrict__ bo, const float* __restrict__ x,
                  const int* __restrict__ lengths, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, float* __restrict__ attn,
                  bf16* __restrict__ attn_b, int T, int NT, float scale) {
  using A = Att<E, D>;
  using R = Ring<A::STAGE>;
  // this block's heads rank, rank + HS, ..; its out-projection columns
  // [rank E / HS, ..) in 64-column blocks, warpgroup w the w-th, w + 2-th ..
  constexpr int H = E / D, KB = E / 64, G = E / 8, NBC = E / 64 / HS;
  constexpr int NSB = (NBC + 1) / 2;  // most column blocks a warpgroup
  constexpr int CTX = ROWS * E * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t ctx_s = saddr(smem), q_s = ctx_s + CTX;
  const uint32_t ring_s = q_s + 2 * A::TILE;
  float* red = reinterpret_cast<float*>(smem + CTX + 2 * A::TILE + 2 * A::STAGES * A::STAGE);
  float* cred = red + 2 * 2 * ROWS;  // the block's row sums, for the cluster
  const uint32_t bars = saddr(cred + 2 * ROWS);
  const R ring0{ring_s, bars, A::STAGES},
      ring1{ring_s + A::STAGES * A::STAGE, bars + 16 * A::STAGES, A::STAGES};
  const int tid = threadIdx.x, b = blockIdx.y, j = blockIdx.x / HS, rank = blockIdx.x % HS;
  const int q0 = ROWS * j;
  const int tiles = gridDim.y * NT;
  const int len = row_length(lengths, b, T);
  if (q0 >= len) {  // every row of the tile is masked (the cluster's blocks alike)
    pdl_wait();
    if (rank == 0) zero_rows(attn, attn_b, b, q0, min(q0 + ROWS, T), T, E, tid, THREADS);
    return;
  }
  if (tid == 0) {
    ring0.init(4);
    ring1.init(4);
    mbar_init_fence();
  }
  __syncthreads();
  const int nkt = (len + ROWS - 1) / ROWS;  // key tiles
  const int nch = (nkt + A::KPS - 1) / A::KPS;  // stages of them a pass
  const size_t region = (size_t)tiles * ROWS * E;

  if (tid >= CONSUMERS) {  // warpgroup w's heads (K tiles, then K and V), then its Wo blocks
    regs_dealloc<PRODUCER_REGS>();
    // the cluster's barriers: the consumers' ctx exchange, two LN1 sums and
    // the end; this warpgroup arrives at the first at once, so that its
    // loads never wait for a barrier that waits for them
    if (HS > 1) cluster_arrive();
    const int p = tid - CONSUMERS;
    if (p == 0 || p == 32) {
      const int w = p / 32;
      const R ring = w ? ring1 : ring0;
      pdl_wait();
      const bf16 *kimg = qkv + region, *vimg = qkv + 2 * region;
      int q = 0;
      for (int h = rank + HS * w; h < H; h += 2 * HS) {
        const size_t hb = ((size_t)b * H + h) * NT;
        // key tiles c KPS .. of a head, one stage
        auto chunk = [&](const bf16* img, int c) {
          const int n = min(A::KPS, nkt - c * A::KPS);
          ring.load(q++, img + (hb + c * A::KPS) * ROWS * D, n * A::TILE);
        };
        for (int c = 0; c < nch; ++c) chunk(kimg, c);
        for (int c = 0; c < nch; ++c) {
          chunk(kimg, c);
          chunk(vimg, c);
        }
      }
      const char* src = reinterpret_cast<const char*>(wo);
      for (int k = w; k < NBC; k += 2)
        for (int i = 0; i < KB; ++i)
          ring.load(q++, src + ((size_t)(rank * NBC + k) * KB + i) * BLOCK, BLOCK);
    }
    if (HS > 1) {
      cluster_wait();
      for (int k = 0; k < 3; ++k) cluster_sync();
    }
    return;
  }
  regs_alloc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const R ring = wg ? ring1 : ring0;
  const float c = scale * LOG2E;
  const uint32_t qs = q_s + wg * A::TILE;
  uint4* q_tile = reinterpret_cast<uint4*>(smem + CTX + wg * A::TILE);
  pdl_wait();
  int q = 0;
  for (int h = rank + HS * wg; h < H; h += 2 * HS) {
    named_sync(2 + wg, 128);  // every warp is done with the last head's Q
    const uint4* src =
        reinterpret_cast<const uint4*>(qkv + (((size_t)b * H + h) * NT + j) * ROWS * D);
    uint4 qv[A::TILE / 16 / 128];
#pragma unroll
    for (int u = 0; u < A::TILE / 16 / 128; ++u) qv[u] = src[(tid & 127) + 128 * u];
#pragma unroll
    for (int u = 0; u < A::TILE / 16 / 128; ++u) q_tile[(tid & 127) + 128 * u] = qv[u];
    fence_proxy_async();
    named_sync(2 + wg, 128);

    // Pass 1: row max and sum (rows g, g + 8 of the warp; columns split
    // over the quad's 4 lanes until the end).
    // m: the row max of s scale; p = 2^(s c - m log2 e), c = scale log2 e:
    // one FFMA and the SFU's ex2.approx (~2 ulp) a score, the same in both
    // passes
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // the last key tile of a stage releases it
    auto last = [&](int i) { return i % A::KPS == A::KPS - 1 || i == nkt - 1; };
    for (int i = 0; i < nkt; ++i) {
      const int qk = q + i / A::KPS;
      ring.wait(qk);
      const uint32_t kt = ring.stage(qk) + (i % A::KPS) * A::TILE;
      float s[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(s, kdesc(qs + kk * 2 * ROWS * 16, ROWS * 16),
                     kdesc(kt + kk * 2 * ROWS * 16, ROWS * 16), kk);
      wg_commit();
      wg_wait<0>();
      hold(s);
      if (last(i)) ring.release(qk);
      const int k0 = ROWS * i;
      const bool full = k0 + ROWS <= len;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (full || k0 + acc_col(e, t) < len) mx[acc_row(e)] = fmaxf(mx[acc_row(e)], s[e]);
      float m2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // m stays -inf while every column was masked
        const float mn = fmaxf(m[r], mx[r] * scale);
        l[r] = m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mn) * LOG2E);
        m[r] = mn;
        m2[r] = mn * LOG2E;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float v = ex2(fmaf(s[e], c, -m2[acc_row(e)]));
        l[acc_row(e)] += full || k0 + acc_col(e, t) < len ? v : 0.f;
      }
    }
    // The four lanes of a quad hold disjoint columns of the same two rows.
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
        const float mn = fmaxf(m[r], mo);
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * ex2((m[r] - mn) * LOG2E)) +
               (mo == -INFINITY ? 0.f : lo * ex2((mo - mn) * LOG2E));
        m[r] = mn;
      }
    const float inv_l[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
    const float m2[2] = {m[0] * LOG2E, m[1] * LOG2E};
    q += nch;

    // Pass 2: P = rnd(exp(s - m) / l) and PV, in a fresh partial a key
    // tile added into o. Loads: the K tiles of stage c at q + 2 c, their V
    // tiles after them. The previous tile's PV runs while this tile's
    // probabilities are worked.
    float o[D / 2], pp[D / 2];
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) o[n] = 0.f;
    auto vq = [&](int i) { return q + 2 * (i / A::KPS) + 1; };
    auto pv = [&](int i) {
      ring.wait(vq(i));
      const uint32_t vt = ring.stage(vq(i)) + (i % A::KPS) * A::TILE;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(pp, pa[kk], kdesc(vt + kk * 2 * D * 16, D * 16), kk);
      wg_commit();
    };
    auto add_pv = [&](int i) {
      hold(pp);
      hold(pa);
#pragma unroll
      for (int n = 0; n < D / 2; ++n) o[n] += pp[n];
      if (last(i)) ring.release(vq(i));
    };
    for (int i = 0; i < nkt; ++i) {
      const int qk = q + 2 * (i / A::KPS);
      ring.wait(qk);
      const uint32_t kt = ring.stage(qk) + (i % A::KPS) * A::TILE;
      float s[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<64>(s, kdesc(qs + kk * 2 * ROWS * 16, ROWS * 16),
                     kdesc(kt + kk * 2 * ROWS * 16, ROWS * 16), kk);
      wg_commit();
      if (i > 0) {
        pv(i - 1);
        wg_wait<1>();
      } else {
        wg_wait<0>();
      }
      hold(s);
      if (last(i)) ring.release(qk);
      const int k0 = ROWS * i;
      const bool full = k0 + ROWS <= len;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = acc_row(e);
        const float p = ex2(fmaf(s[e], c, -m2[r])) * inv_l[r];
        s[e] = full || k0 + acc_col(e, t) < len ? p : 0.f;  // a select: no branch in the tile
      }
      if (i > 0) {
        wg_wait<0>();
        add_pv(i - 1);
      }
      // element pair e of the accumulator is register (e / 2) % 4 of k-step
      // e / 8 of the A operand
#pragma unroll
      for (int e = 0; e < 32; e += 2) pa[e >> 3][(e >> 1) & 3] = pack(s[e], s[e + 1]);
    }
    pv(nkt - 1);
    wg_wait<0>();
    add_pv(nkt - 1);
    q += 2 * nch;
    // ctx = rnd(o) at head columns h D ..
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr, c = h * D + 8 * jn + 2 * t;
        *reinterpret_cast<uint32_t*>(smem + ((c >> 3) * ROWS + r) * 16 + (c & 7) * 2) =
            pack(o[4 * jn + 2 * hr], o[4 * jn + 2 * hr + 1]);
      }
  }
  if (HS > 1) {  // the other blocks' heads' ctx columns, through distributed shared memory
    cluster_sync();
    for (int h = 0; h < H; ++h) {
      if (h % HS == rank) continue;
      const uint32_t at = ctx_s + h * (D / 8) * ROWS * 16;
      for (int i = tid; i < ROWS * D / 8; i += CONSUMERS) {
        const float4 v = cluster_load4(cluster_addr(at + 16 * i, h % HS));
        *reinterpret_cast<float4*>(smem + (at - ctx_s) + 16 * i) = v;
      }
    }
  }
  fence_proxy_async();
  named_sync(SYNC, CONSUMERS);

  // The out-projection: this warpgroup's column blocks
  const int nsb = (NBC - wg + 1) / 2;
  float acc[NSB][32];
  auto a = [&](int i, int kk) { return kdesc(ctx_s + (8 * i + 2 * kk) * ROWS * 16, ROWS * 16); };
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb)
    if (sb < nsb) block_products<KP, (NSB < 4)>(acc[sb], ring, q, KB, a);
  pdl_launch_dependents();
  auto column = [&](int sb, int jn) { return 64 * (rank * NBC + wg + 2 * sb) + 8 * jn + 2 * t; };
  // the row sums of the block's columns, then of the cluster's (rank order)
  auto row_sums = [&](float(&v)[2], int stat) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      v[hr] += __shfl_xor_sync(0xffffffffu, v[hr], 1);
      v[hr] += __shfl_xor_sync(0xffffffffu, v[hr], 2);
      if (t == 0) red[(wg * 2 + stat) * ROWS + 16 * warp + g + 8 * hr] = v[hr];
    }
    named_sync(SYNC, CONSUMERS);
    if (HS > 1) {
      if (tid < ROWS) cred[stat * ROWS + tid] = red[stat * ROWS + tid] + red[(2 + stat) * ROWS + tid];
      cluster_sync();
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const uint32_t at = saddr(cred + stat * ROWS + 16 * warp + g + 8 * hr);
        float sum = 0.f;
        for (int rk = 0; rk < HS; ++rk) {
          float r;
          asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                       : "=f"(r) : "r"(cluster_addr(at, rk)) : "memory");
          sum += r;
        }
        v[hr] = sum;
      }
    } else {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + g + 8 * hr;
        v[hr] = red[stat * ROWS + r] + red[(2 + stat) * ROWS + r];
      }
    }
  };

  // pre = acc + bo + x, then LN1 over the row (sums of both warpgroups'
  // columns meet in red[warpgroup][sum | squares][row]), mask, store.
  int rows[2];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) rows[hr] = q0 + 16 * warp + g + 8 * hr;
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (sb >= nsb) continue;
      const int col = column(sb, jn);
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bo + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float2 xr = make_float2(0.f, 0.f);
        if (rows[hr] < T)
          xr = __ldg(reinterpret_cast<const float2*>(x + ((size_t)b * T + rows[hr]) * E + col));
        float& v0 = acc[sb][4 * jn + 2 * hr];
        float& v1 = acc[sb][4 * jn + 2 * hr + 1];
        v0 = v0 + bb.x + xr.x;
        v1 = v1 + bb.y + xr.y;
        sum[hr] += v0 + v1;
      }
    }
  float mean[2], sq[2] = {0.f, 0.f};
  row_sums(sum, 0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) mean[hr] = sum[hr] / E;
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      if (sb >= nsb) continue;
      const float d = acc[sb][e] - mean[acc_row(e)];
      sq[acc_row(e)] += d * d;
    }
  row_sums(sq, 1);
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) inv[hr] = 1.f / sqrtf(sq[hr] / E + LN_EPS);
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      if (sb >= nsb) continue;
      const int col = column(sb, jn);
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(ln_s + col));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(ln_b + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = rows[hr];
        if (row >= T) continue;
        const bool valid = row < len;
        const float y0 = valid ? (acc[sb][4 * jn + 2 * hr] - mean[hr]) * inv[hr] * s2.x + b2.x : 0.f;
        const float y1 =
            valid ? (acc[sb][4 * jn + 2 * hr + 1] - mean[hr]) * inv[hr] * s2.y + b2.y : 0.f;
        *reinterpret_cast<float2*>(attn + ((size_t)b * T + row) * E + col) = make_float2(y0, y1);
        *reinterpret_cast<uint32_t*>(attn_b + (((size_t)b * G + (col >> 3)) * T + row) * 8 +
                                     (col & 7)) = pack(y0, y1);
      }
    }
  if (HS > 1) cluster_sync();  // the other blocks have read this block's ctx and sums
}

// ------------------------------------------------------------------
// 3. conv1 -> ReLU -> conv2 -> residual -> LN2 -> FiLM -> mask for the
//    tm = 64 MT - 2 output rows from lo = tm tile of batch row blockIdx.y
//    (MT m64 tiles: 2 at E = 128, 1 above). Grid (cs tiles, B), a cluster
//    of cs blocks a tile: rank r holds hidden blocks (64 channels) nb0 +
//    r, nb0 + r + cs, ... below nb0 + nbl (a chunk of the C / 64; phase:
//    CHUNK_FIRST, the first chunk, CHUNK_LAST, the last; the other chunks'
//    conv2 sums meet in part). Shared memory: conv1's operand [E/8][64 MT + 2][8] (rows lo -
//    2 ..), the hidden [blocks x 8][64 MT][8] (rows lo - 1 ..); after
//    conv2, the f32 pre-LN tile [64 MT][E + 8] over both; the rings. MT =
//    2: the warpgroups take one m64 tile each and read every weight stage
//    of one ring (half the weight stream a row); MT = 1: they take
//    alternate hidden blocks, then halves of conv2's columns, a ring each.
// ------------------------------------------------------------------
__host__ __device__ constexpr int conv_mt(int E) { return E == 128 ? 2 : 1; }
__host__ __device__ constexpr int conv_tm(int E) { return 64 * conv_mt(E) - 2; }
// weight stages in flight a block: as many as the shared memory leaves, up
// to 24, in one ring (MT = 2) or two of half as many
constexpr int CONV_RING_MAX = 24;
constexpr int CHUNK_FIRST = 1, CHUNK_LAST = 2;
__host__ __device__ constexpr int conv_region(int E, int nj) {
  return align1k((64 * conv_mt(E) + 2) * E * 2) + nj * BLOCK * conv_mt(E) >
                 64 * conv_mt(E) * (E + 8) * 4
             ? align1k((64 * conv_mt(E) + 2) * E * 2) + nj * BLOCK * conv_mt(E)
             : 64 * conv_mt(E) * (E + 8) * 4;
}
__host__ __device__ constexpr int conv_stages(int E, int nj) {
  return (SMEM_LIMIT - conv_region(E, nj)) / (BLOCK + 16) / 2 * 2 > CONV_RING_MAX
             ? CONV_RING_MAX
             : (SMEM_LIMIT - conv_region(E, nj)) / (BLOCK + 16) / 2 * 2;
}
__host__ __device__ constexpr int conv_smem(int E, int nj) {
  return conv_region(E, nj) + conv_stages(E, nj) * (BLOCK + 16);
}

template <int E, int KP>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgmma_kernel(const bf16* __restrict__ attn_b, const float* __restrict__ attn,
                  const bf16* __restrict__ w1, const float* __restrict__ b1,
                  const bf16* __restrict__ w2, const float* __restrict__ b2,
                  const int* __restrict__ lengths, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, const float* __restrict__ film,
                  int film_stride, float* __restrict__ out, float* __restrict__ part, int T,
                  int C, int nb0, int nbl, int phase, int cs, int region, int stages) {
  constexpr int MT = conv_mt(E), TMR = conv_tm(E), HR = 64 * MT, AR = HR + 2;
  constexpr int G = E / 8, KB1 = 3 * E / 64, EV = E / 128;
  constexpr int NSB = MT == 2 ? E / 64 : E / 128;  // conv2's 64-column blocks a warpgroup
  constexpr int A_BYTES = align1k(AR * E * 2), PRE_LD = E + 8;
  using R = Ring<BLOCK>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t a_s = saddr(smem), h_s = a_s + A_BYTES, ring_s = a_s + region;
  const uint32_t bars = ring_s + stages * BLOCK;
  const int S = MT == 2 ? stages : stages / 2;
  const R ring0{ring_s, bars, S}, ring1{ring_s + S * BLOCK, bars + 16 * S, S};
  const int tid = threadIdx.x, b = blockIdx.y, tile = blockIdx.x / cs, rank = blockIdx.x % cs;
  const int lo = TMR * tile, len = row_length(lengths, b, T);
  const int nblk = C / 64, nj = (nbl - rank + cs - 1) / cs;
  const bool last = phase & CHUNK_LAST;
  if (lo >= len) {  // every output row is masked (the cluster's blocks alike)
    pdl_wait();
    if (rank == 0 && last) {
      const int r1 = min(lo + TMR, T);
      for (int i = tid; i < (r1 - lo) * G; i += THREADS) {
        float4* o = reinterpret_cast<float4*>(out + ((size_t)b * T + lo + i / G) * E + 8 * (i % G));
        o[0] = o[1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  if (tid == 0) {
    ring0.init(MT == 2 ? 8 : 4);
    if (MT == 1) ring1.init(4);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // conv1's blocks, then conv2's columns, in the consumers' order
    regs_dealloc<PRODUCER_REGS>();
    const int p = tid - CONSUMERS;
    if (p == 0 || (MT == 1 && p == 32)) {
      const int w = p / 32;
      const R ring = w ? ring1 : ring0;
      const char *s1 = reinterpret_cast<const char*>(w1), *s2 = reinterpret_cast<const char*>(w2);
      int q = 0;
      for (int jl = MT == 2 ? 0 : w; jl < nj; jl += 3 - MT) {
        const int nb = nb0 + rank + cs * jl;
        for (int i = 0; i < KB1; ++i) ring.load(q++, s1 + ((size_t)nb * KB1 + i) * BLOCK, BLOCK);
      }
      for (int sb = 0; sb < NSB; ++sb) {
        const int nb = (MT == 2 ? 0 : w * NSB) + sb;
        for (int i = 0; i < 3 * nj; ++i) {
          const int tap = i / nj, jl = i % nj;
          ring.load(q++,
                    s2 + ((size_t)nb * 3 * nblk + tap * nblk + nb0 + rank + cs * jl) * BLOCK,
                    BLOCK);
        }
      }
    }
    if (cs > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }
  regs_alloc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const R ring = MT == 1 && wg ? ring1 : ring0;
  const int m0 = MT == 2 ? 64 * wg : 0;  // this warpgroup's first row of the tile
  pdl_wait();
  // conv1's operand: rnd(a) rows lo - 2 .., zero outside [0, T); a
  // thread's loads issued before its stores
  constexpr int UA = (AR * G + CONSUMERS - 1) / CONSUMERS;
  {
    uint4 v[UA];
#pragma unroll
    for (int k = 0; k < UA; ++k) {
      const int i = tid + CONSUMERS * k, u = i % AR, cg = i / AR, row = lo - 2 + u;
      v[k] = make_uint4(0, 0, 0, 0);
      if (i < AR * G && row >= 0 && row < T)
        v[k] = __ldg(reinterpret_cast<const uint4*>(attn_b + (((size_t)b * G + cg) * T + row) * 8));
    }
#pragma unroll
    for (int k = 0; k < UA; ++k) {
      const int i = tid + CONSUMERS * k;
      if (i < AR * G) *reinterpret_cast<uint4*>(smem + i * 16) = v[k];
    }
  }
  fence_proxy_async();
  named_sync(SYNC, CONSUMERS);

  // conv1: hidden row h (t = lo - 1 + h) reads operand rows h + tap
  int q = 0;
  auto a1 = [&](int i, int kk) {
    const int tap = i / (E / 64), ec = i % (E / 64);
    return kdesc(a_s + (m0 + tap) * 16 + (8 * ec + 2 * kk) * AR * 16, AR * 16);
  };
  for (int jl = MT == 2 ? 0 : wg; jl < nj; jl += 3 - MT) {
    float acc[32];
    block_products<KP>(acc, ring, q, KB1, a1);
    const int ch0 = 64 * (nb0 + rank + cs * jl);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(b1 + ch0 + 8 * jn + 2 * t));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int h = m0 + 16 * warp + g + 8 * hr, row = lo - 1 + h;
        const bool in = row >= 0 && row < T;
        const float v0 = in ? fmaxf(acc[4 * jn + 2 * hr] + bb.x, 0.f) : 0.f;
        const float v1 = in ? fmaxf(acc[4 * jn + 2 * hr + 1] + bb.y, 0.f) : 0.f;
        *reinterpret_cast<uint32_t*>(smem + A_BYTES + ((jl * 8 + jn) * HR + h) * 16 + 4 * t) =
            pack(v0, v1);
      }
    }
  }
  fence_proxy_async();
  named_sync(SYNC, CONSUMERS);

  // conv2: output row o (t = lo + o) reads hidden rows o + tap; chunks
  // (tap, hidden block) in that order
  float acc[NSB][32];
  auto a2 = [&](int i, int kk) {
    const int tap = i / nj, jl = i % nj;
    return kdesc(h_s + (m0 + tap) * 16 + (8 * jl + 2 * kk) * HR * 16, HR * 16);
  };
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb) block_products<KP, (NSB < 4)>(acc[sb], ring, q, 3 * nj, a2);
  pdl_launch_dependents();
  const int c0 = MT == 2 ? 0 : 64 * wg * NSB;  // this warpgroup's first column
  named_sync(SYNC, CONSUMERS);  // every product has read its operand: the pre tile goes over them
  float* pre = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int sb = 0; sb < NSB; ++sb)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = m0 + 16 * warp + g + 8 * hr, col = c0 + 64 * sb + 8 * jn + 2 * t;
        *reinterpret_cast<float2*>(pre + r * PRE_LD + col) =
            make_float2(acc[sb][4 * jn + 2 * hr], acc[sb][4 * jn + 2 * hr + 1]);
      }
  if (cs > 1)
    cluster_sync();
  else
    named_sync(SYNC, CONSUMERS);

  // A warp a row of this rank's share, RB rows at a time with all their
  // loads issued first: the cluster's pre tiles added in rank order (then
  // to the chunks' before), + b2 + a, LN2, FiLM, mask (lane l: columns
  // 128 j + 4 l ..; the columns' terms loaded once); a chunk but the last
  // stores its sum into part instead.
  constexpr int RB = EV > 2 ? 2 : 4;
  const int per = (TMR + cs - 1) / cs, r0 = rank * per, r1 = min(min(TMR, r0 + per), T - lo);
  float4 ls[EV], lb[EV], fg[EV], fb[EV], bb[EV];
#pragma unroll
  for (int jv = 0; jv < EV; ++jv) {
    const int n = 128 * jv + 4 * lane;
    ls[jv] = __ldg(reinterpret_cast<const float4*>(ln_s + n));
    lb[jv] = __ldg(reinterpret_cast<const float4*>(ln_b + n));
    bb[jv] = __ldg(reinterpret_cast<const float4*>(b2 + n));
    fg[jv] = make_float4(1.f, 1.f, 1.f, 1.f);
    fb[jv] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (film != nullptr) {
      fg[jv] = __ldg(reinterpret_cast<const float4*>(film + (size_t)b * film_stride + n));
      fb[jv] = __ldg(reinterpret_cast<const float4*>(film + (size_t)b * film_stride + E + n));
    }
  }
  for (int o0 = r0 + (tid >> 5) * RB; o0 < r1; o0 += CONSUMERS / 32 * RB) {
    float4 v[RB][EV], av[RB][EV];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int o = min(o0 + k, r1 - 1), row = lo + o;  // a row past the share: loaded, unused
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        av[k][jv] = __ldg(reinterpret_cast<const float4*>(attn + ((size_t)b * T + row) * E + n));
        if (cs > 1) {
          const uint32_t at = a_s + (o * PRE_LD + n) * 4;
          v[k][jv] = cluster_load4(cluster_addr(at, 0));
          for (int rk = 1; rk < cs; ++rk) {
            const float4 p = cluster_load4(cluster_addr(at, rk));
            v[k][jv].x += p.x;
            v[k][jv].y += p.y;
            v[k][jv].z += p.z;
            v[k][jv].w += p.w;
          }
        } else {
          v[k][jv] = *reinterpret_cast<const float4*>(pre + o * PRE_LD + n);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int o = o0 + k, row = lo + o;
      if (o >= r1) break;
      if (!(phase & CHUNK_FIRST) || !last) {
        float4* pr = reinterpret_cast<float4*>(part + ((size_t)b * T + row) * E + 4 * lane);
#pragma unroll
        for (int jv = 0; jv < EV; ++jv) {
          if (!(phase & CHUNK_FIRST)) {
            const float4 p = pr[32 * jv];
            v[k][jv].x += p.x;
            v[k][jv].y += p.y;
            v[k][jv].z += p.z;
            v[k][jv].w += p.w;
          }
          if (!last) pr[32 * jv] = v[k][jv];
        }
        if (!last) continue;
      }
      float* dst = out + ((size_t)b * T + row) * E;
      if (row >= len) {
#pragma unroll
        for (int jv = 0; jv < EV; ++jv)
          *reinterpret_cast<float4*>(dst + 128 * jv + 4 * lane) = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float y[4 * EV];
      float sum = 0.f;
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        y[4 * jv] = v[k][jv].x + bb[jv].x + av[k][jv].x;
        y[4 * jv + 1] = v[k][jv].y + bb[jv].y + av[k][jv].y;
        y[4 * jv + 2] = v[k][jv].z + bb[jv].z + av[k][jv].z;
        y[4 * jv + 3] = v[k][jv].w + bb[jv].w + av[k][jv].w;
#pragma unroll
        for (int e = 0; e < 4; ++e) sum += y[4 * jv + e];
      }
      const float mean = warp_sum(sum) / E;
      float sq = 0.f;
#pragma unroll
      for (int e = 0; e < 4 * EV; ++e) sq += (y[e] - mean) * (y[e] - mean);
      const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        float4 z = make_float4((y[4 * jv] - mean) * inv * ls[jv].x + lb[jv].x,
                               (y[4 * jv + 1] - mean) * inv * ls[jv].y + lb[jv].y,
                               (y[4 * jv + 2] - mean) * inv * ls[jv].z + lb[jv].z,
                               (y[4 * jv + 3] - mean) * inv * ls[jv].w + lb[jv].w);
        if (film != nullptr)
          z = make_float4(fg[jv].x * z.x + fb[jv].x, fg[jv].y * z.y + fb[jv].y,
                          fg[jv].z * z.z + fb[jv].z, fg[jv].w * z.w + fb[jv].w);
        *reinterpret_cast<float4*>(dst + n) = z;
      }
    }
  }
  if (cs > 1) cluster_sync();  // the other blocks have read this block's pre tile
}

// ------------------------------------------------------------------
// Host side
// ------------------------------------------------------------------
// Consecutive pieces of one workspace, each 256-byte aligned; from a null
// base it only counts the bytes.
struct Carve {
  char* p;
  size_t used = 0;
  template <class T>
  T* take(size_t n) {
    T* r = p ? reinterpret_cast<T*>(p + used) : nullptr;
    used += (n * sizeof(T) + 255) / 256 * 256;
    return r;
  }
};

struct Work {
  bf16 *qkv, *attn_b;
  float *attn, *part;
};

// The smallest cluster whose blocks each hold their share of nbl hidden
// blocks beside 8 ring stages (0: none does).
int fit_cluster(int E, int nbl) {
  for (int cs = 1; cs <= MAX_CLUSTER && cs <= nbl; cs *= 2)
    if (conv_region(E, (nbl + cs - 1) / cs) < SMEM_LIMIT &&
        conv_stages(E, (nbl + cs - 1) / cs) >= 8)
      return cs;
  return 0;
}

// Launch 3's chunks of the C / 64 hidden blocks: one where a cluster
// holds them all, else the fewest equal ones a cluster of 8 holds.
int conv_chunks(int E, int C) {
  int n = 1;
  while (fit_cluster(E, (C / 64 + n - 1) / n) == 0) ++n;
  return n;
}

// Hidden blocks [chunk_lo(k), chunk_lo(k + 1)) of chunk k of n.
int chunk_lo(int nblk, int n, int k) { return (int)((long long)nblk * k / n); }

Work carve(Carve& cv, int B, int T, int E, int C) {
  const size_t nt = (size_t)(T + ROWS - 1) / ROWS;
  Work w{};
  w.qkv = cv.take<bf16>(3 * (size_t)B * nt * ROWS * E);
  w.attn_b = cv.take<bf16>((size_t)B * T * E);
  w.attn = cv.take<float>((size_t)B * T * E);
  w.part = conv_chunks(E, C) > 1 ? cv.take<float>((size_t)B * T * E) : nullptr;
  return w;
}

struct Args {
  const float* x;
  const int* lengths;
  const bf16* images;
  const float *bqkv, *bo, *ln1_s, *ln1_b, *b1, *b2, *ln2_s, *ln2_b, *film;
  int film_stride, B, T, C, H;
};

int sm_count() {
  static std::atomic<int> count{0};
  int n = count.load();
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
    count.store(n);
  }
  return n;
}

// Launch 3's cluster over nbl hidden blocks: the smallest that fits, at
// least 4 at E = 128 (two m64 tiles: a quarter of the hidden a block
// leaves 16 ring stages, which took the flagship tiles' weight stream from
// 0.055 to 0.032 device ms on an H100, though 4 blocks a tile need more
// than one wave), doubled while the tiles' clusters still fit the card in
// one wave and each block keeps a hidden block.
int pick_cluster(int B, int T, int E, int nbl) {
  int cs = fit_cluster(E, nbl);
  if (conv_mt(E) == 2 && cs > 0 && cs < 4 && nbl >= 4) cs = 4;
  const long long tiles = (long long)B * ((T + conv_tm(E) - 1) / conv_tm(E));
  while (cs > 0 && 2 * cs <= MAX_CLUSTER && 2 * cs <= nbl && tiles * 2 * cs <= sm_count())
    cs *= 2;
  return cs;
}

// Launch 1's column blocks a block: the fewest that keep its blocks in one
// wave (each block converts its rows of x once for all its columns).
int pick_ng(int pairs, int nblocks) {
  for (int d = 1; d < nblocks; ++d)
    if (nblocks % d == 0 && (long long)pairs * (nblocks / d) <= sm_count()) return d;
  return nblocks;
}

template <class... Params, class... Actual>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int smem, int cluster, cudaStream_t st,
                   Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 1;
  if (cluster > 1) {
    attr[1].id = cudaLaunchAttributeClusterDimension;
    attr[1].val.clusterDim.x = cluster;
    attr[1].val.clusterDim.y = 1;
    attr[1].val.clusterDim.z = 1;
    cfg.numAttrs = 2;
  }
  cfg.attrs = attr;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// setmaxnreg's pool holds only at the launch's 168 registers a thread: a
// build that gave a kernel another count would wait forever for them.
template <class K>
bool launch_regs(K kernel) {
  cudaFuncAttributes attr{};
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess && attr.numRegs == LAUNCH_REGS;
}

template <int E, int D, int KP, int HS>
cudaError_t attention_at(const Args& a, const Work& w, int NT, cudaStream_t st) {
  static smem_limit::Record allowed;
  static const bool regs = launch_regs(attn_wgmma_kernel<E, D, KP, HS>);
  if (!regs) return cudaErrorInvalidConfiguration;
  cudaError_t err =
      smem_limit::allow(attn_wgmma_kernel<E, D, KP, HS>, attn_smem<E, D>(), allowed);
  if (err != cudaSuccess) return err;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  return launch(attn_wgmma_kernel<E, D, KP, HS>, dim3(HS * NT, a.B), attn_smem<E, D>(), HS, st,
                (const bf16*)w.qkv, a.images + 3 * E * E, a.bo, a.x, a.lengths, a.ln1_s,
                a.ln1_b, w.attn, w.attn_b, a.T, NT, scale);
}

// Launch 2's cluster: 2 blocks a query tile (half the heads each) where
// each keeps two heads or more and the tiles alone leave half the card
// idle; else 1. (A block of one head, its warpgroups splitting the key
// tiles and meeting in shared memory, was no faster at the frame decoder
// on an H100 and slower at the phoneme encoder's single key tile.)
int attn_cluster(int B, int NT, int H) {
  return H >= 4 && 2LL * B * NT <= sm_count() ? 2 : 1;
}

template <int E, int D, int KP>
cudaError_t attention(const Args& a, const Work& w, int NT, cudaStream_t st) {
  if constexpr (E / D >= 4) {
    return attn_cluster(a.B, NT, a.H) == 2 ? attention_at<E, D, KP, 2>(a, w, NT, st)
                                           : attention_at<E, D, KP, 1>(a, w, NT, st);
  } else {
    return attention_at<E, D, KP, 1>(a, w, NT, st);
  }
}

// One call's three launches (launch 3 once a chunk) at width E, head dim
// D and partial sums of KP k16 products.
template <int E, int D, int KP>
cudaError_t forward(const Args& a, void* ws, float* out, cudaStream_t st) {
  static smem_limit::Record qkv_allowed, conv_allowed;
  static const bool conv_regs = launch_regs(conv_wgmma_kernel<E, KP>);
  if (!conv_regs) return cudaErrorInvalidConfiguration;
  const int B = a.B, T = a.T, C = a.C, NT = (T + ROWS - 1) / ROWS, tiles = B * NT;
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, B, T, E, C);
  cudaError_t err;

  const int pairs = (tiles + 1) / 2, nblocks = 3 * E / 64, ng = pick_ng(pairs, nblocks);
  if ((err = smem_limit::allow(qkv_wgmma_kernel<E, KP>, qkv_smem<E>(), qkv_allowed)) !=
      cudaSuccess)
    return err;
  if ((err = launch(qkv_wgmma_kernel<E, KP>, dim3(pairs, nblocks / ng), qkv_smem<E>(), 1, st,
                    a.x, a.images, a.bqkv, w.qkv, T, NT, a.H, tiles, ng)) != cudaSuccess)
    return err;

  if ((err = attention<E, D, KP>(a, w, NT, st)) != cudaSuccess) return err;

  const bf16* w1 = a.images + 4 * E * E;
  const bf16* w2 = w1 + (size_t)3 * E * C;
  const int nblk = C / 64, chunks = conv_chunks(E, C);
  for (int k = 0; k < chunks; ++k) {
    const int nb0 = chunk_lo(nblk, chunks, k), nbl = chunk_lo(nblk, chunks, k + 1) - nb0;
    const int cs = pick_cluster(B, T, E, nbl);
    const int nj = (nbl + cs - 1) / cs, smem = conv_smem(E, nj);
    const int phase = (k == 0 ? CHUNK_FIRST : 0) | (k == chunks - 1 ? CHUNK_LAST : 0);
    if ((err = smem_limit::allow(conv_wgmma_kernel<E, KP>, smem, conv_allowed)) != cudaSuccess)
      return err;
    if ((err = launch(conv_wgmma_kernel<E, KP>, dim3(cs * ((T + conv_tm(E) - 1) / conv_tm(E)), B),
                      smem, cs, st, (const bf16*)w.attn_b, (const float*)w.attn, w1, a.b1, w2,
                      a.b2, a.lengths, a.ln2_s, a.ln2_b, a.film, a.film_stride, out, w.part, T,
                      C, nb0, nbl, phase, cs, conv_region(E, nj), conv_stages(E, nj))) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

bool takes(int B, int T, int E, int C, int H) {
  const int D = H > 0 && E % H == 0 ? E / H : 0;
  return B > 0 && T > 0 && (E == 128 || E == 256 || E == 512) &&
         (D == 16 || D == 64 || D == 128) && C > 0 && C % 128 == 0;
}

int attn_smem_at(int E, int D) {
  switch (E * 1000 + D) {
#define K1_ATTN_SMEM(e, d) \
  case e * 1000 + d:       \
    return attn_smem<e, d>();
    K1_ATTN_SMEM(128, 16) K1_ATTN_SMEM(128, 64) K1_ATTN_SMEM(128, 128)
    K1_ATTN_SMEM(256, 16) K1_ATTN_SMEM(256, 64) K1_ATTN_SMEM(256, 128)
    K1_ATTN_SMEM(512, 16) K1_ATTN_SMEM(512, 64) K1_ATTN_SMEM(512, 128)
#undef K1_ATTN_SMEM
    default: return 0;
  }
}

size_t smem_bytes(int E, int H, int C) {
  const int nbl = (C / 64 + conv_chunks(E, C) - 1) / conv_chunks(E, C), cs = fit_cluster(E, nbl);
  const int qkv = E == 128 ? qkv_smem<128>() : E == 256 ? qkv_smem<256>() : qkv_smem<512>();
  const int conv = conv_smem(E, (nbl + cs - 1) / cs);
  const int attn = attn_smem_at(E, E / H);
  return (size_t)(qkv > attn ? (qkv > conv ? qkv : conv) : (attn > conv ? attn : conv));
}

using Forward = cudaError_t (*)(const Args&, void*, float*, cudaStream_t);

// Head dim of H heads at width E (0 where H does not divide E).
inline int head_dim(int E, int H) { return H > 0 && E % H == 0 ? E / H : 0; }

// One call through ``fwd`` (a forward<E, D, KP> of the calling library,
// null where it builds none for the call's E and D): the first CUDA error.
inline int call(Forward fwd, const float* x, const int* lengths, const void* images,
                const float* bqkv, const float* bo, const float* ln1_s, const float* ln1_b,
                const float* b1, const float* b2, const float* ln2_s, const float* ln2_b,
                const float* film, int film_stride, void* ws, float* out, int B, int T, int E,
                int C, int H, void* stream_handle) {
  if (fwd == nullptr || !takes(B, T, E, C, H)) return cudaErrorInvalidValue;
  const Args a{x,  lengths, static_cast<const bf16*>(images), bqkv,  bo,          ln1_s, ln1_b,
               b1, b2,      ln2_s,                         ln2_b, film, film_stride, B, T, C, H};
  return fwd(a, ws, out, static_cast<cudaStream_t>(stream_handle));
}

}  // namespace
