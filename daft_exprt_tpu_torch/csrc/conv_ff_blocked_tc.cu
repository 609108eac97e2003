// Training conv feed-forward, tensor-core instance of K3 and of the
// C-blocked K4, forward and backward, for Hopper, sm_90a: wgmma products
// on operands fed by the TMA unit (bulk copies), warp-specialised blocks,
// launches chained by programmatic dependent launch.
//
// Replaces the Pallas TPU kernels daft_exprt_tpu/ops/conv_ff_train.py
// _fwd_kernel and _bwd_kernel (K3) and _fwd_kernel_blocked,
// _bwd_rowlocal_kernel, _bwd_blockgrads_kernel and _bwd_dx_kernel (K4) on
// the bf16 training path; f32 dots, and bf16 with the rounding off
// (chip_smoke's control), keep the CUDA-core instances (conv_ff_train.cu,
// conv_ff_blocked.cu), whose headers state the function. Widths E = 128,
// 256, 384 or 512 and C % 128 == 0, any T >= 1. The hidden channels are
// not taken in blocks here: conv2 sums over all C, which only reorders
// float32 sums of exact bf16 products.
//
// What bounds it on this card: operations. At the flagship frame rate
// (B=16, T=768, E=128, C=1024) the forward does 12 B T E C = 19.3 GFLOP
// (20 us at the bf16 tensor-core peak) against ~32 MB of compulsory
// traffic (10 us of HBM time); the backward three times the FLOPs.
//
// Design (conv_ff_wgmma.cuh has the GEMM cores and the operand layouts).
// The operands are bf16 at the Pallas rounding points -- rnd(x), the
// weights and their tap-reversed transposes, h, rnd(da2) and rnd(da1) --
// kept in device memory as images of the no-swizzle wgmma layout in
// 64-row chunks with their halo rows, so every stage of a ring is two or
// three bulk copies and the k = 3 shift is a descriptor offset. The
// launches:
//
//   forward   1 cff_pack_x_kernel    rnd(x) -> its image
//             2 conv_c_wgmma_kernel  h = rnd(relu(conv1(rnd x) + b1)) -> image
//             3 conv_e_wgmma_kernel  a2 = conv2(h) + b2, out = gamma *
//                                    LN(drop(a2) + x) + beta
//   backward  1-2 as above (the hidden recomputed)
//             3 conv_e_wgmma_kernel  a2 recomputed; dr, rnd(da2) -> image,
//                                    per-block partials of dfilm, dLN, db2
//             4 conv_c_wgmma_kernel  da1 = h > 0 ? conv2^T(rnd da2) : 0 ->
//                                    rnd(da1) image, per-tile db1 partials
//             5 conv_e_wgmma_kernel  dx = dr + conv1^T(rnd da1)
//             6 wgrad_wgmma_kernel   dW1[d] = shift_d(rnd x)^T rnd(da1),
//                                    dW2[d] = shift_d(h)^T rnd(da2)
//             7 cff_finish_kernel    db1, dLN, db2, dfilm: partials in order
//
// conv_c (N = C columns): persistent blocks walk the 128 x 128 output
// tiles, the producer's ring running on into the next tile while the
// consumers write this one's epilogue from their registers. conv_e (N = E
// columns, K = 3C): a cluster of E / 128 column tiles times S splits of
// K owns 128 rows; each block parks its f32 partial tile in shared memory
// and, after the cluster barrier, every block takes a share of the rows
// whole (all E columns, the splits added in rank order through
// distributed shared memory, a warp's rows' loads all issued before the
// first is used), so dropout, the residual, LayerNorm and FiLM (or their
// backward, or dx = dr + ...) run in that epilogue: no f32 a2 round trip,
// no row kernel, no split partials in device memory. The weight gradients
// run with the rows as K (both operands MN-major): three consumer
// warpgroups, one a tap, share each stage (a chunk of the two factors),
// and the row splits of a tile are a cluster whose partial tiles meet the
// same way.
//
// Sums: conv_stage / wgrad_stage in conv_ff_wgmma.cuh; the wrappers pass
// SUM_K, chip_smoke.py's conv_ff_sums measures the other depths against
// exact sums. No float atomics: every cross-block sum is in a fixed order,
// so two backward runs give bit-identical gradients. Launches go on the
// caller's stream, allocate nothing (scratch comes from the wrapper's
// workspace) and each waits (griddepcontrol.wait) before it reads or
// writes anything in device memory: the weights' images too, which the
// wrapper may just have made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "conv_ff_wgmma.cuh"
#include "dropout_hash.cuh"
#include "smem_limit.cuh"

namespace {

using namespace cfw;

constexpr float LN_EPS = 1e-5f;
constexpr int SMS = 132;  // an H100's streaming multiprocessors
constexpr int MAX_CLUSTER = 8;
// k16 columns a partial sum of the conv GEMMs spans (conv_stage): the
// instance's depth, chosen on the card against exact sums (PERF.md)
constexpr int SUM_K = 64;

struct Dropout {
  bool on;
  uint32_t threshold;  // keep iff bits >= threshold
  float keep;          // 1 - rate: kept values are divided by it
};

// shared memory: the conv ring, then (conv_c) the db1 warp sums
constexpr int CONV_RING = ring_bytes<CONV_STAGE, CONV_STAGES>();
constexpr int CONV_C_SMEM = CONV_RING + 8 * BN * 4;
constexpr int CONV_E_SMEM = CONV_RING;
// conv_e's epilogue: every warp of the block takes rows, at an equal
// share of the register pool (setmaxnreg), and its partial tile and
// (backward) the warps' 5 column sums of E fit over the drained ring
constexpr int EPILOGUE_WARPS = THREADS / 32, EPILOGUE_REGS = LAUNCH_REGS;
constexpr int HANDOVER = 2;  // the named barrier of that handover
static_assert(TILE_BYTES + EPILOGUE_WARPS * 5 * 512 * 4 <= CONV_STAGES * CONV_STAGE,
              "conv_e epilogue");
static_assert(CONV_C_SMEM <= 232448, "one block an SM");

__host__ __device__ inline int row_tiles(int T) { return (T + BM - 1) / BM; }
// chunks of an image a batch row: two a 128-row tile
__host__ __device__ inline int image_chunks(int T) { return 2 * row_tiles(T); }

__device__ __forceinline__ void add4(float4& dst, const float (&v)[4]) {
  float4 d = dst;
  d.x += v[0];
  d.y += v[1];
  d.z += v[2];
  d.w += v[3];
  dst = d;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Word ``within`` / 2 of slot ``idx`` of chunk ``chunk``, group ``grp`` of
// batch row b of an image of ``groups`` groups and ``nch`` chunks.
__device__ __forceinline__ uint32_t* image_at(bf16* img, int b, int nch, int groups, int chunk,
                                              int grp, int idx, int within) {
  return reinterpret_cast<uint32_t*>(
      img + ((((size_t)b * nch + chunk) * groups + grp) * CR + idx) * 8 + within);
}

// f(chunk, slot) for each place of row t in an image of nch chunks: its
// own chunk's, and at a chunk's edge the neighbour's halo.
template <class F>
__device__ __forceinline__ void row_places(int t, int nch, F f) {
  const int c = t / CH, i = t % CH;
  f(c, i + 1);
  if (i == CH - 1 && c + 1 < nch) f(c + 1, 0);
  if (i == 0 && c > 0) f(c - 1, CR - 1);
}

// The outer halos of an image (row -1 of the first chunk, the row after
// the last chunk: zero) for groups [grp0, grp0 + n) of batch row b:
// thread i < n writes group grp0 + i.
__device__ __forceinline__ void zero_edges(bf16* img, int b, int nch, int groups, int grp0, int n,
                                           bool first, bool last, int i) {
  if (i >= n) return;
  if (first)
    *reinterpret_cast<uint4*>(image_at(img, b, nch, groups, 0, grp0 + i, 0, 0)) =
        make_uint4(0, 0, 0, 0);
  if (last)
    *reinterpret_cast<uint4*>(image_at(img, b, nch, groups, nch - 1, grp0 + i, CR - 1, 0)) =
        make_uint4(0, 0, 0, 0);
}

// -------------------------------------------------------------------
// 1. rnd(x) (B, T, E) f32 -> its image (B, chunks, E/8, 66, 8), halos
//    and zero rows included. A thread a 16-byte slot; the 32 of a warp
//    take 4 slots of 8 groups: 256 contiguous bytes of x a row, 64 of the
//    image a group.
// -------------------------------------------------------------------
__global__ void __launch_bounds__(256)
cff_pack_x_kernel(const float* __restrict__ x, bf16* __restrict__ img, int B, int T, int E,
                  int nch) {
  pdl_wait();
  const int G8 = E / 64, S4 = (nch * CR + 3) / 4;
  const size_t i = (size_t)blockIdx.x * 256 + threadIdx.x;
  const int g8 = (int)(i % 8), rr = (int)(i / 8 % 4);
  const size_t rest = i / 32;
  const int grp = 8 * (int)(rest % G8) + g8, slot = 4 * (int)(rest / G8 % S4) + rr;
  const size_t b = rest / G8 / S4;
  if (b < (size_t)B && slot < nch * CR) {
    const int chunk = slot / CR, idx = slot % CR, t = CH * chunk + idx - 1;
    uint4 o = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < T) {
      const float4* src = reinterpret_cast<const float4*>(x + (b * T + t) * E + 8 * grp);
      const float4 u = __ldg(src), v = __ldg(src + 1);
      o = make_uint4(pack(u.x, u.y), pack(u.z, u.w), pack(v.x, v.y), pack(v.z, v.w));
    }
    *reinterpret_cast<uint4*>(image_at(img, (int)b, nch, E / 8, chunk, grp, idx, 0)) = o;
  }
  pdl_launch_dependents();
}

// -------------------------------------------------------------------
// 2 / 4. conv GEMMs with N = C columns, K = 3E: persistent blocks over the
//    tiles (column tile fastest, then row tile, then batch row).
// -------------------------------------------------------------------
enum { HIDDEN, DH };

struct CArgs {
  const bf16* a_img;  // (B, chunks, K/8, 66, 8): rnd(x) (HIDDEN) or rnd(da2) (DH)
  const bf16* w_img;  // (N/128, K/64, 3, 8, 128, 8)
  const float* b1;    // HIDDEN
  const bf16* h_img;  // DH: h (its ReLU mask)
  bf16* out_img;      // (B, chunks, N/8, 66, 8): h (HIDDEN) or rnd(da1) (DH)
  float* pdb1;        // DH: (B * row tiles, N)
  int T, nch, K, N, tiles;
};

template <int EPI, int KP>
__global__ void __launch_bounds__(THREADS, 1) conv_c_wgmma_kernel(const CArgs a) {
  using R = Ring<CONV_STAGE, CONV_STAGES>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const R ring{saddr(smem)};
  float* red = reinterpret_cast<float*>(smem + CONV_RING);  // [8 warps][BN]
  const int tid = threadIdx.x, kc = a.K / 64, nt = a.N / BN, rt = row_tiles(a.T);
  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      pdl_wait();
      int q = 0;
      for (int id = blockIdx.x; id < a.tiles; id += gridDim.x) {
        const int ct = id % nt, lo = (id / nt % rt) * BM, b = id / nt / rt;
        for (int c = 0; c < kc; ++c, ++q) {
          ring.begin(q, CONV_STAGE);
          const uint32_t st = ring.stage(q);
          if (lane < 2)  // chunk lo / 64 + lane: rows lo + 64 lane - 1 .. + 64
            bulk_copy(st + lane * A_SLAB,
                      image_at(const_cast<bf16*>(a.a_img), b, a.nch, a.K / 8, lo / CH + lane,
                               8 * c, 0, 0),
                      A_SLAB, ring.full(q));
          else if (lane == 2)
            bulk_load(st + A_STAGE, a.w_img + ((size_t)ct * kc + c) * (W_STAGE / 2), W_STAGE,
                      ring.full(q), EVICT_LAST);
        }
      }
    }
    return;
  }
  regs_alloc<CONSUMER_REGS>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int groups = a.N / 8;
  pdl_wait();
  int q = 0;
  for (int id = blockIdx.x; id < a.tiles; id += gridDim.x) {
    const int ct = id % nt, rti = id / nt % rt, b = id / nt / rt, lo = rti * BM, n0 = ct * BN;
    // DH: h's words of this thread's pairs, loaded while the products run
    uint32_t hw[16][2];
    if (EPI == DH) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          hw[j][h] = __ldg(image_at(const_cast<bf16*>(a.h_img), b, a.nch, groups,
                                    lo / CH + wg, n0 / 8 + j, 16 * warp + g + 8 * h + 1, 2 * t));
    }
    float acc[64], p[64];
    zero(acc);
    for (int c = 0; c < kc; ++c, ++q) {
      ring.wait(q);
      conv_stage<KP>(acc, p, ring.stage(q), wg);
      ring.release(q);
    }
    const int left = a.T - lo;  // rows of the tile below T
    float colsum[16][2];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      colsum[j][0] = colsum[j][1] = 0.f;
      float2 bias = make_float2(0.f, 0.f);
      if (EPI == HIDDEN) bias = __ldg(reinterpret_cast<const float2*>(a.b1 + n0 + 8 * j + 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * warp + g + 8 * h;
        const bool valid = r < left;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        uint32_t word;
        if (EPI == HIDDEN) {
          word = valid ? pack(fmaxf(v0 + bias.x, 0.f), fmaxf(v1 + bias.y, 0.f)) : 0u;
        } else {
          // h = rnd(relu(a1)) > 0 iff a1 > 0; rows at or past T: zero
          const float2 hv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hw[j][h]));
          const float d0 = valid && hv.x > 0.f ? v0 : 0.f, d1 = valid && hv.y > 0.f ? v1 : 0.f;
          colsum[j][0] += d0;
          colsum[j][1] += d1;
          word = pack(d0, d1);
        }
        row_places(lo + r, a.nch, [&](int chunk, int idx) {
          *image_at(a.out_img, b, a.nch, groups, chunk, n0 / 8 + j, idx, 2 * t) = word;
        });
      }
    }
    if (EPI == DH) {
      // db1 partial of the tile (unrounded da1): a warp's 8 row groups by
      // butterfly, then the 8 warps in order
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = colsum[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[(tid >> 5) * BN + 8 * j + 2 * t + e] = v;
        }
      named_sync(SYNC, CONSUMERS);
      if (tid < BN) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) s += red[w * BN + tid];
        a.pdb1[((size_t)b * rt + rti) * a.N + n0 + tid] = s;
      }
      named_sync(SYNC, CONSUMERS);  // red is free for the next tile
    }
    zero_edges(a.out_img, b, a.nch, groups, n0 / 8, BN / 8, lo == 0, lo + BM >= a.T, tid);
  }
  pdl_launch_dependents();
}

// -------------------------------------------------------------------
// 3 / 5. conv GEMMs with N = E columns, K = 3C: grid (E/128 x S, row
//    tiles, B), a cluster of the E/128 x S blocks of one 128-row tile;
//    rank r takes column tile r % (E/128) and split r / (E/128) of the
//    C / 64 channel chunks; after the cluster barrier rank r owns rows
//    [r per, (r + 1) per) of the tile whole.
// -------------------------------------------------------------------
enum { OUT_FWD, OUT_BWD, DX };

struct EArgs {
  const bf16* a_img;  // (B, chunks, C/8, 66, 8): h (OUT_*) or rnd(da1) (DX)
  const bf16* w_img;  // (E/128, C/64, 3, 8, 128, 8)
  const float *b2, *x, *ln_s, *ln_b, *film, *g;
  const int* seeds;
  float* out;      // out (OUT_FWD) or dx (DX), (B, T, E)
  float* dr;       // written (OUT_BWD), read (DX)
  bf16* da2_img;   // OUT_BWD: (B, chunks, E/8, 66, 8)
  float* pvec;     // OUT_BWD: (B * row tiles * cs, 3E) [dLN scale | dLN bias | db2]
  float* pfilm;    // OUT_BWD: (B, row tiles * cs, 2E) [g * y | g]
  int T, nch, C, S;
  Dropout drop;
};

template <int EPI, int EV, int KP>
__global__ void __launch_bounds__(THREADS, 1) conv_e_wgmma_kernel(const EArgs a) {
  constexpr int E = 128 * EV;
  using R = Ring<CONV_STAGE, CONV_STAGES>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const R ring{saddr(smem)};
  const int tid = threadIdx.x, cs = gridDim.x, rank = blockIdx.x;
  const int ct = rank % EV, split = rank / EV;
  const int rti = blockIdx.y, rt = gridDim.y, b = blockIdx.z, lo = rti * BM;
  const int nch = a.C / 64, c0 = split * nch / a.S, c1 = (split + 1) * nch / a.S;
  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    regs_dealloc<PRODUCER_REGS>();
    if (tid < CONSUMERS + 32) {
      const int lane = tid & 31;
      pdl_wait();
      for (int c = c0, q = 0; c < c1; ++c, ++q) {
        ring.begin(q, CONV_STAGE);
        const uint32_t st = ring.stage(q);
        if (lane < 2)
          bulk_copy(st + lane * A_SLAB,
                    image_at(const_cast<bf16*>(a.a_img), b, a.nch, a.C / 8, lo / CH + lane, 8 * c,
                             0, 0),
                    A_SLAB, ring.full(q));
        else if (lane == 2)
          bulk_load(st + A_STAGE, a.w_img + ((size_t)ct * nch + c) * (W_STAGE / 2), W_STAGE,
                    ring.full(q), EVICT_LAST);
      }
    }
    pdl_wait();  // the rows below read what the launch before wrote
    // the epilogue's share of the pool, once the consumers have given back
    // theirs (taken before, it could starve their own raise): all 12 warps
    // take rows
    named_sync(HANDOVER, THREADS);
    regs_alloc<EPILOGUE_REGS>();
  } else {
    regs_alloc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    pdl_wait();
    float acc[64], p[64];
    zero(acc);
    for (int q = 0; q < c1 - c0; ++q) {
      ring.wait(q);
      conv_stage<KP>(acc, p, ring.stage(q), wg);
      ring.release(q);
    }
    pdl_launch_dependents();
    named_sync(SYNC, CONSUMERS);  // both warpgroups' products have read the ring
    store_tile(reinterpret_cast<float*>(smem), acc);
    regs_dealloc<EPILOGUE_REGS>();
    named_sync(HANDOVER, THREADS);
  }
  cluster_sync();

  const int lane = tid & 31, w12 = tid >> 5;
  const uint32_t tile = saddr(smem);
  float* red = reinterpret_cast<float*>(smem + TILE_BYTES);  // OUT_BWD: [12 warps][5][E]
  if (EPI == OUT_BWD) {
    for (int i = lane; i < 5 * E; i += 32) red[w12 * 5 * E + i] = 0.f;
    __syncwarp();
  }
  const int per = (BM + cs - 1) / cs, r0 = rank * per, r1 = min(BM, r0 + per);
  const uint32_t seed = EPI != DX && a.drop.on ? (uint32_t)__ldg(a.seeds + b) : 0u;
  const float* fb = EPI != DX ? a.film + (size_t)b * 2 * E : nullptr;
  // A warp takes RB rows of this rank's share at a time, every load of
  // them issued before the first is used (the rows' latency overlaps).
  constexpr int RB = EV > 2 ? 2 : 4;
  const float inv_keep = 1.f / a.drop.keep;
  for (int o0 = r0 + w12 * RB; o0 < r1; o0 += EPILOGUE_WARPS * RB) {
    float4 sv[RB][EV], xv[RB][EV], gv[RB][EV];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      // a row past the share or past T: loaded from a valid row, unused
      const int o = min(o0 + k, r1 - 1), t = min(lo + o, a.T - 1);
      const size_t row = (size_t)b * a.T + t;
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        sv[k][jv] = gather(tile, o, jv, EV, a.S);
        if (EPI == DX) {
          xv[k][jv] = *reinterpret_cast<const float4*>(a.dr + row * E + n);
        } else {
          xv[k][jv] = __ldg(reinterpret_cast<const float4*>(a.x + row * E + n));
          if (EPI == OUT_BWD) gv[k][jv] = __ldg(reinterpret_cast<const float4*>(a.g + row * E + n));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int o = o0 + k, t = lo + o;
      if (o >= r1) break;
      if (t >= a.T) {
        if (EPI == OUT_BWD)
          row_places(t, a.nch, [&](int chunk, int idx) {
            for (int grp = lane; grp < E / 8; grp += 32)
              *reinterpret_cast<uint4*>(image_at(a.da2_img, b, a.nch, E / 8, chunk, grp, idx, 0)) =
                  make_uint4(0, 0, 0, 0);
          });
        continue;
      }
      const size_t row = (size_t)b * a.T + t;
      if (EPI == DX) {
#pragma unroll
        for (int jv = 0; jv < EV; ++jv) {
          const float4 d = xv[k][jv], v = sv[k][jv];
          *reinterpret_cast<float4*>(a.out + row * E + 128 * jv + 4 * lane) =
              make_float4(d.x + v.x, d.y + v.y, d.z + v.z, d.w + v.w);
        }
        continue;
      }
      // r = drop(a2) + x and its LayerNorm statistics
      float v[4 * EV], s = 0.f;
      uint32_t kept = 0;  // bit i: column i of this lane kept
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        const float4 bb = __ldg(reinterpret_cast<const float4*>(a.b2 + n));
        const float av[4] = {sv[k][jv].x + bb.x, sv[k][jv].y + bb.y, sv[k][jv].z + bb.z,
                             sv[k][jv].w + bb.w};
        const float xr[4] = {xv[k][jv].x, xv[k][jv].y, xv[k][jv].z, xv[k][jv].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float y = av[i];
          if (a.drop.on) {
            const bool keep =
                dropout_bits(seed, 0u, (uint32_t)t, (uint32_t)(n + i)) >= a.drop.threshold;
            kept |= (uint32_t)keep << (4 * jv + i);
            y = keep ? y * inv_keep : 0.f;
          }
          v[4 * jv + i] = y + xr[i];
          s += v[4 * jv + i];
        }
      }
      const float mean = warp_sum(s) / E;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 4 * EV; ++i) sq += (v[i] - mean) * (v[i] - mean);
      const float inv = 1.f / sqrtf(warp_sum(sq) / E + LN_EPS);
      if (EPI == OUT_FWD) {
#pragma unroll
        for (int jv = 0; jv < EV; ++jv) {
          const int n = 128 * jv + 4 * lane;
          const float4 ls = __ldg(reinterpret_cast<const float4*>(a.ln_s + n));
          const float4 lb = __ldg(reinterpret_cast<const float4*>(a.ln_b + n));
          const float4 gm = __ldg(reinterpret_cast<const float4*>(fb + n));
          const float4 bt = __ldg(reinterpret_cast<const float4*>(fb + E + n));
          const float* vv = v + 4 * jv;
          *reinterpret_cast<float4*>(a.out + row * E + n) =
              make_float4(gm.x * ((vv[0] - mean) * inv * ls.x + lb.x) + bt.x,
                          gm.y * ((vv[1] - mean) * inv * ls.y + lb.y) + bt.y,
                          gm.z * ((vv[2] - mean) * inv * ls.z + lb.z) + bt.z,
                          gm.w * ((vv[3] - mean) * inv * ls.w + lb.w) + bt.w);
        }
        continue;
      }
      // OUT_BWD: dr, rnd(da2) and the row's terms of the column sums
      // (a lane's 4 columns of each sum one float4 of red)
      float dn[4 * EV], s_dn = 0.f, s_dnn = 0.f;
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        const float4 ls4 = __ldg(reinterpret_cast<const float4*>(a.ln_s + n));
        const float4 lb4 = __ldg(reinterpret_cast<const float4*>(a.ln_b + n));
        const float4 gm4 = __ldg(reinterpret_cast<const float4*>(fb + n));
        const float ls[4] = {ls4.x, ls4.y, ls4.z, ls4.w}, lb[4] = {lb4.x, lb4.y, lb4.z, lb4.w};
        const float gm[4] = {gm4.x, gm4.y, gm4.z, gm4.w};
        const float gr[4] = {gv[k][jv].x, gv[k][jv].y, gv[k][jv].z, gv[k][jv].w};
        float gy[4], dyn[4], dyv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * jv + i;
          v[c] = (v[c] - mean) * inv;  // n
          const float y = v[c] * ls[i] + lb[i], dy = gr[i] * gm[i];
          dn[c] = dy * ls[i];
          s_dn += dn[c];
          s_dnn += dn[c] * v[c];
          gy[i] = gr[i] * y;
          dyn[i] = dy * v[c];
          dyv[i] = dy;
        }
        float4* rw = reinterpret_cast<float4*>(red + (size_t)w12 * 5 * E + n);
        add4(rw[0], gy);
        add4(rw[E / 4], gr);
        add4(rw[E / 2], dyn);
        add4(rw[3 * E / 4], dyv);
      }
      const float m_dn = warp_sum(s_dn) / E, m_dnn = warp_sum(s_dnn) / E;
#pragma unroll
      for (int jv = 0; jv < EV; ++jv) {
        const int n = 128 * jv + 4 * lane;
        float dr[4], da2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * jv + i;
          dr[i] = (dn[c] - m_dn - v[c] * m_dnn) * inv;
          da2[i] = a.drop.on ? ((kept >> c) & 1u ? dr[i] * inv_keep : 0.f) : dr[i];
        }
        add4(reinterpret_cast<float4*>(red + (size_t)w12 * 5 * E + 4 * E + n)[0], da2);
        *reinterpret_cast<float4*>(a.dr + row * E + n) = make_float4(dr[0], dr[1], dr[2], dr[3]);
        const uint2 words = make_uint2(pack(da2[0], da2[1]), pack(da2[2], da2[3]));
        row_places(t, a.nch, [&](int chunk, int idx) {
          *reinterpret_cast<uint2*>(
              image_at(a.da2_img, b, a.nch, E / 8, chunk, n / 8, idx, n % 8)) = words;
        });
      }
    }
  }
  if (EPI == OUT_BWD) {
    __syncthreads();
    for (int i = tid; i < 5 * E; i += THREADS) {
      const int k = i / E, c = i % E;
      float s = 0.f;
      for (int w = 0; w < EPILOGUE_WARPS; ++w) s += red[(w * 5 + k) * E + c];
      if (k < 2)
        a.pfilm[((size_t)b * rt * cs + rti * cs + rank) * 2 * E + k * E + c] = s;
      else
        a.pvec[(((size_t)b * rt + rti) * cs + rank) * 3 * E + (k - 2) * E + c] = s;
    }
    if (rank == 0)
      zero_edges(a.da2_img, b, a.nch, E / 8, 0, E / 8, lo == 0, lo + BM >= a.T, tid);
  }
  cluster_sync();  // the other blocks have read this block's partial tile
}

// -------------------------------------------------------------------
// 6. Weight gradients: dW1[d] (E x C) = sum over rows of rnd(x)[t + d - 1]
//    rnd(da1)[t], dW2[d] (C x E) of h[t + d - 1] rnd(da2)[t]. A block owns
//    64 rows of a factor pair's first factor and 128 columns of its second,
//    all three taps: three consumer warpgroups, one a tap, read the same
//    stage (64 rows of the second factor and those rows of the first with
//    a halo row on each side, tap d d rows down). Grid (cs, 2 (E/64)
//    (C/128)); the cs blocks of a cluster split the 64-row chunks of all
//    batch rows and add their partial tiles in rank order.
// -------------------------------------------------------------------
constexpr int WG_WARPGROUPS = 3;
constexpr int WG_CONSUMERS = 128 * WG_WARPGROUPS;
constexpr int WG_THREADS = WG_CONSUMERS + 128;
constexpr int WG_LAUNCH_REGS = 128, WG_PRODUCER_REGS = 24, WG_CONSUMER_REGS = 160;
static_assert(WG_LAUNCH_REGS * WG_THREADS == 65536, "one block an SM");
static_assert(WG_PRODUCER_REGS * 128 + WG_CONSUMER_REGS * WG_CONSUMERS <= 65536,
              "setmaxnreg within the block's register pool");
constexpr int WG_M = 64;               // channels of the first factor a block
constexpr int WG_A = A_SLAB;           // a chunk of 8 groups of the first factor: 8,448
constexpr int WG_G = 16 * CR * 16;     // and of 16 of the second: 16,896
constexpr int WG_STAGE = WG_A + WG_G;  // 25,344
constexpr int WG_STAGES = 8;
constexpr int WGRAD_SMEM = ring_bytes<WG_STAGE, WG_STAGES>();
static_assert(WG_WARPGROUPS * WG_M * TILE_LD * 4 <= WG_STAGES * WG_STAGE, "wgrad epilogue");

struct WArgs {
  const bf16* a_img[2];  // images (B, chunks, K/8, 66, 8): rnd(x), h
  const bf16* g_img[2];  // rnd(da1), rnd(da2)
  float* dw[2];          // (3, E, C), (3, C, E)
  int B, T, nch, E, C;
};

template <int KP>
__global__ void __launch_bounds__(WG_THREADS, 1) wgrad_wgmma_kernel(const WArgs a) {
  using R = Ring<WG_STAGE, WG_STAGES, WG_CONSUMERS / 32>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const R ring{saddr(smem)};
  const int tid = threadIdx.x, cs = gridDim.x, rank = blockIdx.x;
  const int tiles = (a.E / WG_M) * (a.C / BN);
  const int pair = blockIdx.y / tiles, tile = blockIdx.y % tiles;
  const int M = pair ? a.C : a.E, N = pair ? a.E : a.C;
  const int mt = tile / (N / BN), nt = tile % (N / BN);
  const int nck = (a.T + CH - 1) / CH, total = a.B * nck;
  const int k0 = (int)((long long)rank * total / cs), k1 = (int)((long long)(rank + 1) * total / cs);
  if (tid == 0) {
    ring.init();
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= WG_CONSUMERS) {
    regs_dealloc<WG_PRODUCER_REGS>();
    if (tid < WG_CONSUMERS + 32) {
      const int lane = tid & 31;
      pdl_wait();
      for (int k = k0, q = 0; k < k1; ++k, ++q) {
        const int bb = k / nck, chunk = k % nck;
        ring.begin(q, WG_STAGE);
        const uint32_t st = ring.stage(q);
        // chunk's rows 64 chunk - 1 .. + 64 of 8 groups of the first factor
        // and of 16 of the second
        if (lane == 0)
          bulk_copy(st, image_at(const_cast<bf16*>(a.a_img[pair]), bb, a.nch, M / 8, chunk, 8 * mt,
                                 0, 0),
                    WG_A, ring.full(q));
        else if (lane == 1)
          bulk_copy(st + WG_A, image_at(const_cast<bf16*>(a.g_img[pair]), bb, a.nch, N / 8, chunk,
                                        16 * nt, 0, 0),
                    WG_G, ring.full(q));
      }
    }
    cluster_sync();
    cluster_sync();
    return;
  }
  regs_alloc<WG_CONSUMER_REGS>();
  const int d = tid >> 7, lane = tid & 31, w12 = tid >> 5;
  pdl_wait();
  {
    float acc[64], p[64];
    zero(acc);
    for (int q = 0; q < k1 - k0; ++q) {
      ring.wait(q);
      const uint32_t st = ring.stage(q);
      // tap d reads the first factor's rows d - 1 ..: slot d on; the
      // second's from slot 1
      wgrad_stage<KP>(acc, p, operand(st + d * 16, 128, CR * 16),
                      operand(st + WG_A + 16, 128, CR * 16));
      ring.release(q);
    }
    pdl_launch_dependents();
    named_sync(SYNC, WG_CONSUMERS);
    store_tile(reinterpret_cast<float*>(smem), acc);  // tap d's 64 rows at row 64 d
  }
  cluster_sync();
  // the three taps' 192 rows of 128 columns, a share each rank
  const uint32_t tile_s = saddr(smem);
  const int per = (WG_WARPGROUPS * WG_M + cs - 1) / cs, r0 = rank * per;
  const int r1 = min(WG_WARPGROUPS * WG_M, r0 + per);
  for (int o = r0 + w12; o < r1; o += WG_CONSUMERS / 32) {
    float* dw = a.dw[pair] + ((size_t)(o / WG_M) * M + mt * WG_M + o % WG_M) * N + nt * BN;
    *reinterpret_cast<float4*>(dw + 4 * lane) = gather(tile_s, o, 0, 1, cs);
  }
  cluster_sync();
}

// -------------------------------------------------------------------
// 7. The backward's vector gradients, each a fixed-order sum of its
//    partials: db1 (C) over B x row tiles, [dLN scale | dLN bias | db2]
//    (3E) over B x row tiles x cs, dfilm (B, 2E) over row tiles x cs.
// -------------------------------------------------------------------
struct FArgs {
  const float *pdb1, *pvec, *pfilm;
  float *db1, *dvec, *dfilm;
  int B, E, C, parts;  // parts: row tiles x cs
  int rt;
};

// sum_{k < n} p[k stride] by one warp, in a fixed order: lane l adds
// k = l, l + 32, ... in order, then the lanes meet by butterfly. Every lane
// returns the sum.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ p, size_t stride, int n) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k0 = 0; k0 < n; k0 += 32 * 4) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = k0 + 32 * u + lane;
      v[u] = k < n ? __ldg(p + (size_t)k * stride) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) s += v[u];
  }
  return warp_sum(s);
}

// A warp an output: [db1 (C) | dvec (3E) | dfilm (B, 2E)].
__global__ void __launch_bounds__(256) cff_finish_kernel(const FArgs a) {
  pdl_wait();
  int i = (int)((blockIdx.x * 256 + threadIdx.x) >> 5);
  const bool lead = (threadIdx.x & 31) == 0;
  if (i < a.C) {
    const float s = ordered_sum(a.pdb1 + i, a.C, a.B * a.rt);
    if (lead) a.db1[i] = s;
  } else if ((i -= a.C) < 3 * a.E) {
    const float s = ordered_sum(a.pvec + i, 3 * a.E, a.B * a.parts);
    if (lead) a.dvec[i] = s;
  } else if ((i -= 3 * a.E) < a.B * 2 * a.E) {
    const int b = i / (2 * a.E), j = i % (2 * a.E);
    const float s = ordered_sum(a.pfilm + (size_t)b * a.parts * 2 * a.E + j, 2 * a.E, a.parts);
    if (lead) a.dfilm[i] = s;
  }
  pdl_launch_dependents();
}

// -------------------------------------------------------------------
// Host side
// -------------------------------------------------------------------
// The count s in [1, hi] of equal pieces n units are cut into that least
// loads the busiest SM (one block an SM): waves(n s) / s, the smallest s
// on a tie.
int least_load(long long n, int hi) {
  int best = 1;
  long long best_w = (n + SMS - 1) / SMS;
  for (int s = 2; s <= hi; ++s) {
    const long long w = (n * s + SMS - 1) / SMS;
    if (w * best < best_w * s) {
      best = s;
      best_w = w;
    }
  }
  return best;
}

struct Plan {
  int rt, nch;
  int S, cs_e;  // conv_e: splits of K, cluster (E/128 x S)
  int cs_w;     // wgrad: row splits, its cluster
  int c_blocks; // conv_c: persistent blocks
};

Plan plan(int B, int T, int E, int C) {
  Plan p;
  p.rt = row_tiles(T);
  p.nch = image_chunks(T);
  // a split keeps at least 4 of the 64-channel chunks (C / 256): below
  // that a block's fill and epilogue outweigh its products (symbol rate,
  // E = 128: 8 splits of 2 chunks 1.24x slower than 4 of 4 on an H100)
  const int ev = E / 128, hi = MAX_CLUSTER / ev < C / 256 ? MAX_CLUSTER / ev : C / 256;
  p.S = least_load((long long)ev * p.rt * B, hi > 1 ? hi : 1);
  p.cs_e = ev * p.S;
  const int chunks = B * ((T + CH - 1) / CH);
  p.cs_w = least_load(2LL * (E / WG_M) * (C / BN), chunks < MAX_CLUSTER ? chunks : MAX_CLUSTER);
  const long long tiles = (long long)(C / BN) * p.rt * B;
  p.c_blocks = (int)(tiles < SMS ? tiles : SMS);
  return p;
}

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
  bf16 *x_img, *h_img, *da2_img, *da1_img;
  float *dr, *pvec, *pfilm, *pdb1;
};

// The forward takes the x and h images; the backward all of it.
Work carve(Carve& cv, const Plan& p, int B, int T, int E, int C, bool backward) {
  const size_t rows = (size_t)B * p.nch * CR;
  Work w{};
  w.x_img = cv.take<bf16>(rows * E);
  w.h_img = cv.take<bf16>(rows * C);
  if (!backward) return w;
  w.da2_img = cv.take<bf16>(rows * E);
  w.da1_img = cv.take<bf16>(rows * C);
  w.dr = cv.take<float>((size_t)B * T * E);
  w.pvec = cv.take<float>((size_t)B * p.rt * p.cs_e * 3 * E);
  w.pfilm = cv.take<float>((size_t)B * p.rt * p.cs_e * 2 * E);
  w.pdb1 = cv.take<float>((size_t)B * p.rt * C);
  return w;
}

template <class... Params, class... Actual>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster,
                       cudaStream_t st, bool programmatic, Actual... args) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = programmatic;
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

template <class... Params, class... Actual>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, int smem, int cluster,
                   cudaStream_t st, Actual... args) {
  return launch_pdl(kernel, grid, threads, smem, cluster, st, true, args...);
}

// setmaxnreg's pool holds only at the launch's registers a thread (168, or
// the weight gradients' 128): a build that gave a kernel another count
// would wait forever for them.
template <class K>
bool launch_regs(K kernel, int regs = LAUNCH_REGS) {
  cudaFuncAttributes attr{};
  return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess && attr.numRegs == regs;
}

// One warp-specialised launch: its register count checked once, its
// shared-memory limit raised on this device once.
template <class K, class... Actual>
cudaError_t launch_ws(K kernel, smem_limit::Record& allowed, bool regs_ok, dim3 grid, int threads,
                      int smem, int cluster, cudaStream_t st, Actual... args) {
  if (!regs_ok) return cudaErrorInvalidConfiguration;
  cudaError_t err = smem_limit::allow(kernel, smem, allowed);
  if (err != cudaSuccess) return err;
  return launch(kernel, grid, threads, smem, cluster, st, args...);
}

template <int EPI, int KP>
cudaError_t conv_c(const CArgs& a, const Plan& p, cudaStream_t st) {
  static smem_limit::Record allowed;
  static const bool regs = launch_regs(conv_c_wgmma_kernel<EPI, KP>);
  return launch_ws(conv_c_wgmma_kernel<EPI, KP>, allowed, regs, dim3(p.c_blocks), THREADS,
                   CONV_C_SMEM, 1, st, a);
}

template <int EPI, int EV, int KP>
cudaError_t conv_e_at(const EArgs& a, const Plan& p, int B, cudaStream_t st) {
  static smem_limit::Record allowed;
  static const bool regs = launch_regs(conv_e_wgmma_kernel<EPI, EV, KP>);
  return launch_ws(conv_e_wgmma_kernel<EPI, EV, KP>, allowed, regs, dim3(p.cs_e, p.rt, B), THREADS,
                   CONV_E_SMEM, p.cs_e, st, a);
}

// conv_e at width E; the depths other than SUM_K are built at E = 128 and
// 512 only (chip_smoke.py's conv_ff_sums)
template <int EPI, int KP>
cudaError_t conv_e(const EArgs& a, const Plan& p, int B, int E, cudaStream_t st) {
  switch (E) {
    case 128: return conv_e_at<EPI, 1, KP>(a, p, B, st);
    case 512: return conv_e_at<EPI, 4, KP>(a, p, B, st);
    default:
      if constexpr (KP == SUM_K)
        return E == 256 ? conv_e_at<EPI, 2, KP>(a, p, B, st) : conv_e_at<EPI, 3, KP>(a, p, B, st);
      return cudaErrorInvalidValue;
  }
}

template <int KP>
cudaError_t wgrad(const WArgs& a, const Plan& p, cudaStream_t st) {
  static smem_limit::Record allowed;
  static const bool regs = launch_regs(wgrad_wgmma_kernel<KP>, WG_LAUNCH_REGS);
  return launch_ws(wgrad_wgmma_kernel<KP>, allowed, regs,
                   dim3(p.cs_w, 2 * (a.E / WG_M) * (a.C / BN)), WG_THREADS, WGRAD_SMEM, p.cs_w,
                   st, a);
}

cudaError_t pack_x(const float* x, bf16* img, int B, int T, int E, int nch, cudaStream_t st) {
  const size_t n = (size_t)B * (E / 8) * ((nch * CR + 3) / 4 * 4);
  return launch(cff_pack_x_kernel, dim3((unsigned)((n + 255) / 256)), 256, 0, 1, st, x, img, B,
                T, E, nch);
}

struct Args {
  const float* x;
  const bf16 *w1, *w2;  // images: W1 (C/128, E/64, 3, ...), W2 (E/128, C/64, 3, ...)
  const float *b1, *b2, *ln_s, *ln_b, *film;
  const int* seeds;
  int B, T, E, C;
  Dropout drop;
};

// Launches 1-3 of both directions; ``g`` null: the forward (out), else the
// backward's recompute (dr, the da2 image, pvec, pfilm).
template <int KP>
cudaError_t front(const Args& a, const Plan& p, const Work& w, const float* g, float* out,
                  cudaStream_t st) {
  cudaError_t err;
  if ((err = pack_x(a.x, w.x_img, a.B, a.T, a.E, p.nch, st)) != cudaSuccess) return err;
  const CArgs c{w.x_img, a.w1, a.b1, nullptr, w.h_img, nullptr, a.T, p.nch, a.E, a.C,
                (a.C / BN) * p.rt * a.B};
  if ((err = conv_c<HIDDEN, KP>(c, p, st)) != cudaSuccess) return err;
  const EArgs e{w.h_img, a.w2, a.b2, a.x, a.ln_s, a.ln_b, a.film, g, a.seeds, out, w.dr,
                w.da2_img, w.pvec, w.pfilm, a.T, p.nch, a.C, p.S, a.drop};
  return g ? conv_e<OUT_BWD, KP>(e, p, a.B, a.E, st) : conv_e<OUT_FWD, KP>(e, p, a.B, a.E, st);
}

template <int KP>
cudaError_t forward(const Args& a, void* ws, float* out, cudaStream_t st) {
  const Plan p = plan(a.B, a.T, a.E, a.C);
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, p, a.B, a.T, a.E, a.C, false);
  return front<KP>(a, p, w, nullptr, out, st);
}

template <int KP>
cudaError_t backward(const Args& a, const float* g, const bf16* w1r, const bf16* w2r, void* ws,
                     float* dx, float* dw1, float* db1, float* dw2, float* dvec, float* dfilm,
                     cudaStream_t st) {
  const int B = a.B, T = a.T, E = a.E, C = a.C;
  const Plan p = plan(B, T, E, C);
  Carve cv{static_cast<char*>(ws)};
  const Work w = carve(cv, p, B, T, E, C, true);
  cudaError_t err;
  if ((err = front<KP>(a, p, w, g, nullptr, st)) != cudaSuccess) return err;
  // w2r image (C/128, E/64, 3, ...): tap d = W2[2 - d]^T; w1r (E/128, C/64, ...)
  const CArgs dh{w.da2_img, w2r, nullptr, w.h_img, w.da1_img, w.pdb1, T, p.nch, E, C,
                 (C / BN) * p.rt * B};
  if ((err = conv_c<DH, KP>(dh, p, st)) != cudaSuccess) return err;
  const EArgs dxa{w.da1_img, w1r, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                  dx, w.dr, nullptr, nullptr, nullptr, T, p.nch, C, p.S, a.drop};
  if ((err = conv_e<DX, KP>(dxa, p, B, E, st)) != cudaSuccess) return err;
  const WArgs wa{{w.x_img, w.h_img}, {w.da1_img, w.da2_img}, {dw1, dw2}, B, T, p.nch, E, C};
  // the weight gradients' partials span a 64-row chunk (KP = 64 or 192)
  if ((err = wgrad<KP == 0 ? 0 : 64>(wa, p, st)) != cudaSuccess) return err;
  // a plain launch: it starts once the weight gradients have ended, where
  // a programmatic one would wait on the card through their epilogue
  const FArgs f{w.pdb1, w.pvec, w.pfilm, db1, dvec, dfilm, B, E, C, p.rt * p.cs_e, p.rt};
  const int n = C + 3 * E + B * 2 * E;  // outputs, a warp each
  return launch_pdl(cff_finish_kernel, dim3((n + 7) / 8), 256, 0, 1, st, false, f);
}

bool takes(int B, int T, int E, int C) {
  return B > 0 && T > 0 && E % 128 == 0 && E >= 128 && E <= 512 && C > 0 && C % 128 == 0;
}

}  // namespace

// Bytes of device scratch the forward (backward = 0) or the backward needs.
extern "C" long long conv_ff_blocked_tc_workspace_bytes(int B, int T, int E, int C,
                                                        int backward) {
  if (!takes(B, T, E, C)) return -1;
  Carve cv{nullptr};
  carve(cv, plan(B, T, E, C), B, T, E, C, backward != 0);
  return (long long)cv.used;
}

// The largest dynamic shared memory of the instance's launches (at every
// width E): what the wrapper's plan mirrors.
extern "C" long long conv_ff_blocked_tc_smem_bytes(int E) {
  (void)E;
  const int m = CONV_C_SMEM > CONV_E_SMEM ? CONV_C_SMEM : CONV_E_SMEM;
  return m > WGRAD_SMEM ? m : WGRAD_SMEM;
}

// The launch plan of a call, into out[9]: row tiles, padded rows, conv_e's
// splits of K and cluster, wgrad's cluster, conv_c's blocks, and the
// dynamic shared memory of conv_c, conv_e and wgrad. -1 outside the
// envelope.
extern "C" int conv_ff_blocked_tc_plan(int B, int T, int E, int C, int* out) {
  if (!takes(B, T, E, C)) return -1;
  const Plan p = plan(B, T, E, C);
  const int v[9] = {p.rt, p.nch * CR, p.S, p.cs_e, p.cs_w, p.c_blocks, CONV_C_SMEM, CONV_E_SMEM,
                    WGRAD_SMEM};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// x, out: (B, T, E) f32; w1: W1's image (C/128, E/64, 3, 8, 128, 8), w2:
// W2's (E/128, C/64, 3, 8, 128, 8) bf16; b1 (C,), b2, ln_s, ln_b (E,) f32;
// film (B, 2E); seeds (B,) int32; ws: conv_ff_blocked_tc_workspace_bytes(B,
// T, E, C, 0) bytes; sum_k: SUM_K (the instance's), or the other depths
// (64, 192, 0: chained) at E = 128 and 512. Every pointer 16-byte aligned.
extern "C" int conv_ff_blocked_tc_forward(const float* x, const void* w1, const float* b1,
                                          const void* w2, const float* b2, const float* ln_s,
                                          const float* ln_b, const float* film,
                                          const int* seeds, void* ws, float* out, int B, int T,
                                          int E, int C, int use_dropout, unsigned int threshold,
                                          float keep, int sum_k, void* stream_handle) {
  if (!takes(B, T, E, C)) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b1, b2, ln_s,
               ln_b, film, seeds, B, T, E, C, Dropout{use_dropout != 0, threshold, keep}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  switch (sum_k) {
    case 64: return forward<64>(a, ws, out, st);
    case 192: return forward<192>(a, ws, out, st);
    case 0: return forward<0>(a, ws, out, st);
    default: return cudaErrorInvalidValue;
  }
}

// g: (B, T, E) f32 cotangent; w1r (E/128, C/64, 3, ...), w2r (C/128,
// E/64, 3, ...) the images of the tap-reversed transposes; ws:
// conv_ff_blocked_tc_workspace_bytes(B, T, E, C, 1) bytes. Outputs (f32):
// dx (B, T, E); dw1 (3, E, C); db1 (C,); dw2 (3, C, E); dvec (3E,) =
// [dLN scale | dLN bias | db2]; dfilm (B, 2E).
extern "C" int conv_ff_blocked_tc_backward(
    const float* x, const void* w1, const float* b1, const void* w2, const float* b2,
    const float* ln_s, const float* ln_b, const float* film, const int* seeds, const float* g,
    const void* w1r, const void* w2r, void* ws, float* dx, float* dw1, float* db1, float* dw2,
    float* dvec, float* dfilm, int B, int T, int E, int C, int use_dropout,
    unsigned int threshold, float keep, int sum_k, void* stream_handle) {
  if (!takes(B, T, E, C)) return cudaErrorInvalidValue;
  const Args a{x, static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b1, b2, ln_s,
               ln_b, film, seeds, B, T, E, C, Dropout{use_dropout != 0, threshold, keep}};
  const bf16 *r1 = static_cast<const bf16*>(w1r), *r2 = static_cast<const bf16*>(w2r);
  const cudaStream_t st = static_cast<cudaStream_t>(stream_handle);
  switch (sum_k) {
    case 64: return backward<64>(a, g, r1, r2, ws, dx, dw1, db1, dw2, dvec, dfilm, st);
    case 192: return backward<192>(a, g, r1, r2, ws, dx, dw1, db1, dw2, dvec, dfilm, st);
    case 0: return backward<0>(a, g, r1, r2, ws, dx, dw1, db1, dw2, dvec, dfilm, st);
    default: return cudaErrorInvalidValue;
  }
}
