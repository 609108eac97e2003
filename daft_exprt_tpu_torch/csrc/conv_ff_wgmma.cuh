// wgmma GEMM cores of the training conv feed-forward's tensor-core
// instance (K3 and the C-blocked K4, conv_ff_blocked_tc.cu), for Hopper,
// sm_90a.
//
// Every product is a wgmma m64n128k16 (bf16 -> f32) with both operands in
// shared memory in the no-swizzle layout: 8 x 8 core matrices of 128
// contiguous bytes, the next core matrix along K ``lbo`` bytes further and
// along M or N ``sbo`` bytes further. The activations live in device
// memory as "images" of that layout in chunks of 64 rows with their halo,
// [B][chunks][K / 8][66][8] bf16: chunk c holds rows 64 c - 1 .. 64 c + 64
// (a row at a chunk's edge twice, rows outside [0, T) zero; every writer
// writes both places and the zeros; 8 channels of a row are 16 bytes), so
// that:
//   - a conv's operand (a 64-row half of the tile with its halo, 64
//     channels) is one contiguous run, one bulk copy; it is a K-major
//     operand, and tap d of the k = 3 SAME conv reads it d rows down: its
//     descriptor's start moves by 16 bytes a row;
//   - a weight gradient's operands (64 rows of 64 and of 128 channels) are
//     two runs; read down the rows they are MN-major operands (the rows
//     are K), which wgmma takes transposed.
// The zero rows are the SAME padding at each batch row's ends. A bulk copy
// costs the TMA unit about the same whatever its size (24 copies of ~1 KB
// a stage held the weight gradients at the copies' rate on an H100), hence
// the chunks. Weights arrive as images of the K-major B operand
// ([N / 128][K / 64][3][8][128][8] bf16, ops/conv_ff_train.py tc_weights):
// one bulk copy (with an L2 evict-last hint) a stage.
//
// A conv block is two consumer warpgroups, each owning 64 rows of a 128 x
// 128 output tile, and a producer warpgroup whose first warp keeps the
// bulk copies of an mbarrier ring in flight (its lanes issue a stage's
// copies together); it gives its registers to the consumers with
// setmaxnreg.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace cfw {

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
constexpr int SYNC = 1;  // the consumers' named barrier

constexpr int BM = 128, BN = 128;  // output tile
constexpr int CH = 64, CR = CH + 2;  // rows of an image chunk, rows it stores
// conv GEMMs: a stage is 64 input channels of the tile's two chunks, and
// the three taps' k64 x 128 weight blocks
constexpr int A_SLAB = 8 * CR * 16;            // a chunk's 8 channel groups: 8,448 bytes
constexpr int A_STAGE = 2 * A_SLAB;            // 16,896
constexpr int W_TAP = 64 * BN * 2;             // 16,384
constexpr int W_STAGE = 3 * W_TAP;             // 49,152
constexpr int CONV_STAGE = A_STAGE + W_STAGE;  // 66,048
constexpr int CONV_STAGES = 3;
// a block's f32 partial tile, read by its cluster (rows padded: 136 words
// keep a warp's float2 stores on distinct banks)
constexpr int TILE_LD = BN + 8;
constexpr int TILE_BYTES = BM * TILE_LD * 4;  // 69,632

// A no-swizzle operand at ``addr``, K-major or MN-major alike: core
// matrices ``lbo`` bytes apart along K and ``sbo`` along M or N.
__device__ __forceinline__ uint64_t operand(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return desc(addr, lbo, sbo, 0);
}

// d (64 x 128, f32) (+)= a b over k16; TRANS: both operands MN-major.
// scale_d = 0 replaces d.
template <int TRANS>
__device__ __forceinline__ void mma128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (TRANS) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
}

// ``bytes`` (a multiple of 16) of contiguous device memory into shared
// memory by the TMA unit, completing on ``bar``.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ------------------------------------------------------------------
// A ring of S stages of SB bytes: load q sits in stage q % S; its "full"
// barrier completes the (q / S)-th time when its bytes have landed, its
// "empty" barrier when the WARPS consumer warps have released it.
// ------------------------------------------------------------------
template <int SB, int S, int WARPS = CONSUMERS / 32>
struct Ring {
  uint32_t data;  // stage 0; the barriers follow the stages
  __device__ uint32_t stage(int q) const { return data + (q % S) * SB; }
  __device__ uint32_t full(int q) const { return data + S * SB + 8 * (q % S); }
  __device__ uint32_t empty(int q) const { return data + S * SB + 8 * (S + q % S); }
  __device__ void init() const {
    for (int i = 0; i < S; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), WARPS);
    }
  }
  // The producer warp, before its lanes issue load q's copies: lane 0 waits
  // until the stage's previous load has been released, then expects
  // ``bytes`` on its full barrier.
  __device__ void begin(int q, uint32_t bytes) const {
    if ((threadIdx.x & 31) == 0) {
      if (q >= S) mbar_wait(empty(q), ((q / S) - 1) & 1);
      mbar_expect_tx(full(q), bytes);
    }
    __syncwarp();
  }
  __device__ void wait(int q) const { mbar_wait(full(q), (q / S) & 1); }
  __device__ void release(int q) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(q));
  }
};
template <int SB, int S>
__host__ __device__ constexpr int ring_bytes() {
  return S * SB + 16 * S;
}

// The sums of a tile, by KP, the k16 columns a partial sum spans: the
// products of a partial go into a fresh accumulator ``p`` that is then
// added into the f32 sums ``acc`` (KP = 64: a tap's k64 of a conv stage or
// a weight-gradient stage's 64 rows; KP = 192: a conv stage's three taps),
// or with KP = 0 straight into ``acc``, chained inside the tensor cores.
// Every product of a stage has completed on return: none is in flight
// across a branch or a loop's back edge.
//
// One conv stage: warpgroup wg's 64 rows are chunk wg of the stage, and
// tap d of its row r reads the chunk's slot r + d (the descriptor 16 bytes
// a row further).
template <int KP>
__device__ __forceinline__ void conv_stage(float (&acc)[64], float (&p)[64], uint32_t st,
                                           int wg) {
  const uint64_t a = operand(st + wg * A_SLAB, CR * 16, 128);
  const uint64_t b = operand(st + A_STAGE, BN * 16, 128);
  constexpr uint32_t A_K16 = 2 * CR * 16, B_K16 = 2 * BN * 16;
  if constexpr (KP == 64) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma128<0>(p, a + ((d * 16 + kk * A_K16) >> 4), b + ((d * W_TAP + kk * B_K16) >> 4), kk);
      wg_commit();
      wg_wait<0>();
      hold(p);
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += p[e];
    }
  } else {
    float(&dst)[64] = KP == 0 ? acc : p;
    wg_fence();
#pragma unroll
    for (int d = 0; d < 3; ++d)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma128<0>(dst, a + ((d * 16 + kk * A_K16) >> 4), b + ((d * W_TAP + kk * B_K16) >> 4),
                  KP == 0 || d > 0 || kk > 0);
    wg_commit();
    wg_wait<0>();
    hold(dst);
    if constexpr (KP == 192) {
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] += p[e];
    }
  }
}

// One weight-gradient stage: 64 rows as K, both operands MN-major (core
// matrices 128 bytes apart along the rows), ``a`` and ``b`` at the
// stage's first row; KP = 64 (or 192): a fresh partial, 0: chained.
template <int KP>
__device__ __forceinline__ void wgrad_stage(float (&acc)[64], float (&p)[64], uint64_t a,
                                            uint64_t b) {
  float(&dst)[64] = KP == 0 ? acc : p;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma128<1>(dst, a + kk * 16, b + kk * 16, KP == 0 || kk > 0);
  wg_commit();
  wg_wait<0>();
  hold(dst);
  if constexpr (KP != 0) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += p[e];
  }
}

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
}

// This thread's accumulator pairs into the block's f32 tile (rows
// 64 wg + 16 warp + g (+ 8), columns 8 j + 2 t (+ 1)).
__device__ __forceinline__ void store_tile(float* tile, const float (&acc)[64]) {
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = 64 * wg + 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(tile + (r0 + 8 * h) * TILE_LD + 8 * j + c0) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// A float4 of the shared memory of the cluster's block ``rank`` at this
// block's address ``addr``. No memory clobber: loads issued together stay
// in flight together (the cluster barrier before them orders them after
// the other blocks' stores).
__device__ __forceinline__ float4 remote4(uint32_t addr, int rank) {
  uint32_t at;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(at) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(at));
  return v;
}

// The sum over splits s = 0 .. S - 1 (S <= 8), in order, of columns
// 4 lane .. + 3 of row ``row`` of the partial tiles of cluster ranks
// col + ncol s; every load issued before the first add.
__device__ __forceinline__ float4 gather(uint32_t tile, int row, int col, int ncol, int S) {
  const uint32_t at = tile + (row * TILE_LD + 4 * (threadIdx.x & 31)) * 4;
  float4 part[8];
#pragma unroll
  for (int s = 0; s < 8; ++s)
    if (s < S) part[s] = remote4(at, col + ncol * s);
  float4 v = part[0];
#pragma unroll
  for (int s = 1; s < 8; ++s)
    if (s < S) {
      v.x += part[s].x;
      v.y += part[s].y;
      v.z += part[s].z;
      v.w += part[s].w;
    }
  return v;
}

}  // namespace cfw
}  // namespace
